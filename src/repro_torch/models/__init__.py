"""Model substrate of the port: the dense attention family's decoder
blocks, periodic stacks, and the prefill and decode forwards, with K4
(kernels/flash) as the attention on the card."""
from .config import ModelConfig  # noqa: F401
from .model import build_forward, init_params, param_specs  # noqa: F401
