"""Model substrate of the port: the decoder blocks of every family
(attention, MLA, Mamba2; MLP or MoE), periodic stacks, and the prefill and
decode forwards, with K4 (kernels/flash) as the attention on the card."""
from .config import ModelConfig  # noqa: F401
from .model import build_forward, init_params, param_specs  # noqa: F401
