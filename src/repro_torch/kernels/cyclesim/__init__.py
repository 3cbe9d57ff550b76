from .ops import cycle_sim  # noqa: F401
from .ref import cycle_sim_ref  # noqa: F401
