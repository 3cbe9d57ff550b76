from .ops import megakernel_segment  # noqa: F401
