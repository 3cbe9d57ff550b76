"""The port's deterministic synthetic token pipeline (``repro.data``)."""
from .pipeline import DataConfig, make_dataset  # noqa: F401
