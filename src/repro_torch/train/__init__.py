"""Step builders of the port: the train step (forward, backward, AdamW)
and the serving steps (``repro.train``)."""
from .steps import (StepOptions, build_serve_steps,  # noqa: F401
                    build_train_step, value_and_grad)
