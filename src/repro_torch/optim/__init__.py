"""Optimizers of the port: AdamW and Adafactor, the counterparts of
``repro.optim``, as functions over parameter trees."""
from .adamw import (AdamWState, adamw_init, adamw_update,  # noqa: F401
                    adamw_update_)
from .adafactor import (AdafactorState, adafactor_init,  # noqa: F401
                        adafactor_update)
