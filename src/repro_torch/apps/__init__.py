"""The paper's CONVOLUTION and STEREO pipelines (§7), written in HWImg —
the two apps of the port's first slice.  FLOW, DESCRIPTOR and PYRAMID
come with the megakernel slice."""
from __future__ import annotations

from typing import Any, Dict

import numpy as np

from . import convolution as _conv, stereo as _stereo
from .convolution import Convolution, golden_convolution  # noqa: F401
from .stereo import Stereo, golden_stereo  # noqa: F401

PIPELINES = {
    "convolution": Convolution,
    "stereo": Stereo,
}

# uniform (UserFunction, inputs_fn) small cases for cross-backend tests
BENCH_CASES = {
    "convolution": _conv.bench_case,
    "stereo": _stereo.bench_case,
}

# the reference app parameters each pipeline takes across
_PARAMS = {
    "convolution": ("w", "h", "kernel"),
    "stereo": ("w", "h", "nd"),
}


def from_reference(name: str, params: Dict[str, Any]):
    """Build the port's UserFunction from the reference app's parameters,
    given as plain ints and numpy arrays (e.g. ``{"w", "h", "kernel"}`` for
    CONVOLUTION, ``{"w", "h", "nd"}`` for STEREO); a missing key keeps the
    app's default."""
    if name not in PIPELINES:
        raise ValueError(f"unknown app {name!r} (want one of "
                         f"{sorted(PIPELINES)})")
    unknown = set(params) - set(_PARAMS[name])
    if unknown:
        raise ValueError(f"{name}: unknown parameter(s) {sorted(unknown)} "
                         f"(want some of {_PARAMS[name]})")
    kw = {k: (np.asarray(v, dtype=np.int64) if k == "kernel" else int(v))
          for k, v in params.items()}
    return PIPELINES[name](**kw)
