"""The paper's four evaluation pipelines (§7) plus PYRAMID, written in
HWImg: CONVOLUTION and STEREO (the conv2d and sad kernels), and FLOW,
DESCRIPTOR and PYRAMID (the megakernel emitter)."""
from __future__ import annotations

from typing import Any, Dict

import numpy as np

from . import convolution as _conv, descriptor as _desc, flow as _flow
from . import pyramid as _pyr, stereo as _stereo
from .convolution import (Convolution, golden_convolution,  # noqa: F401
                          separable_kernel)
from .descriptor import Descriptor, golden_descriptor  # noqa: F401
from .flow import Flow, golden_flow  # noqa: F401
from .pyramid import Pyramid, golden_pyramid  # noqa: F401
from .stereo import Stereo, golden_stereo  # noqa: F401

PIPELINES = {
    "convolution": Convolution,
    "stereo": Stereo,
    "flow": Flow,
    "descriptor": Descriptor,
    "pyramid": Pyramid,
}

# uniform (UserFunction, inputs_fn) small cases for cross-backend tests
BENCH_CASES = {
    "convolution": _conv.bench_case,
    "stereo": _stereo.bench_case,
    "flow": _flow.bench_case,
    "descriptor": _desc.bench_case,
    "pyramid": _pyr.bench_case,
}

# uniform (UserFunction, target T, hand FIFO annotations) small cases for
# the cycle simulator and FIFO allocator (hwsim/); the first four are the
# paper's evaluation apps (§7)
SIM_CASES = {
    "convolution": _conv.sim_case,
    "stereo": _stereo.sim_case,
    "flow": _flow.sim_case,
    "descriptor": _desc.sim_case,
    "pyramid": _pyr.sim_case,
}

# per-app design-space axes for the Pareto explorer (repro_torch.explore):
# throughput-target ladder, schedule solvers, and FIFO-depth variant knobs
EXPLORE_SPACES = {
    "convolution": _conv.EXPLORE,
    "stereo": _stereo.EXPLORE,
    "flow": _flow.EXPLORE,
    "descriptor": _desc.EXPLORE,
    "pyramid": _pyr.EXPLORE,
}

# the registry kernel each app's main path launches on the kernels backend
KERNEL_OF = {
    "convolution": "conv2d",
    "stereo": "sad",
    "flow": "megakernel",
    "descriptor": "megakernel",
    "pyramid": "megakernel",
}

# the reference app parameters each pipeline takes across
_PARAMS = {
    "convolution": ("w", "h", "kernel"),
    "stereo": ("w", "h", "nd"),
    "flow": ("w", "h"),
    "descriptor": ("w", "h", "n_features", "filter_burst"),
    "pyramid": ("w", "h", "levels"),
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
