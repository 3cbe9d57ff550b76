"""Time the image kernels on the card: K1, K2 and each app's K3 segment at
the main path's shapes, by the card's device time.

    PYTHONPATH=src python -m repro_torch.launch.image_kernel_profile \\
        [--iters 200]

One frame each: CONVOLUTION's K1 site (1 x 1095 x 1943, 8x8 taps, shift
11), STEREO's K2 site (1 x 407 x 790, 64 disparities, 8x8 blocks), and the
K3 segments of FLOW, DESCRIPTOR and PYRAMID at 1920x1080, with inputs made
from seed 0.  Each kernel is first held against its plain version
(integers exactly, floats to 0 ULP), then timed: ``ms`` is the device time
of one call (``kernels/timing.device_ms``: the profiler's kernel events).
Each K3 line carries the segment's registers and spills from ptxas, its
shared bytes, the blocks per SM its ``__launch_bounds__`` names (where the
revision has them) and its barriers.  K1's line carries, for each kernel
in its library, the registers and spills and what its SASS
(``cuobjdump -sass``) holds: instructions, global loads, register moves
into uniform registers (``R2UR``), IMADs and the IMADs that read a uniform
register.

The script uses only the package's kernel wrappers, its lowering and
``kernels/timing.py``, so the same file times an earlier revision of the
package put first on ``PYTHONPATH``: two revisions compare within one run
on one card.  Prints one JSON line per kernel, then the card's name and
power limit.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
from collections import Counter
from pathlib import Path

import numpy as np
import torch

from repro_torch import CompileOptions, compile_pipeline
from repro_torch.apps import PIPELINES
from repro_torch.apps.convolution import SHIFT, default_kernel
from repro_torch.kernels import _build
from repro_torch.kernels.conv2d.ops import conv2d_stencil
from repro_torch.kernels.conv2d.ref import conv2d_ref
from repro_torch.kernels.megakernel.check import check_leaves
from repro_torch.kernels.megakernel.ops import megakernel_segment
from repro_torch.kernels.megakernel.ref import megakernel_ref
from repro_torch.kernels.sad.ops import sad_disparity
from repro_torch.kernels.sad.ref import sad_ref
from repro_torch.kernels.timing import device_ms


def time_segment(label: str, mk, seg, iters: int, exact: bool) -> dict:
    """Check segment ``mk`` against its plain version, then time it."""
    got = megakernel_segment(mk, *seg)
    torch.cuda.synchronize()
    check = check_leaves(label, got, megakernel_ref(mk, *seg), exact=exact)
    built = _build.build_generated({label: mk.source})[label]
    usage = list(_build.ptxas_usage(built.log).values())
    use = usage[0] if len(usage) == 1 else {}
    return {"kernel": "megakernel", "segment": label,
            "tile": list(mk.tile), "smem_bytes": mk.smem_bytes,
            "registers": use.get("registers"),
            "spill_stores": use.get("spill_stores"),
            "spill_loads": use.get("spill_loads"),
            "min_blocks": getattr(mk, "min_blocks", None),
            "barriers": mk.source.count("__syncthreads()"),
            "max_ulp": check["max_ulp"],
            "ms": device_ms(lambda: megakernel_segment(mk, *seg), iters)}


_SASS_INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                        r"([A-Z][A-Z0-9_.]*)([^;]*);")


def sass_profile(name: str) -> dict:
    """Per kernel of built library ``name`` (mangled name -> counts): its
    ptxas registers and spills, and its SASS instructions by kind."""
    built = _build.build_all([name])[name]
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(built.path)],
                          capture_output=True, text=True,
                          check=True).stdout
    out, ops = {}, None
    for line in text.splitlines():
        if "Function : " in line:
            fn = line.split("Function : ")[1].strip()
            ops = out.setdefault(fn, {"ops": Counter(), "imad_uniform": 0})
            continue
        m = _SASS_INSN.search(line) if ops is not None else None
        if m:
            ops["ops"][m.group(1)] += 1
            if m.group(1) == "IMAD" and re.search(r"\bUR\d", m.group(2)):
                ops["imad_uniform"] += 1
    usage = _build.ptxas_usage(built.log)
    return {fn: {**usage.get(fn, {}),
                 "instructions": sum(c["ops"].values()),
                 "global_loads": sum(n for op, n in c["ops"].items()
                                     if op.startswith("LDG")),
                 "uniform_moves": c["ops"]["R2UR"],
                 "imad": c["ops"]["IMAD"],
                 "imad_uniform": c["imad_uniform"]}
            for fn, c in out.items()}


def app_batch(app: str, rng) -> dict:
    x = rng.randint(0, 256, (1, 1080, 1920)).astype(np.int64)
    if app == "flow":
        return {"flow.in": (x, np.roll(x, 1, axis=-1))}
    return {f"{app}.in": x}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=200)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("image_kernel_profile: needs a CUDA card")
    dev = torch.device("cuda")
    rng = np.random.RandomState(0)

    def emit(line: dict) -> None:
        print(json.dumps(line), flush=True)

    # K1 at CONVOLUTION 1080p's site, K2 at STEREO's
    p = torch.from_numpy(rng.randint(0, 256, (1, 1095, 1943)).astype(
        np.int32)).to(dev)
    k = torch.from_numpy(default_kernel().astype(np.int32)).to(dev)
    assert torch.equal(conv2d_stencil(p, k, SHIFT), conv2d_ref(p, k, SHIFT))
    emit({"kernel": "conv2d",
          "ms": device_ms(lambda: conv2d_stencil(p, k, SHIFT), args.iters),
          "functions": sass_profile("conv2d")})
    nd, bh, bw = 64, 8, 8
    lp = torch.from_numpy(rng.randint(0, 256, (1, 407, 790)).astype(
        np.int32)).to(dev)
    rp = torch.roll(lp, 5, dims=2).contiguous()
    assert torch.equal(sad_disparity(lp, rp, nd=nd, bh=bh, bw=bw),
                       sad_ref(lp, rp, nd=nd, bh=bh, bw=bw))
    emit({"kernel": "sad",
          "ms": device_ms(lambda: sad_disparity(lp, rp, nd=nd, bh=bh,
                                                bw=bw), args.iters)})

    # K3: each app's segment
    for app in ("flow", "descriptor", "pyramid"):
        design = compile_pipeline(PIPELINES[app](), options=CompileOptions(
            backend="kernels"))
        lp_ = design.lower()
        (mk,) = lp_.megakernels
        seg = lp_.segment_inputs(mk, app_batch(app, rng))
        emit(time_segment(app, mk, seg, args.iters, exact=True))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
