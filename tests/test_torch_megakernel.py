"""The port's megakernel emitter (K3, ``repro_torch/core/lowering/
megakernel.py``) against the reference's (``repro/core/lowering/
megakernel.py``), on the CPU.

- (a) The row demand of every node of the FLOW, DESCRIPTOR and PYRAMID
  segments at 1920x1080 (window size and offset at several tile starts)
  equals the reference's ``_demand_pass`` at block 8.
- (b) The emitter's 2-D plan, evaluated tile by tile in torch (the model
  of K3's tiling below) and as its generated CUDA source compiled with g++
  and run with one thread per block, equals the numpy executor at tiles
  3x5 and 8x32 on frames neither divides, for the three apps and a
  synthetic pipeline over every streamable op.  The columns have no
  reference counterpart; this is their CPU check.
- (c) At 1920x1080 the emitter writes a kernel for each app within the
  H100's shared memory and reports the reference's counts, and its least
  work (the roofline bound's count) is a sliding sum per box-sum chain.

The reference's lowering needs ``jax.experimental.enable_x64``, which this
jax no longer has, so its demands and stats come from one subprocess that
aliases it there only (as in test_torch_pipeline.py).
"""
import ctypes
import dataclasses
import functools
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import textwrap
from typing import Any, Dict, Tuple

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as jax_core  # noqa: E402
from repro.apps import PIPELINES as JAX_PIPELINES  # noqa: E402
from repro.core.executor import evaluate  # noqa: E402
import repro_torch.core as port_core  # noqa: E402
from repro_torch import CompileOptions, compile_pipeline  # noqa: E402
from repro_torch.apps import PIPELINES  # noqa: E402
from repro_torch.core.dtypes import Float  # noqa: E402
from repro_torch.core.hwimg import (  # noqa: E402
    map_reshape_plans, scalar_of, type_shape)
from repro_torch.core.lowering import engine as port_engine  # noqa: E402
from repro_torch.core.lowering.lowerers import (  # noqa: E402
    LOWERERS, torch_mask, torch_point_fn)
from repro_torch.core.lowering.megakernel import (  # noqa: E402
    WHOLE, _map_streams_input, _winsum_geometry, emit_megakernel)
from repro_torch.kernels import _build, registry  # noqa: E402
from repro_torch.kernels.megakernel.check import (  # noqa: E402
    all_ops_pipeline, check_leaves, point_fn_probes)
from repro_torch.kernels.megakernel.ops import megakernel_segment  # noqa: E402
from repro_torch.kernels.megakernel.ref import megakernel_ref  # noqa: E402
from repro_torch.kernels.stream import MK_SMEM_LIMIT  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MK_APPS = ("flow", "descriptor", "pyramid")
TILE_STARTS = [0, 8, 16, 536, 1072]
# (n_nodes, n_winsum, float_nodes) of each app's segment in the
# reference's plans at 1920x1080
COUNTS = {"flow": (45, 5, 17), "descriptor": (35, 3, 20),
          "pyramid": (3, 0, 0)}
# odd frames that neither 3x5 nor 8x32 tiles divide (PYRAMID's strides must
# divide its frame)
ODD = {"flow": (37, 13), "descriptor": (45, 19), "pyramid": (36, 20),
       "allops": (37, 13)}
FRAMES = 2

_REF_SCRIPT = textwrap.dedent("""
    import json, sys
    import jax, jax.experimental
    jax.experimental.enable_x64 = jax.enable_x64   # this process only
    from repro.apps import PIPELINES
    from repro.core.lowering import lower_pipeline
    from repro.core.lowering.megakernel import WHOLE, _demand_pass
    starts = json.loads(sys.argv[2])
    out = {}
    for app in ("flow", "descriptor", "pyramid"):
        lp = lower_pipeline(PIPELINES[app]().build()[1], backend="pallas")
        segs = []
        for t in lp._plan:
            if not hasattr(t, "mk"):
                continue
            dem = _demand_pass(t.nodes, {n.uid for n in t.nodes},
                               t.out_uids, 8)
            segs.append({
                "ops": [n.op for n in t.nodes],
                "rows": [None if dem[n.uid] is WHOLE else
                         [dem[n.uid].size, [dem[n.uid].off(r) for r in starts]]
                         for n in t.nodes],
                "mk": {k: getattr(t.mk, k) for k in (
                    "n_nodes", "n_winsum", "float_nodes", "flops",
                    "io_bytes", "linebuf_bytes", "whole_bytes")}})
        out[app] = {"segments": segs, "stats": lp.megakernel_stats()}
    json.dump(out, open(sys.argv[1], "w"))
""")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's megakernel plans at 1920x1080, from a subprocess."""
    d = tmp_path_factory.mktemp("jax_mk")
    (d / "ref.py").write_text(_REF_SCRIPT)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, str(d / "ref.py"),
                           str(d / "out.json"), json.dumps(TILE_STARTS)],
                          env=env, cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads((d / "out.json").read_text())


@functools.lru_cache(maxsize=None)
def _full_hd(app):
    """The port's kernels-backend lowering of ``app`` at 1920x1080."""
    design = compile_pipeline(PIPELINES[app](), options=CompileOptions(
        backend="kernels", device="cpu"))
    return design.lower()


def _mk_task(lp):
    (task,) = [t for t in lp._plan if hasattr(t, "mk")]
    return task


# --------------------------------------------------------------------------
# (a) row demands and (c) the 1080p report card, against the reference

@pytest.mark.parametrize("app", MK_APPS)
def test_row_demands_match_reference(app, reference):
    task = _mk_task(_full_hd(app))
    (ref,) = reference[app]["segments"]
    assert [n.op for n in task.nodes] == ref["ops"]
    for n, want in zip(task.nodes, ref["rows"]):
        got = task.mk.rows[n.uid]
        if want is None:
            assert got is WHOLE, n
        else:
            assert [got.size, [got.off(r) for r in TILE_STARTS]] == want, n


@pytest.mark.parametrize("app", MK_APPS)
def test_full_hd_segments_fit_and_report_reference_counts(app, reference):
    lp = _full_hd(app)
    (mk,) = lp.megakernels
    assert (f"__global__ void __launch_bounds__({mk.threads}, "
            f"{mk.min_blocks})") in mk.source
    assert f"{mk.kernel_name}(" in mk.source and "mk_launch" in mk.source
    assert mk.tile == (8, 32) and 0 < mk.smem_bytes <= MK_SMEM_LIMIT
    assert (mk.n_nodes, mk.n_winsum, mk.float_nodes) == COUNTS[app]
    ref = reference[app]["segments"][0]["mk"]
    assert {k: getattr(mk, k) for k in ref} == ref
    assert lp.megakernel_stats() == reference[app]["stats"]


class _Box(port_core.UserFunction):
    """One 4x4 box sum: a box-sum chain and nothing else."""

    def __init__(self, c=port_core):
        super().__init__("box", c.Array2d(c.UInt(8), 40, 20))
        self.c = c

    def define(self, x):
        return self.c.Reduce(self.c.Add)(self.c.Stencil(-3, 0, -3, 0)(x))


# (integer ops, f32 ops) per frame of each app's segment at 1920x1080:
# FLOW per pixel 18 + 16 for the two 3x3 Sobel products and sums, 6 integer
# Maps, five 8x8 sliding sums of 2*1087/1080 + 2 each; 16 float Maps
LEAST_OPS = {"flow": (124_550_400, 33_177_600),
             "descriptor": (101_640_960, 35_251_200),
             "pyramid": (2_073_600, 0)}


@pytest.mark.parametrize("case", sorted(LEAST_OPS) + ["box"])
def test_least_ops_count_box_sums_as_sliding_sums(case):
    if case == "box":
        (mk,) = compile_pipeline(_Box(), options=CompileOptions(
            device="cpu")).lower().megakernels
        assert mk.n_winsum == 1 and mk.flops == 16 * 20 * 40
        assert mk.least_ops() == (2 * (20 + 3) * 40 + 2 * 20 * 40, 0)
    else:
        (mk,) = _full_hd(case).megakernels
        assert mk.least_ops() == LEAST_OPS[case]
        assert sum(mk.least_ops()) <= mk.flops


def test_generated_text_is_independent_of_node_uids():
    """Equal segments write equal text, so one build serves both."""
    a = compile_pipeline(PIPELINES["pyramid"](), options=CompileOptions(
        device="cpu")).lower().megakernels[0]
    b = _full_hd("pyramid").megakernels[0]
    assert a.source == b.source
    assert "mk_floordiv" in a.source      # Upsample's floor-divided offsets


# --------------------------------------------------------------------------
# (b) the 2-D plan, tile by tile, against the numpy executor
#
# A torch model of K3's tiling: for every output tile it takes each stored
# node's window (rows and columns from the emitter's demands), computes it
# from its inputs' windows, reads pure index remaps through to their inputs
# and sums box-sum chains from the chain's input window, wraps it like
# ``torch_mask`` and zeroes what lies outside the node's frame.  A read
# outside a stored window raises: the demands must cover every read.
# Values carry the engine's leading frame axis.

def _span(off, size, n):
    """The part [lo, hi) of virtual range [off, off+size) inside [0, n)."""
    return max(0, off), min(n, off + size)


def take_window(full, r, rows, c, cols):
    """Rows [r, r+rows) and columns [c, c+cols) of a whole frame ``full``
    (frames, h, w, ...) in virtual space, zero outside the frame."""
    h, w = full.shape[1:3]
    out = full.new_zeros((full.shape[0], rows, cols) + tuple(full.shape[3:]))
    r0, r1 = _span(r, rows, h)
    c0, c1 = _span(c, cols, w)
    if r0 < r1 and c0 < c1:
        out[:, r0 - r:r1 - r, c0 - c:c1 - c] = full[:, r0:r1, c0:c1]
    return out


def window_of(win, rel_r, rows, rel_c, cols):
    """Part of an extracted window; a read outside it is a fault of the
    geometry and raises."""
    if not (0 <= rel_r and rel_r + rows <= win.shape[1]
            and 0 <= rel_c and rel_c + cols <= win.shape[2]):
        raise AssertionError(
            f"read rows [{rel_r}, {rel_r + rows}) cols [{rel_c}, "
            f"{rel_c + cols}) outside a {tuple(win.shape[1:3])} window")
    return win[:, rel_r:rel_r + rows, rel_c:rel_c + cols]


def mask_outside_frame(win, r, c, h, w):
    """Zero the parts of ``win`` (covering virtual rows [r, ...) and
    columns [c, ...)) that fall outside the node's own frame h x w."""
    rows, cols = win.shape[1:3]
    r0, r1 = _span(r, rows, h)
    c0, c1 = _span(c, cols, w)
    if (r0, r1, c0, c1) == (r, r + rows, c, c + cols):
        return win
    out = torch.zeros_like(win)
    if r0 < r1 and c0 < c1:
        out[:, r0 - r:r1 - r, c0 - c:c1 - c] = \
            win[:, r0 - r:r1 - r, c0 - c:c1 - c]
    return out


class _Tile:
    """The windows of one output tile."""

    def __init__(self, mk, env: Dict[int, Any], r0: int, c0: int):
        self.mk, self.env, self.r0, self.c0 = mk, env, r0, c0
        self.nodes = {n.uid: n for n in mk.nodes}
        self.win: Dict[int, Tuple[Any, int, int]] = {}
        for u in mk.stored:
            n = self.nodes[u]
            r, c = mk.rows[u].off(r0), mk.cols[u].off(c0)
            rr, cc = mk.rows[u].size, mk.cols[u].size
            val = torch_mask(self._compute(n, r, rr, c, cc), n.ty)
            h, w = type_shape(n.ty)[:2]
            self.win[u] = (mask_outside_frame(val, r, c, h, w), r, c)

    def read(self, u: int, r: int, rows: int, c: int, cols: int):
        """Rows [r, r+rows) and columns [c, c+cols) of node u's virtual
        frame (a tuple for a tuple-typed node)."""
        if u in self.win:
            val, br, bc = self.win[u]
            return window_of(val, r - br, rows, c - bc, cols)
        if u not in self.nodes or self.nodes[u].op == "Const":
            v = self.env[u]
            if isinstance(v, tuple):
                return tuple(take_window(e, r, rows, c, cols) for e in v)
            return take_window(v, r, rows, c, cols)
        n = self.nodes[u]
        if u in self.mk.inline:
            # computed where it is read: only ever over its own window
            own = (self.mk.rows[u].off(self.r0), self.mk.rows[u].size,
                   self.mk.cols[u].off(self.c0), self.mk.cols[u].size)
            assert (r, rows, c, cols) == own, (n, (r, rows, c, cols), own)
            h, w = type_shape(n.ty)[:2]
            return mask_outside_frame(torch_mask(
                self._compute(n, r, rows, c, cols), n.ty), r, c, h, w)
        if n.op == "Stencil":
            l, b, sh, sw = _winsum_geometry(n)
            x = self.read(n.inputs[0], r + b, rows + sh - 1, c + l,
                          cols + sw - 1)
            patches = torch.stack([torch.stack(
                [x[:, dy:dy + rows, dx:dx + cols] for dx in range(sw)],
                dim=3) for dy in range(sh)], dim=3)
            h, w = type_shape(n.ty)[:2]
            return mask_outside_frame(patches, r, c, h, w)
        ins = [self.read(i, r, rows, c, cols) for i in n.inputs]
        return LOWERERS[n.op](n, n.params, ins)  # TupleIndex .. Replicate

    def _compute(self, n, r: int, rows: int, c: int, cols: int):
        p = n.params
        if n.uid in self.mk.winsum:
            stn = self.mk.winsum[n.uid]
            l, b, sh, sw = _winsum_geometry(stn)
            x = self.read(stn.inputs[0], r + b, rows + sh - 1, c + l,
                          cols + sw - 1)
            return sum(x[:, dy:dy + rows, dx:dx + cols]
                       for dy in range(sh) for dx in range(sw))
        if n.op == "Map":
            out_shape = type_shape(n.ty)
            plans = map_reshape_plans(n.ty, n.input_tys)
            args = []
            for j, (u, plan) in enumerate(zip(n.inputs, plans)):
                if _map_streams_input(n, j):
                    x = self.read(u, r, rows, c, cols)
                    if plan is not None:
                        x = x.reshape((x.shape[0], rows, cols)
                                      + tuple(plan[2:]))
                else:                   # broadcast whole (a Const)
                    x = self.env[u]
                    s = type_shape(n.input_tys[j])
                    shape = (tuple(plan) if plan is not None else
                             (1,) * (len(out_shape) - len(s)) + tuple(s))
                    x = x.reshape((x.shape[0],) + shape)
                args.append(x)
            return torch_point_fn(p["fn"])(*args)
        if n.op == "Pad":
            h_in, w_in = type_shape(n.input_tys[0])[:2]
            x = self.read(n.inputs[0], r - p["t"], rows, c - p["l"], cols)
            ys = torch.arange(r, r + rows) - p["t"]
            xs = torch.arange(c, c + cols) - p["l"]
            inside = (((ys >= 0) & (ys < h_in))[:, None]
                      & ((xs >= 0) & (xs < w_in))[None, :])
            inside = inside.reshape((1, rows, cols) + (1,) * (x.dim() - 3))
            fill = torch.full((), p.get("value", 0), dtype=x.dtype)
            return torch.where(inside, x, fill)
        if n.op == "Crop":
            return self.read(n.inputs[0], r + p["t"], rows, c + p["l"], cols)
        if n.op == "Downsample":
            sy, sx = p["sy"], p["sx"]
            x = self.read(n.inputs[0], r * sy, sy * (rows - 1) + 1, c * sx,
                          sx * (cols - 1) + 1)
            return x[:, ::sy, ::sx]
        if n.op == "Upsample":
            sy, sx = p["sy"], p["sx"]
            br, bc = r // sy, c // sx
            x = self.read(n.inputs[0], br, (rows + sy - 2) // sy + 1, bc,
                          (cols + sx - 2) // sx + 1)
            ry = [(r + i) // sy - br for i in range(rows)]
            rx = [(c + i) // sx - bc for i in range(cols)]
            return x[:, ry][:, :, rx]
        # Reduce, ReducePatch, ArgMin, Stack on the windows of the inputs
        ins = [self.read(u, r, rows, c, cols) for u in n.inputs]
        return LOWERERS[n.op](n, p, ins)


def evaluate_tiles(mk, *invals):
    """A megakernel site: the segment's outputs, computed tile by tile."""
    env: Dict[int, Any] = dict(zip(mk.in_uids, invals))
    for u, val in mk.consts.items():
        env[u] = torch.as_tensor(val)[None]
    frames = max((v[0] if isinstance(v, tuple) else v).shape[0]
                 for v in invals)
    outs = [torch.zeros((frames,) + lf.shape, dtype=lf.dtype)
            for lf in mk.out_leaves]
    h, w = mk.out_leaves[0].shape[:2]
    th, tw = mk.tile
    for r0 in range(0, h, th):
        for c0 in range(0, w, tw):
            tile = _Tile(mk, env, r0, c0)
            rows, cols = min(th, h - r0), min(tw, w - c0)
            for out, lf in zip(outs, mk.out_leaves):
                v = tile.read(lf.uid, r0, th, c0, tw)
                v = v[lf.k] if lf.k is not None else v
                out[:, r0:r0 + rows, c0:c0 + cols] = v[:, :rows, :cols]
    return mk.group_outputs(outs)


def _ufs(case):
    w, h = ODD[case]
    if case == "allops":
        return all_ops_pipeline(jax_core, w, h), all_ops_pipeline(port_core,
                                                                  w, h)
    return JAX_PIPELINES[case](w=w, h=h), PIPELINES[case](w=w, h=h)


def _batch(case, seed=0):
    w, h = ODD[case]
    x = np.random.RandomState(seed).randint(0, 256, (FRAMES, h, w))
    x[0, :2] = 0                        # flat rows: det == 0, AbsDiff == 0
    if case == "flow":
        return {"flow.in": (x, np.roll(x, 1, axis=-1))}
    return {f"{case}.in": x}


def _flat(r):
    if isinstance(r, tuple):
        return [x for e in r for x in _flat(e)]
    return [np.asarray(r)]


def _assert_matches_executor(case, design, batch):
    jax_uf = _ufs(case)[0]
    got = _flat(design.run_batch(batch))
    for f in range(FRAMES):
        one = {k: tuple(e[f] for e in v) if isinstance(v, tuple) else v[f]
               for k, v in batch.items()}
        want = _flat(evaluate(jax_uf.build()[1], one))
        assert len(want) == len(got)
        for w_, g in zip(want, got):
            assert w_.dtype == g.dtype and np.array_equal(w_, g[f])


def _with_site(monkeypatch, tile, site):
    """Lower with megakernels emitted at ``tile`` and run by ``site``."""
    monkeypatch.setattr(port_engine, "emit_megakernel", functools.partial(
        emit_megakernel, block_rows=tile[0], tile_cols=tile[1]))
    entry = registry.get_kernel("megakernel")
    monkeypatch.setitem(registry.KERNELS, "megakernel",
                        dataclasses.replace(entry, site_fn=site))


@pytest.mark.parametrize("tile", [(3, 5), (8, 32)])
@pytest.mark.parametrize("case", sorted(ODD))
def test_tiled_plan_matches_executor(case, tile, monkeypatch):
    _with_site(monkeypatch, tile, evaluate_tiles)
    design = compile_pipeline(_ufs(case)[1], options=CompileOptions(
        backend="kernels", device="cpu"))
    lp = design.lower()
    assert len(lp.megakernels) == 1 and lp.megakernels[0].tile == tile
    _assert_matches_executor(case, design, _batch(case))


# The generated CUDA C++ compiled as host C++: CUDA's builtins become
# plain C++ (one thread per block, so __syncthreads is a no-op), the kernel
# runs block by block over the grid.  This checks the emitted index
# arithmetic, masks and float operations; the card checks the rest.
_SHIM = textwrap.dedent(r"""
    #pragma once
    #include <cmath>
    #include <cstring>
    struct mk_dim3 { unsigned x, y, z; };
    static mk_dim3 blockIdx, threadIdx, blockDim;
    #define __global__
    #define __device__
    #define __forceinline__ inline
    #define __launch_bounds__(...)
    #define __syncthreads() ((void)0)
    inline float __fmul_rn(float a, float b) { return a * b; }
    inline float __fadd_rn(float a, float b) { return a + b; }
    inline float __fsub_rn(float a, float b) { return a - b; }
    inline float __fdiv_rn(float a, float b) { return a / b; }
    inline float __fsqrt_rn(float a) { return std::sqrt(a); }
    inline float __ll2float_rn(long long a) { return (float)a; }
    inline double __ll2double_rn(long long a) { return (double)a; }
    inline double __ddiv_rn(double a, double b) { return a / b; }
    inline double __dsqrt_rn(double a) { return std::sqrt(a); }
    inline float __double2float_rn(double a) { return (float)a; }
    inline float __int_as_float(int a) {
      float f; std::memcpy(&f, &a, 4); return f;
    }
    alignas(16) static unsigned char mk_host_smem[1 << 18];
""")


def _host_site(workdir):
    """A megakernel site that builds the segment's generated source with
    g++ and runs it on CPU tensors."""
    def site(mk, *invals):
        body, launcher = mk.source.split("// launcher", 1)
        body = body.replace(
            "extern __shared__ __align__(16) unsigned char mk_smem[];",
            "unsigned char* mk_smem = mk_host_smem;")
        args = re.search(r">>>\(\s*(.*?)\);", launcher, re.S).group(1)
        gx, gy = mk.grid_xy
        text = body + textwrap.dedent(f"""
            extern "C" void mk_host(void* const* ins,
                                    const long long* fstride,
                                    void* const* outs, int frames) {{
              blockDim = {{1, 1, 1}};
              threadIdx = {{0, 0, 0}};
              for (unsigned z = 0; z < (unsigned)frames; ++z)
                for (unsigned y = 0; y < {gy}u; ++y)
                  for (unsigned x = 0; x < {gx}u; ++x) {{
                    blockIdx = {{x, y, z}};
                    {mk.kernel_name}({args});
                  }}
            }}
        """)
        stem = workdir / hashlib.sha256(text.encode()).hexdigest()[:16]
        lib = stem.with_suffix(".so")
        if not lib.exists():
            stem.with_suffix(".cpp").write_text(text)
            subprocess.run(
                ["g++", "-std=c++17", "-O1", "-ffp-contract=off", "-shared",
                 "-fPIC", "-I", str(workdir), "-I", str(_build.CSRC), "-o",
                 str(lib), str(stem.with_suffix(".cpp"))],
                check=True, capture_output=True, timeout=300)
        fn = ctypes.CDLL(str(lib)).mk_host
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int]
        leaves = [t.contiguous() for v in invals
                  for t in (v if isinstance(v, tuple) else (v,))]
        frames = max(t.shape[0] for t in leaves)
        outs = [torch.zeros((frames,) + lf.shape, dtype=lf.dtype)
                for lf in mk.out_leaves]
        fn((ctypes.c_void_p * len(leaves))(*[t.data_ptr() for t in leaves]),
           (ctypes.c_longlong * len(leaves))(
               *[t[0].numel() if t.shape[0] == frames else 0
                 for t in leaves]),
           (ctypes.c_void_p * len(outs))(*[t.data_ptr() for t in outs]),
           frames)
        return mk.group_outputs(outs)
    return site


@pytest.fixture(scope="module")
def host_cxx(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the generated source on the host")
    d = tmp_path_factory.mktemp("mk_host")
    (d / "cuda_runtime.h").write_text(_SHIM)
    return d


@pytest.mark.parametrize("tile", [(3, 5), (8, 32)])
@pytest.mark.parametrize("case", sorted(ODD))
def test_generated_source_on_the_host_matches_executor(case, tile, host_cxx,
                                                       monkeypatch):
    _with_site(monkeypatch, tile, _host_site(host_cxx))
    design = compile_pipeline(_ufs(case)[1], options=CompileOptions(
        backend="kernels", device="cpu"))
    _assert_matches_executor(case, design, _batch(case, seed=1))


FUSED_PROBES = sorted(n for n in point_fn_probes(port_core) if n != "sqrt")


@pytest.mark.parametrize("probe", FUSED_PROBES)
def test_generated_source_on_the_host_matches_executor_on_probes(
        probe, host_cxx, monkeypatch):
    """FloatDiv by and FloatSqrt of integers above 2**24 (double, rounded
    once), and Sub and Abs of a Bool, in one fused segment each, as
    generated C++ on the host against the executor, bit for bit."""
    _with_site(monkeypatch, (8, 32), _host_site(host_cxx))
    juf, x = point_fn_probes(jax_core)[probe]
    uf = point_fn_probes(port_core)[probe][0]
    design = compile_pipeline(uf, options=CompileOptions(
        backend="kernels", device="cpu"))
    assert len(design.lower().megakernels) == 1
    key = f"{uf.name}.in"
    got = np.asarray(design.run_batch({key: x}))
    for f in range(len(x)):
        want = evaluate(juf.build()[1], {key: x[f]})
        assert want.dtype == got.dtype
        assert want.tobytes() == got[f].tobytes()


# --------------------------------------------------------------------------
# the kernel's layout: registers, shared memory and phases

def test_flow_keeps_patches_and_its_float_tail_in_registers():
    """FLOW at 1920x1080 and 8x32 tiles: the two Sobel patch products fold
    into their Reduces, no float node has a window, only the five products
    that the box sums read are stored (in 32 bits), and three phases (the
    products, the column sums, the rest and the outputs) need two
    barriers."""
    lp = _full_hd("flow")
    task = _mk_task(lp)
    mk = emit_megakernel(lp.ir, task.nodes, task.in_uids, task.out_uids,
                         tile_cols=32)
    assert mk.tile == (8, 32) and mk.smem_bytes <= 48 * 1024
    patch_maps = {n.uid for n in mk.nodes
                  if n.op == "Map" and len(type_shape(n.ty)) > 2
                  and n.uid not in mk.skip}
    floats = {n.uid for n in mk.nodes
              if isinstance(scalar_of(n.ty), Float)}
    assert len(patch_maps) == 2 and patch_maps <= mk.inline
    assert len(floats) == 16 and not floats & set(mk.stored)
    stored = [lp.ir.nodes[u] for u in mk.stored]
    assert [(n.op, n.params["fn"].name) for n in stored] == [("Map", "Mul")] * 5
    assert mk.source.count("int* w") == 5 and "long long* w" not in mk.source
    assert mk.source.count("__syncthreads()") == mk.barriers == 2
    assert mk.min_blocks >= 4


def _layout_uf(c, probe: str):
    """The layout probes, built from either package's core ``c``:
    ``two_readers``, a 3x3 patch product read by two Reduces (it stays
    stored); ``wide_box``, a 10x40 box sum, wider than either test tile;
    ``wrap32``, an Int(32) product that wraps, stored for a 3x3 sum (which
    wraps again); ``above31``, UInt(32) values above 2**31, stored for a
    3x3 maximum."""

    def two_readers(x):
        k = c.Const(c.Array2d(c.UInt(4), 3, 3),
                    np.arange(1, 10).reshape(3, 3))
        prod = c.Map(c.Mul)(c.Stencil(-1, 1, -1, 1)(x), k)
        return c.Concat(c.Reduce(c.Add)(prod), c.Reduce(c.Max)(prod))

    def wide_box(x):
        return c.Reduce(c.Add)(c.Map(c.AddMSBs(12))(
            c.Stencil(-39, 0, -9, 0)(x)))

    def wrap32(x):
        a = c.Map(c.Sub)(x, c.Const(c.UInt(16), 60000))         # Int(17)
        p = c.Map(c.RemoveMSBs(2))(c.Map(c.Mul)(a, a))          # Int(32)
        return c.Reduce(c.Add)(c.Stencil(-1, 1, -1, 1)(p))

    def above31(x):
        v = c.Map(c.Max)(x, c.Const(c.UInt(32), 5))
        return c.Reduce(c.Max)(c.Stencil(-1, 1, -1, 1)(v))

    body, ty = {"two_readers": (two_readers, c.UInt(8)),
                "wide_box": (wide_box, c.UInt(8)),
                "wrap32": (wrap32, c.UInt(16)),
                "above31": (above31, c.UInt(32))}[probe]
    w, h = (50, 30) if probe == "wide_box" else (37, 13)

    class Probe(c.UserFunction):
        def __init__(self):
            super().__init__(probe, c.Array2d(ty, w, h))

        def define(self, x):
            return body(x)

    return Probe()


def _layout_probe(name):
    """(frames, the layout property the probe checks)."""
    rng = np.random.RandomState(8)
    if name == "wide_box":
        x = rng.randint(0, 256, (FRAMES, 30, 50))
    elif name == "wrap32":
        x = rng.randint(0, 2 ** 16, (FRAMES, 13, 37))
    elif name == "above31":
        x = rng.randint(2 ** 31, 2 ** 32, (FRAMES, 13, 37)) ^ (
            rng.randint(0, 2, (FRAMES, 13, 37)) << 31)
    else:
        x = rng.randint(0, 256, (FRAMES, 13, 37))

    def stored_patch(mk):
        return any(len(type_shape(n.ty)) > 2 and n.uid in mk.stored
                   for n in mk.nodes)

    return x, {
        "two_readers": stored_patch,
        "wide_box": lambda mk: mk.n_winsum == 1
        and mk.cols[next(iter(mk.winsum))].size < 40,
        "wrap32": lambda mk: "int* w" in mk.source,
        "above31": lambda mk: "unsigned* w" in mk.source,
    }[name]


@pytest.mark.parametrize("tile", [(3, 5), (8, 32)])
@pytest.mark.parametrize("probe", ["two_readers", "wide_box", "wrap32",
                                   "above31"])
def test_layout_probes_match_executor(probe, tile, host_cxx, monkeypatch):
    """Each layout case as generated C++ on the host with g++, and as the
    CPU model of the tiling, against the executor bit for bit."""
    x, layout = _layout_probe(probe)
    key = f"{probe}.in"
    want = [evaluate(_layout_uf(jax_core, probe).build()[1], {key: f})
            for f in x]
    if probe == "wrap32":               # the products do wrap
        a = x.astype(np.int64) - 60000
        assert (a * a >= 2 ** 31).any()
    for site in (_host_site(host_cxx), evaluate_tiles):
        _with_site(monkeypatch, tile, site)
        design = compile_pipeline(_layout_uf(port_core, probe),
                                  options=CompileOptions(backend="kernels",
                                                         device="cpu"))
        (mk,) = design.lower().megakernels
        assert layout(mk)
        got = _flat(design.run_batch({key: x}))
        for f, w_ in enumerate(want):
            w_ = _flat(w_)
            assert [a.dtype for a in w_] == [g.dtype for g in got]
            assert all(a.tobytes() == g[f].tobytes()
                       for a, g in zip(w_, got))


def test_frames_past_int_range_index_in_64_bits():
    """A device-memory index within a frame is an int while the frame has
    fewer than 2**31 elements (FLOW at 1080p) and 64-bit past that (a
    3x3 sum over a 47000 x 46000 frame)."""
    flow = _mk_task(_full_hd("flow")).mk
    assert "static_cast<long long>(y" not in flow.source

    class Huge(port_core.UserFunction):
        def __init__(self):
            super().__init__("huge", port_core.Array2d(port_core.UInt(8),
                                                       47000, 46000))

        def define(self, x):
            return port_core.Reduce(port_core.Add)(
                port_core.Stencil(-1, 1, -1, 1)(x))

    design = compile_pipeline(Huge(), options=CompileOptions(
        backend="kernels", device="cpu"))
    (mk,) = design.lower().megakernels
    assert 47000 * 46000 >= 2 ** 31
    reads = re.findall(r"in0\[f \* fs0 \+ ([^\]]*)\]", mk.source)
    writes = re.findall(r"out0\[f \* \d+ \+ ([^\]]*)\]", mk.source)
    assert reads and writes
    assert all(i.startswith("static_cast<long long>(") for i in reads + writes)


# --------------------------------------------------------------------------
# emitter rules

def _wide(c):
    """A 17x17 patch product read by two Reduces, built from either
    package's core ``c``: the product stays stored, and its window needs
    295,936 B at 8x32 tiles."""

    class Wide(c.UserFunction):
        def __init__(self):
            super().__init__("wide", c.Array2d(c.UInt(8), 40, 20))

        def define(self, x):
            k = c.Const(c.Array2d(c.UInt(2), 17, 17),
                        np.arange(289).reshape(17, 17) % 4)
            prod = c.Map(c.Mul)(c.Stencil(-8, 8, -8, 8)(x), k)
            return c.Concat(c.Reduce(c.Add)(prod), c.Reduce(c.Max)(prod))

    return Wide()


def test_tile_columns_halve_until_the_windows_fit(monkeypatch):
    design = compile_pipeline(_wide(port_core), options=CompileOptions(
        backend="kernels", device="cpu"))
    (mk,) = design.lower().megakernels
    assert mk.tile == (8, 16) and mk.smem_bytes <= MK_SMEM_LIMIT
    assert "CUDA tile 8x16" in mk.report_line()
    x = np.random.RandomState(2).randint(0, 256, (FRAMES, 20, 40))
    want = [_flat(evaluate(_wide(jax_core).build()[1], {"wide.in": f}))
            for f in x]
    got = _flat(design.run_batch({"wide.in": x}))
    assert all(np.array_equal(g[f], w_) for f in range(FRAMES)
               for g, w_ in zip(got, want[f]))
    # the CPU model of the tiling at the emitted tile agrees
    monkeypatch.setitem(registry.KERNELS, "megakernel", dataclasses.replace(
        registry.get_kernel("megakernel"), site_fn=evaluate_tiles))
    tiled = compile_pipeline(_wide(port_core), options=CompileOptions(
        backend="kernels", device="cpu"))
    got = _flat(tiled.run_batch({"wide.in": x}))
    assert all(np.array_equal(g[f], w_) for f in range(FRAMES)
               for g, w_ in zip(got, want[f]))


class _Total(port_core.UserFunction):
    """x*x summed over the whole frame: a scalar, which has no tile form."""

    def __init__(self, c=port_core):
        super().__init__("total", c.Array2d(c.UInt(8), 12, 6))
        self.c = c

    def define(self, x):
        c = self.c
        return c.Reduce(c.Add)(c.Map(c.Mul)(x, x))


def test_segment_without_tile_form_stays_generic_with_a_note():
    design = compile_pipeline(_Total(), options=CompileOptions(
        backend="kernels", device="cpu"))
    lp = design.lower()
    assert lp.megakernels == []
    assert any(n.startswith("megakernel fallback (output %") for n in lp.notes)
    x = np.random.RandomState(4).randint(0, 256, (6, 12))
    want = evaluate(_Total(jax_core).build()[1], {"total.in": x})
    assert np.array_equal(design.run({"total.in": x}), want)


def test_megakernel_off_keeps_the_generic_rules():
    design = compile_pipeline(PIPELINES["flow"](w=37, h=13),
                              options=CompileOptions(device="cpu"))
    on, off = design.lower(), design.lower(megakernel="off")
    assert len(on.megakernels) == 1 and off.megakernels == []
    assert sum("window_sum" in str(d.kernel)
               for d in off.fusions.values()) == 5
    batch = _batch("flow")
    for a, b in zip(_flat(on.run_batch(batch)), _flat(off.run_batch(batch))):
        assert np.array_equal(a, b)
    assert "megakernel=off" in design.lowering_report()


def test_wrapper_takes_the_plain_version_on_cpu_and_refuses_other_devices():
    lp = compile_pipeline(PIPELINES["pyramid"](w=36, h=20),
                          options=CompileOptions(device="cpu")).lower()
    (mk,) = lp.megakernels
    (x,) = lp.segment_inputs(mk, _batch("pyramid"))
    registry.reset_launch_counts()
    (got,) = megakernel_segment(mk, x)
    assert torch.equal(got, megakernel_ref(mk, x)[0])
    assert registry.get_kernel("megakernel").launches() == 0
    with pytest.raises(ValueError, match="no kernel or plain version"):
        megakernel_segment(mk, x.to("meta"))


def test_check_leaves_holds_count_values_and_ulps():
    """The comparison chip_smoke and the card tests hold K3 to."""
    a = torch.tensor([1.0, -2.0, 0.0])
    b = torch.nextafter(a, torch.tensor(5.0))
    assert check_leaves("f", (a,), (b,), exact=False)["max_ulp"] == 1
    with pytest.raises(AssertionError, match="1 ULP"):
        check_leaves("f", (a,), (b,), exact=True)
    with pytest.raises(AssertionError, match="1 output leaves"):
        check_leaves("f", (a,), (a, a), exact=False)
    with pytest.raises(AssertionError, match="max abs diff 3"):
        check_leaves("i", torch.tensor([1, 7]), torch.tensor([4, 7]),
                     exact=False)


def test_generated_build_raises_without_nvcc(tmp_path, monkeypatch):
    if shutil.which("nvcc") or os.path.exists(
            os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                         "bin", "nvcc")):
        pytest.skip("nvcc is installed here")
    monkeypatch.setattr(_build, "GEN_DIR", tmp_path / "gen")
    mk = _full_hd("pyramid").megakernels[0]
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_generated({"pyramid": mk.source})
    (written,) = (tmp_path / "gen").glob("*.cu")
    assert written.read_text() == mk.source
