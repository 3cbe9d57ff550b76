"""Tests of the port that need the card: the CUDA kernels (conv2d, sad and
the generated megakernels) against their plain PyTorch versions, and the
kernels backend on the card against the same pipeline on the CPU.  Each is
marked ``card`` and skips where there is no CUDA device; run them on the
GPU machine with

    PYTHONPATH=src python -m pytest -q tests/test_torch_card.py

This file imports nothing of JAX, so it runs where only the port is
installed.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import CompileOptions, compile_pipeline  # noqa: E402
import repro_torch.core as port_core  # noqa: E402
from repro_torch.apps import BENCH_CASES, KERNEL_OF  # noqa: E402
from repro_torch.core.lowering.megakernel import FLOAT_ULP_BOUND  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.kernels.conv2d.ops import conv2d_stencil  # noqa: E402
from repro_torch.kernels.conv2d.ref import conv2d_ref  # noqa: E402
from repro_torch.kernels.sad.ops import sad_disparity  # noqa: E402
from repro_torch.kernels.megakernel.check import (  # noqa: E402
    all_ops_pipeline, check_leaves)
from repro_torch.kernels.megakernel.ops import megakernel_segment  # noqa: E402
from repro_torch.kernels.megakernel.ref import megakernel_ref  # noqa: E402
from repro_torch.kernels.sad.ref import sad_ref  # noqa: E402

pytestmark = pytest.mark.card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")
    registry.reset_launch_counts()
    return torch.device("cuda")


def _u8(rng, shape, dev):
    return torch.from_numpy(rng.randint(0, 256, shape).astype(
        np.int32)).to(dev)


@pytest.mark.parametrize("h,w,kh,kw,shift", [
    (13, 37, 3, 5, 0), (13, 37, 3, 5, 11), (40, 96, 8, 8, 11),
    (9, 33, 8, 8, 40)])
def test_conv2d_kernel_matches_plain(card, h, w, kh, kw, shift):
    rng = np.random.RandomState(h + w + shift)
    p = _u8(rng, (3, h + kh - 1, w + kw - 1), card)
    k = torch.from_numpy(rng.randint(0, 64, (kh, kw)).astype(
        np.int32)).to(card)
    out = conv2d_stencil(p, k, shift=shift)
    assert torch.equal(out, conv2d_ref(p, k, shift))
    assert registry.get_kernel("conv2d").launches() == 1


@pytest.mark.parametrize("h,w,nd,bh,bw", [(13, 37, 5, 3, 4),
                                          (24, 64, 8, 8, 8)])
def test_sad_kernel_matches_plain(card, h, w, nd, bh, bw):
    rng = np.random.RandomState(h + nd)
    shape = (3, h + bh - 1, w + bw - 1 + nd - 1)
    l, r = _u8(rng, shape, card), _u8(rng, shape, card)
    out = sad_disparity(l, r, nd=nd, bh=bh, bw=bw)
    assert torch.equal(out, sad_ref(l, r, nd=nd, bh=bh, bw=bw))
    tie = torch.full(shape, 3, dtype=torch.int32, device=card)
    assert not sad_disparity(tie, tie.clone(), nd=nd, bh=bh, bw=bw).any()
    assert registry.get_kernel("sad").launches() == 2


def _same(a, b):
    """Equal outputs, leaf by leaf (FLOW and DESCRIPTOR return tuples)."""
    a = list(a) if isinstance(a, tuple) else [a]
    b = list(b) if isinstance(b, tuple) else [b]
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.mark.parametrize("app", sorted(BENCH_CASES))
def test_kernels_backend_on_card_matches_cpu(card, app):
    uf, inputs = BENCH_CASES[app]()
    design = compile_pipeline(uf, options=CompileOptions(backend="kernels"))
    rng = np.random.RandomState(2)
    one, batch = inputs(rng), inputs(rng, frames=3)
    _same(design.run(one), design.run(one, device="cpu"))
    _same(design.run_batch(batch), design.run_batch(batch, device="cpu"))
    # one launch per run and one per batch of 3 frames
    assert registry.get_kernel(KERNEL_OF[app]).launches() == 2


@pytest.mark.parametrize("case", ["flow", "descriptor", "pyramid", "allops"])
def test_megakernel_matches_plain(card, case):
    """Each app's generated segment (and the all-ops pipeline, on a frame
    no tile divides) against its plain version: integers and DESCRIPTOR
    exactly, other floats within FLOAT_ULP_BOUND."""
    if case == "allops":
        uf = all_ops_pipeline(port_core)
        x = np.random.RandomState(6).randint(0, 256, (3, uf.h, uf.w))
        batch = {"allops.in": x}
    else:
        uf, inputs = BENCH_CASES[case]()
        batch = inputs(np.random.RandomState(6), frames=3)
    lp = compile_pipeline(uf, options=CompileOptions(
        backend="kernels")).lower()
    (mk,) = lp.megakernels
    seg_in = lp.segment_inputs(mk, batch)
    got = megakernel_segment(mk, *seg_in)
    torch.cuda.synchronize()
    res = check_leaves(case, got, megakernel_ref(mk, *seg_in),
                       exact=case == "descriptor")
    assert res["max_ulp"] <= FLOAT_ULP_BOUND
    assert registry.get_kernel("megakernel").launches() == 1
