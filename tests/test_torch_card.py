"""Tests of the port that need the card: the CUDA kernels (conv2d, sad,
the generated megakernels, flash attention and the cycle kernel) against
their plain PyTorch versions, the kernels backend on the card against the same
pipeline on the CPU, and the model substrate's forwards (every family) on
the card against the CPU.  Each is
marked ``card`` and skips where there is no CUDA device; run them on the
GPU machine with

    PYTHONPATH=src python -m pytest -q tests/test_torch_card.py

This file imports nothing of JAX, so it runs where only the port is
installed.
"""
import copy
import ctypes

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import CompileOptions, compile_pipeline  # noqa: E402
import repro_torch.core as port_core  # noqa: E402
from repro_torch.apps import BENCH_CASES, KERNEL_OF  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.core.lowering.megakernel import FLOAT_ULP_BOUND  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.kernels.conv2d.ops import conv2d_stencil  # noqa: E402
from repro_torch.kernels.conv2d.ref import conv2d_ref  # noqa: E402
from repro_torch.kernels.sad.ops import sad_disparity  # noqa: E402
from repro_torch.kernels.megakernel.check import (  # noqa: E402
    all_ops_pipeline, check_leaves, external_pipelines,
    point_fn_probes)
from repro_torch.kernels.megakernel.ops import megakernel_segment  # noqa: E402
from repro_torch.kernels.megakernel.ref import megakernel_ref  # noqa: E402
from repro_torch.kernels.sad.ref import sad_ref  # noqa: E402
from repro_torch.kernels.flash import flash_attention, flash_decode  # noqa: E402
from repro_torch.kernels.flash.ops import (  # noqa: E402
    DECODE_KERNELS, MAX_CLUSTER, decode_cluster, decode_head_group,
    decode_kernel, decode_launch, decode_split, form_launches, kernel_form,
    prefill_form, wgmma_plan)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.timing import device_events  # noqa: E402
from repro_torch.kernels.flash.ref import attention_ref  # noqa: E402
from _torch_cases import conv_case, map_chain  # noqa: E402

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


# the 8x8 form (CONVOLUTION's taps) and the general form (any other)
CONV_CASES = [
    conv_case(13, 37, 3, 5, 0), conv_case(13, 37, 3, 5, 11),
    conv_case(40, 96, 8, 8, 11), conv_case(9, 33, 8, 8, 40),
    conv_case(13, 37, 1, 1, 11), conv_case(13, 37, 11, 2, 11),
    conv_case(13, 37, 2, 16, 11), conv_case(40, 96, 8, 8, 11, 2 ** 23 - 64),
    conv_case(13, 37, 3, 5, 11, 2 ** 23 - 64)]


@pytest.mark.parametrize("h,w,kh,kw,shift,tap_lo", CONV_CASES)
def test_conv2d_kernel_matches_plain(card, h, w, kh, kw, shift, tap_lo):
    rng = np.random.RandomState(h + w + shift)
    p = _u8(rng, (3, h + kh - 1, w + kw - 1), card)
    k = torch.from_numpy(rng.randint(tap_lo, tap_lo + 64, (kh, kw)).astype(
        np.int32)).to(card)
    out = conv2d_stencil(p, k, shift=shift)
    assert torch.equal(out, conv2d_ref(p, k, shift))
    assert registry.get_kernel("conv2d").launches() == 1


def _sad_planes(rng, shape, data, dev):
    """L and R planes: random bytes; R repeating every 5 columns (so
    disparities 5 apart tie and the first must win); or values at the top
    of _sad_guard's range for 8x8 blocks, each pixel near 0 or near 2**24,
    so the sums come near 2**30."""
    l = rng.randint(0, 256, shape)
    r = rng.randint(0, 256, shape)
    if data == "period5":
        r = np.tile(r[..., :5], (1, 1, -(-shape[2] // 5)))[..., :shape[2]]
    if data == "top":
        l = l + (rng.randint(0, 2, shape) << 24) - (l > 0) * 256
        r = r + (rng.randint(0, 2, shape) << 24) - (r > 0) * 256
        l, r = np.clip(l, 0, 2 ** 24 - 1), np.clip(r, 0, 2 ** 24 - 1)
    return (torch.from_numpy(np.ascontiguousarray(a).astype(np.int32)).to(
        dev) for a in (l, r))


# STEREO's own shape (3 frames of 407x790), a shape no tile divides whose
# disparities span two staged chunks, the small cases, and blocks the
# tiled form cannot take (wider than a warp, too tall for its windows in
# shared memory, both), which the general form runs
@pytest.mark.parametrize("data", ["random", "period5", "top"])
@pytest.mark.parametrize("h,w,nd,bh,bw", [(13, 37, 5, 3, 4),
                                          (24, 64, 8, 8, 8),
                                          (400, 720, 64, 8, 8),
                                          (37, 101, 70, 5, 7),
                                          (21, 90, 9, 5, 40),
                                          (19, 300, 6, 300, 3),
                                          (10, 260, 4, 40, 70)])
def test_sad_kernel_matches_plain(card, h, w, nd, bh, bw, data):
    rng = np.random.RandomState(h + nd)
    shape = (3, h + bh - 1, w + bw - 1 + nd - 1)
    l, r = _sad_planes(rng, shape, data, card)
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


@pytest.mark.parametrize("case", ["clip", "tuple", "wide"])
def test_external_on_card_matches_cpu_and_executor(card, case):
    """External between generated segments on the card: both backends'
    run_batch equal the kernels backend on the CPU and the executor, and
    the numpy model runs once per frame."""
    log = []
    uf = external_pipelines(port_core, 37, 13, log)[case]
    key = f"{uf.name}.in"
    x = np.random.RandomState(7).randint(0, 256, (3, 13, 37))
    design = compile_pipeline(uf, options=CompileOptions(backend="kernels"))
    want = design.run_batch({key: x}, backend="numpy")
    _same(design.run_batch({key: x}, device="cpu"), want)
    for backend in ("kernels", "torch"):
        log.clear()
        _same(design.run_batch({key: x}, backend=backend), want)
        assert len(log) == 3
        _same(design.run({key: x[0]}, backend=backend),
              design.run({key: x[0]}, backend="numpy"))
    if case == "clip":
        assert registry.get_kernel("megakernel").launches() == 2 * 2


@pytest.mark.parametrize("frames", [1, 3])
@pytest.mark.parametrize("case", ["flow", "descriptor", "pyramid", "allops"])
def test_megakernel_matches_plain(card, case, frames):
    """Each app's generated segment (and the all-ops pipeline, on a frame
    no tile divides) against its plain version at 1 and 3 frames: integers
    exactly and floats to 0 ULP (each f32 operation rounds once, as the
    plain version's does; the contract's bound is FLOAT_ULP_BOUND)."""
    if case == "allops":
        uf = all_ops_pipeline(port_core)
        x = np.random.RandomState(6).randint(0, 256, (frames, uf.h, uf.w))
        batch = {"allops.in": x}
    else:
        uf, inputs = BENCH_CASES[case]()
        batch = inputs(np.random.RandomState(6), frames=frames)
    lp = compile_pipeline(uf, options=CompileOptions(
        backend="kernels")).lower()
    (mk,) = lp.megakernels
    seg_in = lp.segment_inputs(mk, batch)
    got = megakernel_segment(mk, *seg_in)
    torch.cuda.synchronize()
    res = check_leaves(case, got, megakernel_ref(mk, *seg_in), exact=True)
    assert res["max_ulp"] == 0 <= FLOAT_ULP_BOUND
    assert registry.get_kernel("megakernel").launches() == 1


@pytest.mark.parametrize("probe", sorted(point_fn_probes(port_core)))
def test_point_fn_probes_on_card_match_cpu(card, probe):
    """FloatDiv by and FloatSqrt of integers above 2**24 and Sub and Abs
    of a Bool, on the kernels backend on the card (K3's double-precision
    mk_fdiv / mk_fsqrt overloads and its bool Sub / Abs in every probe but
    the lone-node ``sqrt``), against the torch backend on the CPU bit for
    bit: test_torch_pipeline.py holds the latter to the executor."""
    uf, x = point_fn_probes(port_core)[probe]
    key = f"{uf.name}.in"
    design = compile_pipeline(uf, options=CompileOptions(backend="kernels"))
    cpu = compile_pipeline(uf, options=CompileOptions(backend="torch",
                                                      device="cpu"))
    fused = len(design.lower().megakernels)
    assert fused == (probe != "sqrt")
    for f in range(len(x)):
        got, want = design.run({key: x[f]}), cpu.run({key: x[f]})
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    got, want = design.run_batch({key: x}), cpu.run_batch({key: x})
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert registry.get_kernel("megakernel").launches() == fused * (
        len(x) + 1)


# K4: tests/test_kernels.py's coverage classes (GQA f32, windowed bf16, MHA
# D=256 f32, ragged bf16) at its tolerances, and the main path's shapes;
# then bf16 cases for the wgmma form: D 64/128/256 at a ragged Sq and
# window, a non-causal ragged Skv, a window with empty-band rows (rows 25..
# of Sq 40 see no key of Skv 20), GQA at D 256, and granite's GQA (D 64, 3
# query heads a kv head), qwen2-vl's g 7 and command-r-plus's g 12 at D
# 128, in both types
FLASH_CASES = [
    (2, 48, 48, 4, 2, 128, True, None, torch.float32, 2e-5),
    (2, 48, 48, 4, 4, 128, True, 13, torch.bfloat16, 3e-2),
    (1, 64, 64, 8, 2, 256, True, None, torch.float32, 2e-5),
    (1, 40, 40, 4, 1, 128, True, None, torch.bfloat16, 3e-2),
    (2, 24, 37, 4, 2, 64, False, None, torch.float32, 2e-5),
    (2, 40, 20, 4, 2, 64, True, 6, torch.float32, 2e-5),
    (1, 200, 200, 4, 1, 256, True, 70, torch.bfloat16, 3e-2),
    (1, 200, 200, 4, 1, 64, True, 70, torch.bfloat16, 3e-2),
    (1, 200, 200, 4, 1, 128, True, 70, torch.bfloat16, 3e-2),
    (2, 77, 1001, 4, 2, 128, False, None, torch.bfloat16, 3e-2),
    (2, 40, 20, 4, 2, 64, True, 6, torch.bfloat16, 3e-2),
    (2, 40, 20, 4, 2, 256, True, 6, torch.bfloat16, 3e-2),
    (2, 130, 130, 8, 2, 256, True, None, torch.bfloat16, 3e-2),
    # the SIMT form at D 256: a ragged Sq and window, GQA with g 4
    (1, 200, 200, 4, 1, 256, True, 70, torch.float32, 2e-5),
    (2, 130, 130, 8, 2, 256, True, None, torch.float32, 2e-5),
    (2, 200, 200, 24, 8, 64, True, None, torch.bfloat16, 3e-2),
    (2, 130, 130, 24, 8, 64, True, None, torch.float32, 2e-5),
    # D 128 with g 7 (qwen2-vl's 28 query heads on 4 kv heads) and g 12
    # (command-r-plus's 96 on 8), in both forms
    (2, 200, 200, 28, 4, 128, True, None, torch.bfloat16, 3e-2),
    (2, 130, 130, 28, 4, 128, True, None, torch.float32, 2e-5),
    (2, 200, 200, 96, 8, 128, True, None, torch.bfloat16, 3e-2),
    (2, 130, 130, 96, 8, 128, True, None, torch.float32, 2e-5),
]


def _randn(rng, shape, dtype, dev):
    return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
        dev).to(dtype)


@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,D,causal,window,dtype,atol",
                         FLASH_CASES)
def test_flash_kernel_matches_plain(card, B, Sq, Skv, H, Hkv, D, causal,
                                    window, dtype, atol):
    rng = np.random.RandomState(Sq + Skv + D)
    q = _randn(rng, (B, Sq, H, D), dtype, card)
    k = _randn(rng, (B, Skv, Hkv, D), dtype, card)
    v = _randn(rng, (B, Skv, Hkv, D), dtype, card)
    out = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    want = attention_ref(q, k, v, causal=causal, window=window)
    assert out.dtype == dtype
    assert (out.float() - want).abs().max().item() <= atol
    assert registry.get_kernel("flash_attention").launches() == 1
    # bf16 takes the wgmma form at D 64, 128 and 256, f32 the SIMT form
    form = prefill_form(dtype, D, D)
    assert form == ("prefill_simt" if dtype == torch.float32
                    else "prefill_wgmma")
    assert form_launches() == {"prefill_wgmma": 0,
                               "prefill_simt": 0, "decode": 0, form: 1}


@pytest.mark.parametrize("dtype,atol", [(torch.bfloat16, 3e-2),
                                        (torch.float32, 2e-5)])
def test_flash_padded_mla_prefill_matches_plain(card, dtype, atol):
    """MLA's prefill as models.layers.mla_block hands it to K4: q and k at
    192 (128 + 64) and v at 128, zero-padded to 256, the scale
    1/sqrt(192); the output's last 128 columns are exactly zero and the
    rest is the plain version's on the unpadded operands."""
    rng = np.random.RandomState(192)
    B, S, H = 2, 150, 16
    q, k = (_randn(rng, (B, S, H, 192), dtype, card) for _ in range(2))
    v = _randn(rng, (B, S, H, 128), dtype, card)
    pad = [torch.nn.functional.pad(t, (0, 256 - t.shape[-1]))
           for t in (q, k, v)]
    out = flash_attention(*pad, causal=True, scale=192 ** -0.5)
    torch.cuda.synchronize()
    assert out.shape == (B, S, H, 256) and out.dtype == dtype
    assert torch.equal(out[..., 128:], torch.zeros_like(out[..., 128:]))
    want = attention_ref(q, k, v, causal=True)
    assert (out[..., :128].float() - want).abs().max().item() <= atol
    assert form_launches()[prefill_form(dtype, 256, 256)] == 1


# (Dk, Dv) = (192, 128): DeepSeek-V2's MLA unpadded, in both prefill forms.
# (B, Sq, Skv, H, Hkv, causal, q_offset, window, lse): a ragged Sq, Skv
# past Sq with the rows at its end, a window, GQA over a ragged Skv
# without a mask, and the serving path's shape (4 x 1024, 128 heads: the
# wgmma form's list in chunks of two passes, K and V past half the L2)
DKDV_CASES = [(2, 200, 200, 4, 4, True, 0, None, False),
              (1, 100, 333, 4, 4, True, 233, None, True),
              (2, 150, 150, 8, 8, True, 0, 40, True),
              (2, 77, 130, 4, 2, False, 0, None, False),
              (4, 1024, 1024, 128, 128, True, 0, None, False)]


@pytest.mark.parametrize("dtype,atol", [(torch.bfloat16, 3e-2),
                                        (torch.float32, 2e-5)])
@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,causal,q_offset,window,lse",
                         DKDV_CASES)
def test_flash_dk_dv_kernel_matches_plain(card, B, Sq, Skv, H, Hkv, causal,
                                          q_offset, window, lse, dtype,
                                          atol):
    """K4 at Dk 192 and Dv 128 without zero padding: out (B, Sq, H, 128)
    within atol of the plain version (3e-2 bf16, 2e-5 f32), the row
    log-sum-exp within 1e-4, one launch of the dtype's form."""
    rng = np.random.RandomState(Sq + Skv + q_offset)
    q = _randn(rng, (B, Sq, H, 192), dtype, card)
    k = _randn(rng, (B, Skv, Hkv, 192), dtype, card)
    v = _randn(rng, (B, Skv, Hkv, 128), dtype, card)
    got = flash_attention(q, k, v, causal=causal, window=window,
                          q_offset=q_offset, return_lse=lse)
    torch.cuda.synchronize()
    want = attention_ref(q, k, v, causal=causal, window=window,
                         q_offset=q_offset, return_lse=lse)
    if lse:
        (got, got_lse), (want, want_lse) = got, want
        assert got_lse.shape == (B, H, Sq)
        assert (got_lse - want_lse).abs().max().item() <= 1e-4
    assert got.shape == (B, Sq, H, 128) and got.dtype == dtype
    assert (got.float() - want).abs().max().item() <= atol
    assert form_launches() == {"prefill_wgmma": 0,
                               "prefill_simt": 0, "decode": 0,
                               prefill_form(dtype, 192, 128): 1}


# the wgmma form's grouped heads: (D, g) with g query heads a kv head.  It
# runs 128 rows of one query head a block whatever g: at D 64 granite's g
# 3 and g 2, 4, 5 and 8 (the Q-register form before it split these over
# blocks of up to 3 heads); at D 128 and 256 the path's g 7 (qwen2-vl), 8
# (qwen2-72b, jamba; gemma-2b's MQA at D 256) and 12 (command-r-plus), and
# gemma3-1b's g 4 at D 256
GROUP_CASES = [(64, 2), (64, 3), (64, 4), (64, 5), (64, 8), (128, 3),
               (128, 4), (128, 7), (128, 8), (128, 12), (256, 4), (256, 8)]


@pytest.mark.parametrize("D,g", GROUP_CASES)
def test_flash_grouped_heads_match_plain(card, D, g):
    """bf16 prefill with g query heads on each of 2 kv heads: a ragged Sq
    200 with window 70; rows at q_offset 100 against 300 keys with the
    lse; q, k, v as head views of one wider projection, equal to their
    contiguous copies.  3e-2 on out, 1e-4 on the lse."""
    rng = np.random.RandomState(D + g)
    Hkv = 2
    H = g * Hkv
    bf16 = torch.bfloat16
    q = _randn(rng, (2, 200, H, D), bf16, card)
    k = _randn(rng, (2, 200, Hkv, D), bf16, card)
    v = _randn(rng, (2, 200, Hkv, D), bf16, card)
    out = flash_attention(q, k, v, causal=True, window=70)
    torch.cuda.synchronize()
    want = attention_ref(q, k, v, causal=True, window=70)
    assert (out.float() - want).abs().max().item() <= 3e-2
    k = _randn(rng, (2, 300, Hkv, D), bf16, card)
    v = _randn(rng, (2, 300, Hkv, D), bf16, card)
    out, lse = flash_attention(q, k, v, causal=True, q_offset=100,
                               return_lse=True)
    torch.cuda.synchronize()
    want, want_lse = attention_ref(q, k, v, causal=True, q_offset=100,
                                   return_lse=True)
    assert (out.float() - want).abs().max().item() <= 3e-2
    assert (lse - want_lse).abs().max().item() <= 1e-4
    qkv = _randn(rng, (2, 150, H + 2 * Hkv, D), bf16, card)
    q, k, v = qkv[:, :, :H], qkv[:, :, H:H + Hkv], qkv[:, :, H + Hkv:]
    out = flash_attention(q, k, v, causal=True, window=40)
    torch.cuda.synchronize()
    want = attention_ref(q, k, v, causal=True, window=40)
    assert (out.float() - want).abs().max().item() <= 3e-2
    assert torch.equal(out, flash_attention(q.contiguous(), k.contiguous(),
                                            v.contiguous(), causal=True,
                                            window=40))
    form = prefill_form(bf16, D, D)
    assert form_launches() == {"prefill_wgmma": 0,
                               "prefill_simt": 0, "decode": 0, form: 4}


@pytest.mark.parametrize("D", [64, 128, 256])
def test_flash_wgmma_empty_band_rows_match_plain(card, D):
    """The wgmma form on rows with no key in their band (rows 25.. of Sq
    40 against Skv 20 under window 6, and a q tile of 128 rows past 300
    keys under window 50 at an offset): they average every key, as the
    plain version does, and their lse is the plain version's (-1e30 plus
    the log of the key count); 3e-2 on out, 1e-4 on the lse."""
    rng = np.random.RandomState(D + 40)
    bf16 = torch.bfloat16
    for B, Sq, Skv, H, Hkv, window, off in ((2, 40, 20, 4, 2, 6, 0),
                                            (1, 200, 300, 6, 2, 50, 220)):
        q = _randn(rng, (B, Sq, H, D), bf16, card)
        k = _randn(rng, (B, Skv, Hkv, D), bf16, card)
        v = _randn(rng, (B, Skv, Hkv, D), bf16, card)
        out, lse = flash_attention(q, k, v, causal=True, window=window,
                                   q_offset=off, return_lse=True)
        torch.cuda.synchronize()
        want, want_lse = attention_ref(q, k, v, causal=True, window=window,
                                       q_offset=off, return_lse=True)
        assert bool((want_lse < -1e29).any())      # empty-band rows exist
        assert (out.float() - want).abs().max().item() <= 3e-2
        assert (lse - want_lse).abs().max().item() <= 1e-4
    assert form_launches()["prefill_wgmma"] == 2


def test_flash_prefill_form_matches_the_kernels_dispatch(card):
    """ops.prefill_form, which the wrapper and tests read, against the C
    dispatch's own choice (flash_prefill_form: 0 SIMT, 2 wgmma) for both
    types and every pair, -1 for a pair K4 is not built for; the wgmma
    form's shared bytes against ops.wgmma_plan, the Python plan, at every
    pair, MLA's (192, 128) included."""
    lib = _build.build_all(["flash_attn"])["flash_attn"].lib
    lib.flash_prefill_form.argtypes = [ctypes.c_int] * 3
    lib.flash_prefill_form.restype = ctypes.c_int
    codes = {"prefill_simt": 0, "prefill_wgmma": 2}
    for code, dtype in enumerate((torch.float32, torch.bfloat16)):
        for dk, dv in ((64, 64), (128, 128), (192, 128), (256, 256)):
            assert lib.flash_prefill_form(code, dk, dv) == \
                codes[prefill_form(dtype, dk, dv)]
        for dk, dv in ((96, 96), (128, 64), (256, 128)):
            assert lib.flash_prefill_form(code, dk, dv) == -1
    lib.flash_wgmma_smem_bytes.argtypes = [ctypes.c_int] * 2
    lib.flash_wgmma_smem_bytes.restype = ctypes.c_int
    for dk, dv in ((64, 64), (128, 128), (192, 128), (256, 256)):
        assert lib.flash_wgmma_smem_bytes(dk, dv) == \
            wgmma_plan(dk, dv)["smem_bytes"]
    assert lib.flash_wgmma_smem_bytes(192, 192) == 0


def test_flash_wgmma_form_takes_any_scale(card):
    """The wgmma form scales each score before its row max, so a bf16
    prefill takes a scale that is not positive at every pair it is built
    for (MLA's (192, 128), D 64 and D 256 here), against the plain version
    at 3e-2."""
    rng = np.random.RandomState(11)
    bf16 = torch.bfloat16
    for dk, dv, scale in ((192, 128, -0.125), (64, 64, -0.125),
                          (256, 256, -0.0625)):
        q, k = (_randn(rng, (1, 40, 2, dk), bf16, card) for _ in range(2))
        v = _randn(rng, (1, 40, 2, dv), bf16, card)
        out = flash_attention(q, k, v, scale=scale)
        torch.cuda.synchronize()
        want = attention_ref(q, k, v, scale=scale)
        assert (out.float() - want).abs().max().item() <= 3e-2
    assert form_launches() == {"prefill_wgmma": 3,
                               "prefill_simt": 0, "decode": 0}


def test_flash_unbuilt_head_dims_raise(card):
    """A (Dk, Dv) pair K4 is not built for raises on the card, in either
    dtype, before any launch: no pad, no other form in its place; the
    decode form takes no (192, 128)."""
    rng = np.random.RandomState(3)
    for dtype in (torch.bfloat16, torch.float32):
        for dk, dv in ((96, 64), (192, 192), (128, 192), (256, 128)):
            q = _randn(rng, (1, 16, 2, dk), dtype, card)
            k = _randn(rng, (1, 16, 2, dk), dtype, card)
            v = _randn(rng, (1, 16, 2, dv), dtype, card)
            with pytest.raises(ValueError, match="built for"):
                flash_attention(q, k, v)
    q = _randn(rng, (1, 1, 2, 192), torch.bfloat16, card)
    k = _randn(rng, (1, 16, 2, 192), torch.bfloat16, card)
    v = _randn(rng, (1, 16, 2, 128), torch.bfloat16, card)
    with pytest.raises(ValueError, match="built for"):
        flash_decode(q, k, v)
    assert registry.get_kernel("flash_attention").launches() == 0


def test_flash_bf16_strided_head_views(card):
    """GQA with q, k, v as head views of one wider (B, S, H + 2 Hkv, D)
    projection, as a fused QKV product would hand them over: strided
    along s and offset, but 16-byte aligned."""
    rng = np.random.RandomState(11)
    H, Hkv, D = 8, 2, 128
    qkv = _randn(rng, (2, 150, H + 2 * Hkv, D), torch.bfloat16, card)
    q, k, v = qkv[:, :, :H], qkv[:, :, H:H + Hkv], qkv[:, :, H + Hkv:]
    assert not q.is_contiguous()
    out = flash_attention(q, k, v, causal=True, window=40)
    torch.cuda.synchronize()
    want = attention_ref(q, k, v, causal=True, window=40)
    assert (out.float() - want).abs().max().item() <= 3e-2
    assert torch.equal(out, flash_attention(q.contiguous(), k.contiguous(),
                                            v.contiguous(), causal=True,
                                            window=40))
    assert form_launches()["prefill_wgmma"] == 2


@pytest.mark.parametrize("g", [1, 3])
def test_flash_wgmma_d64_matches_plain(card, g):
    """The wgmma form at D 64 with g 1 (musicgen's MHA) and g 3 (granite's
    GQA): causal and under a window, with its lse, at a q_offset, rows with
    no key in their band, and q, k, v as strided head views of one wider
    projection (equal to their contiguous copies); 3e-2 on out, 1e-4 on
    the lse, and every launch on the wgmma form."""
    rng = np.random.RandomState(64 + g)
    bf16, D, Hkv = torch.bfloat16, 64, 4
    H = g * Hkv
    cases = [(2, 300, 300, None, 0), (2, 300, 300, 90, 0),
             (1, 130, 500, None, 370), (1, 200, 300, 50, 220)]
    for B, Sq, Skv, window, off in cases:
        q = _randn(rng, (B, Sq, H, D), bf16, card)
        k = _randn(rng, (B, Skv, Hkv, D), bf16, card)
        v = _randn(rng, (B, Skv, Hkv, D), bf16, card)
        out, lse = flash_attention(q, k, v, causal=True, window=window,
                                   q_offset=off, return_lse=True)
        plain = flash_attention(q, k, v, causal=True, window=window,
                                q_offset=off)
        torch.cuda.synchronize()
        want, want_lse = attention_ref(q, k, v, causal=True, window=window,
                                       q_offset=off, return_lse=True)
        # the last case's rows past position 349 see no key of their band
        assert bool((want_lse < -1e29).any()) == (window == 50)
        assert (out.float() - want).abs().max().item() <= 3e-2
        assert (lse - want_lse).abs().max().item() <= 1e-4
        assert torch.equal(out, plain)
    qkv = _randn(rng, (2, 150, H + 2 * Hkv, D), bf16, card)
    q, k, v = qkv[:, :, :H], qkv[:, :, H:H + Hkv], qkv[:, :, H + Hkv:]
    assert not q.is_contiguous()
    out = flash_attention(q, k, v, causal=True, window=40)
    torch.cuda.synchronize()
    want = attention_ref(q, k, v, causal=True, window=40)
    assert (out.float() - want).abs().max().item() <= 3e-2
    assert torch.equal(out, flash_attention(q.contiguous(), k.contiguous(),
                                            v.contiguous(), causal=True,
                                            window=40))
    assert form_launches() == {"prefill_wgmma": 10,
                               "prefill_simt": 0, "decode": 0}


def test_flash_f32_strided_head_views(card):
    """The SIMT form on head views of one wider f32 projection (16-byte
    rows: 16-byte copies) and on views whose rows start 4 bytes off
    (4-byte copies): each as its contiguous copy, within 2e-5 of the
    plain version."""
    rng = np.random.RandomState(13)
    H, Hkv, D = 8, 2, 128
    qkv = _randn(rng, (2, 150, H + 2 * Hkv, D), torch.float32, card)
    flat = _randn(rng, (2, 150, (H + 2 * Hkv) * D + 1), torch.float32, card)
    off = flat[:, :, 1:].unflatten(2, (H + 2 * Hkv, D))
    for t in (qkv, off):
        q, k, v = t[:, :, :H], t[:, :, H:H + Hkv], t[:, :, H + Hkv:]
        assert not q.is_contiguous()
        out = flash_attention(q, k, v, causal=True, window=40)
        torch.cuda.synchronize()
        want = attention_ref(q, k, v, causal=True, window=40)
        assert (out - want).abs().max().item() <= 2e-5
        assert torch.equal(out, flash_attention(
            q.contiguous(), k.contiguous(), v.contiguous(), causal=True,
            window=40))
    assert form_launches() == {"prefill_wgmma": 0,
                               "prefill_simt": 4, "decode": 0}


def test_flash_bf16_misaligned_raises(card):
    """A bf16 operand the 16-byte copies cannot take raises; no other
    form runs in its place."""
    rng = np.random.RandomState(12)
    H, D = 4, 64
    wide = _randn(rng, (1, 32, H * D + 4), torch.bfloat16, card)
    q = wide[:, :, :H * D].unflatten(2, (H, D))       # s stride H*D + 4
    kv = _randn(rng, (1, 32, 1, D), torch.bfloat16, card)
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention(q, kv, kv)
    flat = _randn(rng, (32 * H * D + 1,), torch.bfloat16, card)
    q_off = flat[1:].view(1, 32, H, D)                 # 2 bytes off
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention(q_off, kv, kv)
    assert form_launches() == {"prefill_wgmma": 0,
                               "prefill_simt": 0, "decode": 0}
    assert registry.get_kernel("flash_attention").launches() == 0


DECODE_SKV = (1, 7, 32, 33, 100, 512, 1024, 1056)
DECODE_G = (1, 3, 4, 6, 7, 8, 12, 16)


@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 3e-2)])
def test_flash_decode_kernel_matches_plain(card, D, dtype, atol):
    """The split-KV decode form over one chunk and many (skv 1 .. 1056:
    up to 8 splits merged in a cluster, more by the merge kernel), GQA
    groups of 1, 3, 4, 6 and 8 query heads per kv head, 7, 12 and 16 (in
    f32, and in bf16 past 8 splits, head groups of 6 and 8 with a slot
    idle at 7; in bf16 up to 8 splits from g 6 on, all of a kv head's
    heads one mma kernel block), each on a contiguous cache and on a
    cache slice (a strided view, as the model passes it); one counted
    launch per call."""
    rng = np.random.RandomState(D)
    calls = 0
    for g in DECODE_G:
        Hkv = 2
        q = _randn(rng, (2, 1, g * Hkv, D), dtype, card)
        for skv in DECODE_SKV:
            cache = _randn(rng, (2, skv + 20, Hkv, D), dtype, card)
            vcache = _randn(rng, (2, skv + 20, Hkv, D), dtype, card)
            for k, v in ((cache[:, :skv].contiguous(),
                          vcache[:, :skv].contiguous()),
                         (cache[:, 13:13 + skv], vcache[:, 13:13 + skv])):
                out = flash_decode(q, k, v)
                torch.cuda.synchronize()
                calls += 1
                want = attention_ref(q, k, v, causal=False)
                assert out.dtype == dtype and out.shape == q.shape
                err = (out.float() - want).abs().max().item()
                assert err <= atol, (g, skv, err)
    assert registry.get_kernel("flash_attention").launches() == calls
    assert form_launches() == {"prefill_wgmma": 0,
                               "prefill_simt": 0, "decode": calls}


def _decode_kernels(fn):
    """The decode form's kernels (``kernel_form`` names) that the profiler
    saw over 3 calls of ``fn``."""
    return sorted(f for f in map(kernel_form, device_events(fn, 3)[1])
                  if f is not None)


def _allocations(fn) -> int:
    """The caching allocator's allocations in one call of ``fn``."""
    torch.cuda.synchronize()
    n0 = torch.cuda.memory_stats()["allocation.all.allocated"]
    fn()
    torch.cuda.synchronize()
    return torch.cuda.memory_stats()["allocation.all.allocated"] - n0


def test_flash_decode_head_group_matches_the_kernels_dispatch(card):
    """ops.decode_head_group, which the wrapper and tests read, against
    the split kernel's own choice (dec::head_group) for g 1 .. 96, and
    the most splits a cluster merges."""
    lib = _build.build_all(["flash_decode"])["flash_decode"].lib
    lib.flash_decode_head_group.argtypes = [ctypes.c_int]
    lib.flash_decode_head_group.restype = ctypes.c_int
    lib.flash_decode_max_cluster.restype = ctypes.c_int
    assert [lib.flash_decode_head_group(g) for g in range(1, 97)] == \
        [decode_head_group(g) for g in range(1, 97)]
    assert lib.flash_decode_max_cluster() == MAX_CLUSTER


@pytest.mark.parametrize("pairs", [16, 32])
@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 3e-2)])
def test_flash_decode_cluster_at_every_split(card, pairs, D, dtype, atol):
    """The cluster path at B*Hkv 16 and 32 (B 4, g 3) and every nsplit
    from 1 to 8: through flash_decode at 16 * n keys, where decode_split
    gives n splits of 16 at 16 pairs and caps 32 pairs at 5, then through
    decode_launch at n splits forced, over short chunks (37 keys: one
    tile) and long ones (150 keys: several tiles, the last short), on a
    contiguous cache and on a strided view of a longer one (the cluster
    kernel at every cluster size); one counted launch a call."""
    rng = np.random.RandomState(pairs + D)
    B, Hkv, g = 4, pairs // 4, 3
    q = _randn(rng, (B, 1, g * Hkv, D), dtype, card)
    calls = 0
    for n in range(1, MAX_CLUSTER + 1):
        splits = [(16 * n, None), (37 * n - 3, -(-(37 * n - 3) // n)),
                  (150 * n - 7, -(-(150 * n - 7) // n))]
        for skv, kc in splits:
            cache = _randn(rng, (B, skv + 9, Hkv, D), dtype, card)
            vcache = _randn(rng, (B, skv + 9, Hkv, D), dtype, card)
            for k, v in ((cache[:, :skv].contiguous(),
                          vcache[:, :skv].contiguous()),
                         (cache[:, 9:], vcache[:, 9:])):
                if kc is None:
                    assert decode_split(skv, B * Hkv)[1] == \
                        min(n, 5 if pairs == 32 else 8)
                    out = flash_decode(q, k, v)
                else:
                    out = decode_launch(q, k, v, kc, n)
                torch.cuda.synchronize()
                calls += 1
                want = attention_ref(q, k, v, causal=False)
                assert out.dtype == dtype and out.shape == q.shape
                err = (out.float() - want).abs().max().item()
                assert err <= atol, (n, skv, err)
    assert form_launches() == {"prefill_wgmma": 0,
                               "prefill_simt": 0, "decode": calls}


@pytest.mark.parametrize("keys", [160, 100])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 3e-2)])
def test_flash_decode_granite_is_one_kernel(card, keys, dtype, atol):
    """granite-moe-3b-a800m's serving decode (B 4, Hkv 8, g 3, D 64) over
    160 and 100 keys, on a contiguous cache and on a strided view of a
    longer one (the serving cache's first slots): 5 splits merged in a
    cluster, one kernel a call (the cluster kernel, no merge kernel), one
    allocation (out, no workspace)."""
    rng = np.random.RandomState(keys)
    B, Hkv, g, D = 4, 8, 3, 64
    q = _randn(rng, (B, 1, g * Hkv, D), dtype, card)
    cache = _randn(rng, (B, 176, Hkv, D), dtype, card)
    vcache = _randn(rng, (B, 176, Hkv, D), dtype, card)
    kc, nsplit = decode_split(keys, B * Hkv)
    assert nsplit == 5 and decode_cluster(nsplit)
    for k, v in ((cache[:, :keys].contiguous(),
                  vcache[:, :keys].contiguous()),
                 (cache[:, :keys], vcache[:, :keys])):
        err = (flash_decode(q, k, v).float()
               - attention_ref(q, k, v, causal=False)).abs().max().item()
        assert err <= atol
        assert _allocations(lambda: flash_decode(q, k, v)) == 1
        assert _decode_kernels(lambda: flash_decode(q, k, v)) == \
            ["decode_cluster"]


def test_flash_decode_kernel_matches_the_kernels_dispatch(card):
    """ops.decode_kernel, which the wrapper's callers and chip_smoke read,
    against the launcher's own choice (dec::decode_kernel, exported as
    flash_decode_kernel) for both types, g 1 .. 96 and nsplit 1 .. 132."""
    lib = _build.build_all(["flash_decode"])["flash_decode"].lib
    lib.flash_decode_kernel.argtypes = [ctypes.c_int] * 3
    lib.flash_decode_kernel.restype = ctypes.c_int
    for code, dtype in enumerate((torch.float32, torch.bfloat16)):
        got = [DECODE_KERNELS[lib.flash_decode_kernel(code, g, n)]
               for g in range(1, 97) for n in range(1, 133)]
        assert got == [decode_kernel(dtype, g, n)
                       for g in range(1, 97) for n in range(1, 133)]


# the wide groups' serving decodes: (Hkv, g) at B 4, D 128
WIDE_GROUPS = {"qwen2-vl": (4, 7), "qwen2-72b": (8, 8),
               "command-r-plus": (8, 12)}


@pytest.mark.parametrize("keys", [160, 100])
@pytest.mark.parametrize("arch", list(WIDE_GROUPS))
def test_flash_decode_wide_groups_are_one_kernel(card, arch, keys):
    """qwen2-vl-7b's (Hkv 4, g 7), qwen2-72b's and jamba's (8, 8) and
    command-r-plus-104b's (8, 12) serving decode in bf16 (B 4, D 128) over
    160 and 100 keys, on a contiguous cache and on a strided view of a
    longer one: the mma kernel alone (all of a kv head's query heads one
    block, no second head group, no merge kernel), one allocation (out),
    within 3e-2 of the plain version."""
    Hkv, g = WIDE_GROUPS[arch]
    rng = np.random.RandomState(keys + g)
    B, D = 4, 128
    q = _randn(rng, (B, 1, g * Hkv, D), torch.bfloat16, card)
    cache = _randn(rng, (B, 176, Hkv, D), torch.bfloat16, card)
    vcache = _randn(rng, (B, 176, Hkv, D), torch.bfloat16, card)
    kc, nsplit = decode_split(keys, B * Hkv)
    assert decode_kernel(torch.bfloat16, g, nsplit) == "decode_mma"
    for k, v in ((cache[:, :keys].contiguous(),
                  vcache[:, :keys].contiguous()),
                 (cache[:, :keys], vcache[:, :keys])):
        err = (flash_decode(q, k, v).float()
               - attention_ref(q, k, v, causal=False)).abs().max().item()
        assert err <= 3e-2
        assert _allocations(lambda: flash_decode(q, k, v)) == 1
        assert _decode_kernels(lambda: flash_decode(q, k, v)) == \
            ["decode_mma"]


@pytest.mark.parametrize("D", [64, 128, 256])
def test_flash_decode_mma_at_every_split(card, D):
    """The mma kernel at every nsplit from 1 to 8, forced through
    decode_launch over chunks of 37 keys (three groups of 16, the last
    short: one stage a warp) and of 150 (ten groups: two stages, a warp
    taking up to three), for g 7, 8, 12, 16 and 20 (two blocks of heads,
    the second of 4), on a contiguous cache and on a strided view of a
    longer one; bf16 within 3e-2 of the plain version, one counted launch
    a call."""
    rng = np.random.RandomState(D + 1)
    B, Hkv = 2, 2
    calls = 0
    for g in (7, 8, 12, 16, 20):
        q = _randn(rng, (B, 1, g * Hkv, D), torch.bfloat16, card)
        for n in range(1, MAX_CLUSTER + 1):
            assert decode_kernel(torch.bfloat16, g, n) == "decode_mma"
            for kc in (37, 150):
                skv = kc * n - 5 if n > 1 else kc
                cache = _randn(rng, (B, skv + 9, Hkv, D), torch.bfloat16,
                               card)
                vcache = _randn(rng, (B, skv + 9, Hkv, D), torch.bfloat16,
                                card)
                for k, v in ((cache[:, :skv].contiguous(),
                              vcache[:, :skv].contiguous()),
                             (cache[:, 9:], vcache[:, 9:])):
                    out = decode_launch(q, k, v, kc, n)
                    torch.cuda.synchronize()
                    calls += 1
                    want = attention_ref(q, k, v, causal=False)
                    assert out.dtype == torch.bfloat16
                    assert out.shape == q.shape
                    err = (out.float() - want).abs().max().item()
                    assert err <= 3e-2, (g, n, kc, err)
    assert form_launches() == {"prefill_wgmma": 0,
                               "prefill_simt": 0, "decode": calls}


def test_flash_decode_long_span_keeps_the_merge_kernel(card):
    """gemma3-1b's decode over its prompt's 1024 keys (B 4, H 4, Hkv 1,
    D 256, bf16): 32 splits, past a cluster, so the split kernel writes
    the workspace and the merge kernel follows (two allocations: out and
    the workspace; no cluster kernel), still one counted launch."""
    rng = np.random.RandomState(1024)
    q = _randn(rng, (4, 1, 4, 256), torch.bfloat16, card)
    k = _randn(rng, (4, 1024, 1, 256), torch.bfloat16, card)
    v = _randn(rng, (4, 1024, 1, 256), torch.bfloat16, card)
    assert decode_split(1024, 4) == (32, 32) and not decode_cluster(32)
    err = (flash_decode(q, k, v).float()
           - attention_ref(q, k, v, causal=False)).abs().max().item()
    assert err <= 3e-2
    assert _allocations(lambda: flash_decode(q, k, v)) == 2
    assert _decode_kernels(lambda: flash_decode(q, k, v)) == \
        ["decode_merge", "decode_split"]
    registry.reset_launch_counts()
    flash_decode(q, k, v)
    assert form_launches()["decode"] == 1


def _card_randn(gen, shape, dtype):
    """normal(0, 1) drawn on the card (numpy draws about 30 M normals a
    second: a minute for a 32k cache of 128 sequences)."""
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


# gemma3-1b's decode at the shape cells' spans (launch/cells.py): (B,
# keys, splits): decode_32k's global layers at B 64 (full caches) and
# B 128 (rolling window caches), a local layer's 512-slot rolling cache at
# B 128, long_500k's global layers at B 1
CELL_DECODES = [(64, 32768, 3), (128, 32768, 2), (128, 512, 2),
                (1, 524288, 132)]


@pytest.mark.parametrize("B,keys,nsplit", CELL_DECODES)
def test_flash_decode_at_the_cells_spans(card, B, keys, nsplit):
    """K4's bf16 decode (H 4, Hkv 1, D 256) over the cells' spans: the
    split decode_split picks, exactly the kernels decode_kernel names (the
    cluster kernel up to 8 splits, the split and merge kernels at 132),
    within 3e-2 of the plain version and within 1e-2 of its largest
    magnitude (``launch.cells.k4_limit``: the outputs spread about
    sqrt(e / keys), below 3e-2), one counted launch.  The same kernels
    over only the first half of the splits' chunks (at 3 splits, two of
    them), which is what a merge that lost the other partials returns,
    fail that hold."""
    from repro_torch.kernels.flash.ops import decode_launch
    from repro_torch.launch.cells import k4_limit
    gen = torch.Generator(device="cuda")
    gen.manual_seed(B + keys)
    q = _card_randn(gen, (B, 1, 4, 256), torch.bfloat16)
    k, v = (_card_randn(gen, (B, keys, 1, 256), torch.bfloat16)
            for _ in range(2))
    assert decode_split(keys, B)[1] == nsplit
    kern = decode_kernel(torch.bfloat16, 4, nsplit)
    want = attention_ref(q, k, v, causal=False)
    limit = k4_limit(want, 3e-2)
    err = (flash_decode(q, k, v).float() - want).abs().max().item()
    assert err <= limit, (err, limit)
    kc, keep = decode_split(keys, B)[0], nsplit - max(1, nsplit // 2)
    lost = decode_launch(q, k[:, :keep * kc], v[:, :keep * kc], kc, keep)
    assert (lost.float() - want).abs().max().item() > limit
    assert _decode_kernels(lambda: flash_decode(q, k, v)) == (
        ["decode_merge", "decode_split"] if kern == "decode_split"
        else [kern])
    registry.reset_launch_counts()
    flash_decode(q, k, v)
    assert form_launches()["decode"] == 1


@pytest.mark.parametrize("window", [512, None])
@pytest.mark.parametrize("dtype,atol,B", [(torch.bfloat16, 3e-2, 2),
                                          (torch.float32, 2e-5, 1)])
def test_flash_prefill_at_32k_on_row_windows(card, window, dtype, atol, B):
    """gemma3-1b's prefill at prefill_32k's S 32768 (H 4, Hkv 1, D 256),
    window 512 and causal, in bf16 (the wgmma form, its work list in
    chunks: K and V pass half the L2) and f32 (the SIMT form): one launch
    of the form, its first, middle and last 1024 rows against the plain
    version on those rows alone (launch.cells.plain_rows; the whole score
    matrix would be 17 GB a sequence), each within ``atol`` and within
    1e-2 of the plain rows' largest magnitude (``launch.cells.k4_limit``:
    past the first rows the outputs fall far below bf16's 3e-2)."""
    from repro_torch.kernels.flash.ops import wgmma_chunk, wgmma_grid
    from repro_torch.launch.cells import k4_limit, plain_rows
    S = 32768
    gen = torch.Generator(device="cuda")
    gen.manual_seed(S + (window or 0))
    q = _card_randn(gen, (B, S, 4, 256), dtype)
    k, v = (_card_randn(gen, (B, S, 1, 256), dtype) for _ in range(2))
    if dtype == torch.bfloat16:
        assert wgmma_chunk(B, 4, 1, S, S, 256, 256) == \
            2 * wgmma_grid(B, 4, S)
    out = flash_attention(q, k, v, causal=True, window=window)
    form = prefill_form(dtype, 256, 256)
    assert form_launches() == {f: int(f == form) for f in form_launches()}
    for lo in (0, S // 2 - 512, S - 1024):
        want = plain_rows(q, k, v, lo, lo + 1024, causal=True,
                          window=window)
        err = (out[:, lo:lo + 1024].float() - want).abs().max().item()
        assert err <= k4_limit(want, atol), (lo, err)


@pytest.mark.parametrize("window", [512, None])
def test_flash_prefill_lse_at_train_4k(card, window):
    """The wgmma form with its row log-sum-exp at train_4k's 4 x 4096
    (gemma3-1b's heads, bf16), the training path's call: out within 3e-2
    and the lse within 1e-4 of the plain version's."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4096 + (window or 0))
    q = _card_randn(gen, (4, 4096, 4, 256), torch.bfloat16)
    k, v = (_card_randn(gen, (4, 4096, 1, 256), torch.bfloat16)
            for _ in range(2))
    out, lse = flash_attention(q, k, v, causal=True, window=window,
                               return_lse=True)
    want, want_lse = attention_ref(q, k, v, causal=True, window=window,
                                   return_lse=True)
    assert (out.float() - want).abs().max().item() <= 3e-2
    assert (lse - want_lse).abs().max().item() <= 1e-4
    assert form_launches()["prefill_wgmma"] == 1


def test_flash_decode_misaligned_raises(card):
    """A decode operand whose rows the 16-byte loads cannot take raises
    and launches nothing: no other form runs in its place."""
    rng = np.random.RandomState(13)
    D = 128
    q = _randn(rng, (2, 1, 4, D), torch.float32, card)
    kv = _randn(rng, (2, 64, 1, D), torch.float32, card)
    wide = _randn(rng, (2, 64, 1, D + 2), torch.float32, card)
    flat = _randn(rng, (2 * 4 * D + 4,), torch.bfloat16, card)
    for args in ((q, wide[..., :D], kv),                 # s stride 520 B
                 (q, kv, wide[..., 2:]),                 # 8 bytes in
                 (flat[1:1 + 2 * 4 * D].view(2, 1, 4, D),  # 2 bytes in
                  kv.to(torch.bfloat16), kv.to(torch.bfloat16))):
        with pytest.raises(ValueError, match="decode form needs 16-byte"):
            flash_decode(*args)
    assert form_launches() == {"prefill_wgmma": 0,
                               "prefill_simt": 0, "decode": 0}
    assert registry.get_kernel("flash_attention").launches() == 0


@pytest.mark.parametrize("arch", ["gemma3-1b", "granite-moe-3b-a800m",
                                  "mamba2-1.3b", "deepseek-v2-236b",
                                  "jamba-1.5-large-398b", "gemma-2b",
                                  "musicgen-medium", "qwen2-vl-7b",
                                  "qwen2-72b", "command-r-plus-104b"])
def test_model_forwards_on_card_match_cpu(card, arch):
    """Every reduced family in f32 (head_dim 64, K4's smallest; MLA's
    16 + 16 is padded to 64; qwen2-vl's M-RoPE sections (8, 12, 12), its
    published (16, 24, 24) halved with the head dim; capacity factor 8,
    so no token drops): prefill_fn and the decode loop on the card against
    the same on the CPU, tokens or embedding frames, and K4's launches:
    one per attention layer per prefill_fn, and per GQA layer per decode
    step (MLA decodes in latent space)."""
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.models import build_forward, init_params
    from repro_torch.models.model import zero_cache
    cfg = reduced(ARCHS[arch]).replace(
        dtype="float32", head_dim=64, attn_impl="blocked",
        moe_capacity_factor=8.0)
    if cfg.mrope_sections:
        cfg = cfg.replace(mrope_sections=(8, 12, 12))
    B, S = 2, 12
    rng = np.random.RandomState(1)
    if cfg.input_mode == "tokens":
        x = torch.from_numpy(rng.randint(2, cfg.vocab, (B, S)))
    else:
        x = torch.from_numpy(rng.randn(B, S, cfg.d_model).astype(
            np.float32) * 0.3)
    pos = (3, B) if cfg.mrope_sections else (B,)
    got = {}
    for dev in ("cuda", "cpu"):
        params = init_params(cfg, 0, dev)
        _, prefill_fn, decode_fn = build_forward(cfg)
        t = x.to(dev)
        full = prefill_fn(params, {"tokens": t, "positions": torch.arange(
            S, device=dev).expand(*pos, S)})
        cache = zero_cache(cfg, B, S, dev)
        for i in range(S):
            step, cache = decode_fn(params, cache, {
                "tokens": t[:, i:i + 1],
                "positions": torch.full((*pos, 1), i, device=dev)}, index=i)
        got[dev] = (full.cpu(), step.cpu())
    for a, b in zip(got["cuda"], got["cpu"]):
        assert torch.allclose(a, b, atol=2e-4, rtol=1e-4)
    n_attn = sum(cfg.layer_kind(i) == "attn" for i in range(cfg.n_layers))
    n_decode = 0 if cfg.mla else n_attn * S
    assert form_launches() == {"prefill_wgmma": 0,
                               "prefill_simt": n_attn, "decode": n_decode}
    assert registry.get_kernel("flash_attention").launches() == \
        n_attn + n_decode


# ---- the training path: K4's log-sum-exp, the attention gradient, and a
# train step of every reduced arch ----

# (B, Sq, Skv, H, Hkv, D, window): gemma3-1b's local and global layers,
# granite's D 64 and g 3, a ragged Sq with a window, and rows 25.. of Sq 40
# with no key of Skv 20 in their band (window 6)
LSE_CASES = [(2, 1024, 1024, 4, 1, 256, 512), (2, 1024, 1024, 4, 1, 256, None),
             (2, 256, 256, 24, 8, 64, None), (1, 200, 200, 4, 1, 64, 70),
             (2, 40, 20, 4, 2, 64, 6)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,D,window", LSE_CASES)
def test_flash_lse_matches_plain(card, B, Sq, Skv, H, Hkv, D, window,
                                 dtype):
    """Both prefill forms' row log-sum-exp against attention_ref's, within
    1e-4 (f32 sums of up to 1024 exponentials; bf16 products are exact in
    f32, so the bf16 form's scores are the plain version's up to the order
    of the sum), and the output as without it."""
    rng = np.random.RandomState(Sq + D)
    q = _randn(rng, (B, Sq, H, D), dtype, card)
    k = _randn(rng, (B, Skv, Hkv, D), dtype, card)
    v = _randn(rng, (B, Skv, Hkv, D), dtype, card)
    out, lse = flash_attention(q, k, v, causal=True, window=window,
                               return_lse=True)
    plain = flash_attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    want_out, want = attention_ref(q, k, v, causal=True, window=window,
                                   return_lse=True)
    assert lse.shape == (B, H, Sq) and lse.dtype == torch.float32
    assert (lse - want).abs().max().item() <= 1e-4
    assert torch.equal(out, plain)
    assert form_launches()[prefill_form(dtype, D, D)] == 2


# a context-parallel rank's rows: Sq rows at q_offset, against keys up to
# and past their last position (D 256: MLA's padded head dim)
OFFSET_CASES = [(2, 256, 1024, 4, 1, 256, 768, None),
                (2, 256, 1024, 4, 1, 256, 512, 300),
                (1, 200, 400, 8, 2, 64, 200, 70),
                (2, 40, 100, 4, 2, 128, 61, 6)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,D,q_offset,window", OFFSET_CASES)
def test_flash_q_offset_matches_plain(card, B, Sq, Skv, H, Hkv, D, q_offset,
                                      window, dtype):
    """Both prefill forms with query row i at position i + q_offset (the
    causal and window bands shifted, tiles outside them skipped): the
    output (atol 2e-5 in f32, 3e-2 in bf16) and the row log-sum-exp
    (1e-4) against attention_ref at the same offset."""
    rng = np.random.RandomState(Sq + q_offset + D)
    q = _randn(rng, (B, Sq, H, D), dtype, card)
    k = _randn(rng, (B, Skv, Hkv, D), dtype, card)
    v = _randn(rng, (B, Skv, Hkv, D), dtype, card)
    out, lse = flash_attention(q, k, v, causal=True, window=window,
                               q_offset=q_offset, return_lse=True)
    torch.cuda.synchronize()
    want_out, want = attention_ref(q, k, v, causal=True, window=window,
                                   q_offset=q_offset, return_lse=True)
    atol = 2e-5 if dtype == torch.float32 else 3e-2
    assert (out.float() - want_out).abs().max().item() <= atol
    assert (lse - want).abs().max().item() <= 1e-4
    assert form_launches()[prefill_form(dtype, D, D)] == 1


def _attn_grads(q, k, v, do, fn):
    ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
    fn(*ts).backward(do)
    return [t.grad for t in ts]


# (B, S, H, Hkv, Dk, Dv, window, scale): gemma3-1b's local and global
# layers, granite's GQA, and MLA's q, k at 192 and v at 128 zero-padded to
# 256 (16 of its 128 heads)
GRAD_CASES = {"gemma3_local": (2, 1024, 4, 1, 256, 256, 512, None),
              "gemma3_global": (2, 1024, 4, 1, 256, 256, None, None),
              "granite": (2, 512, 24, 8, 64, 64, None, None),
              "mla_padded": (2, 256, 16, 16, 192, 128, None, 192 ** -0.5)}


@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_attention_function_on_card_matches_autograd_of_plain(card, case,
                                                              dtype, rel):
    """FlashAttention (K4 with its lse, the block-recompute backward) on
    the card against autograd through attention_ref on the card, on the
    unpadded operands; each gradient within ``rel`` of its largest (f32:
    sums in another order; bf16: K4 rounds p to bf16 before p . v and out
    to bf16, which the backward's sum(do * out) reads, and every gradient
    is rounded to bf16)."""
    from repro_torch.models.layers import FlashAttention
    B, S, H, Hkv, dk, dv, window, scale = GRAD_CASES[case]
    rng = np.random.RandomState(S + H)
    q = _randn(rng, (B, S, H, dk), dtype, card)
    k = _randn(rng, (B, S, Hkv, dk), dtype, card)
    v = _randn(rng, (B, S, Hkv, dv), dtype, card)
    do = _randn(rng, (B, S, H, dv), dtype, card)
    torch.backends.cuda.matmul.allow_tf32 = False
    dp = 256 if dk > 128 or dv != dk else dk

    def k4(a, b, c):
        pads = [torch.nn.functional.pad(t, (0, dp - t.shape[-1]))
                for t in (a, b, c)]
        return FlashAttention.apply(*pads, True, window, scale,
                                    1024)[..., :dv]

    def plain(a, b, c):
        return attention_ref(a, b, c, causal=True, window=window,
                             scale=scale).to(dtype)

    got = _attn_grads(q, k, v, do, k4)
    want = _attn_grads(q, k, v, do, plain)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == dtype
        err = (g.float() - w.float()).abs().max().item()
        assert err <= rel * w.float().abs().max().item(), err
    assert form_launches()[prefill_form(dtype, dp, dp)] == 1


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_train_step_on_card_matches_cpu(card, arch):
    """One train step of the reduced arch in f32 (head_dim 64, K4's
    smallest; MLA's 16 + 16 padded to 64; capacity factor 8, so no token
    drops; M-RoPE's sections widened to match) on the card against the
    same on the CPU: the loss within 1e-5,
    the gradient norm within 1e-5 relative, each gradient leaf within 1e-4
    of its largest, and K4's SIMT form once per attention layer in the
    step (reduced configs take no remat)."""
    from repro_torch.configs import reduced
    from repro_torch.models import build_forward, init_params
    from repro_torch.models.model import tree_leaves
    from repro_torch.optim import adamw_init
    from repro_torch.train import build_train_step, value_and_grad
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced(ARCHS[arch]).replace(
        dtype="float32", head_dim=64, attn_impl="blocked",
        moe_capacity_factor=8.0)
    if cfg.mrope_sections:      # M-RoPE's sections cover head_dim / 2
        cfg = cfg.replace(mrope_sections=(16, 8, 8))
    B, S = 2, 16
    rng = np.random.RandomState(5)
    if cfg.input_mode == "tokens":
        toks = rng.randint(2, cfg.vocab, (B, S)).astype(np.int32)
    else:
        toks = (rng.randn(B, S, cfg.d_model) * 0.3).astype(np.float32)
    batch = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(
        rng.randint(2, cfg.vocab, (B, S)).astype(np.int32))}
    if cfg.mrope_sections:
        batch["positions"] = torch.arange(S, dtype=torch.int32)[
            None, None].expand(3, B, S).contiguous()
    got = {}
    for dev in ("cuda", "cpu"):
        params = init_params(cfg, 0, dev)
        b = {k: v.to(dev) for k, v in batch.items()}
        registry.reset_launch_counts()
        _, _, m = build_train_step(cfg)(params, adamw_init(params), b)
        launches = form_launches()
        _, grads = value_and_grad(build_forward(cfg)[0], params, b)
        got[dev] = (float(m["loss"]), float(m["gnorm"]),
                    [g.cpu() for g in tree_leaves(grads)], launches)
    (l1, n1, g1, k1), (l2, n2, g2, _) = got["cuda"], got["cpu"]
    assert abs(l1 - l2) <= 1e-5 and abs(n1 - n2) <= 1e-5 * n2
    for a, b in zip(g1, g2):
        assert (a - b).abs().max().item() <= 1e-4 * b.abs().max().item() \
            + 1e-12
    n_attn = sum(cfg.layer_kind(i) == "attn" for i in range(cfg.n_layers))
    assert k1 == {"prefill_wgmma": 0, "prefill_simt": n_attn,
                  "decode": 0}


def test_async_save_reuses_its_pinned_buffers(card, tmp_path):
    """A second async save of card tensors copies into the first's pinned
    buffers (a leaf of another shape gets a new one), and each checkpoint
    holds the values of its own save."""
    from repro_torch.checkpoint import ckpt
    tree = {"w": torch.arange(6, dtype=torch.float32, device="cuda"),
            "b": torch.ones(3, dtype=torch.bfloat16, device="cuda")}
    ckpt.async_save(str(tmp_path), 1, tree)
    first = list(ckpt._pinned)
    assert len(first) == 2 and all(b.is_pinned() for b in first)
    tree["w"].add_(100.0)
    ckpt.async_save(str(tmp_path), 2, tree)
    assert [b.data_ptr() for b in ckpt._pinned] == \
        [b.data_ptr() for b in first]
    tree["b"] = torch.zeros(5, dtype=torch.bfloat16, device="cuda")
    ckpt.async_save(str(tmp_path), 3, tree)
    ckpt.wait_for_save()
    kept = {b.data_ptr() for b in first}
    assert [b.data_ptr() in kept for b in ckpt._pinned] == [True, False]
    w0 = torch.arange(6, dtype=torch.float32)
    old = {"w": w0, "b": torch.ones(3, dtype=torch.bfloat16)}
    back = [ckpt.restore_checkpoint(str(tmp_path), s, t, device="cpu")
            for s, t in ((1, old), (2, old), (3, tree))]
    assert torch.equal(back[0]["w"], w0)
    assert torch.equal(back[1]["w"], w0 + 100.0)
    assert torch.equal(back[1]["b"], old["b"])
    assert torch.equal(back[2]["b"], torch.zeros(5, dtype=torch.bfloat16))


# ---- the cycle kernel (csrc/cyclesim.cu) against its plain version ----


def _sim_fields(res):
    """Every SimResult field but the engine's name."""
    import dataclasses
    d = dataclasses.asdict(res)
    d.pop("engine")
    return d


def _cycle_design(app, **kw):
    from repro_torch.apps import SIM_CASES
    uf, T, _ = SIM_CASES[app](**kw)
    return compile_pipeline(uf, T=T)


def _kernel_and_plain(d, depths=None, frames=1, unbounded=False, **run):
    from repro_torch.hwsim import VectorSim
    depths = dict(d.fifo.depth) if depths is None else depths
    out = [VectorSim(d.modules, d.edges, depths, unbounded=unbounded,
                     frames=frames, device=dev).run(**run)
           for dev in ("cuda", "cpu")]
    assert registry.get_kernel("cyclesim").launches() == 1
    return out


@pytest.mark.parametrize("max_cycles", [1, 40, 343, 345])
def test_cycle_kernel_first_cycles_before_leff(card, max_cycles):
    """FLOW's latencies reach 344: the horizon cuts the run while
    (t - leff) % H is negative in C, so the ring is read through the
    positive modulo."""
    got, want = _kernel_and_plain(_cycle_design("flow"),
                                  max_cycles=max_cycles)
    assert got.deadlock == f"horizon exceeded ({max_cycles} cycles)"
    assert _sim_fields(got) == _sim_fields(want)


@pytest.mark.parametrize("event_jump", [True, False])
def test_cycle_kernel_pyramid_deadlock(card, event_jump):
    d = _cycle_design("pyramid")
    depths = dict(d.fifo.depth)
    depths[(6, 1)] = 0
    got, want = _kernel_and_plain(d, depths, event_jump=event_jump)
    assert got.deadlock is not None and "blocked on full" in got.deadlock
    assert _sim_fields(got) == _sim_fields(want)
    assert (got.cycles_saved > 0) == event_jump


def test_cycle_kernel_horizon_on_frame_boundary(card):
    d = _cycle_design("convolution", w=48, h=20)
    full, _ = _kernel_and_plain(d, frames=2)
    registry.reset_launch_counts()
    horizon = full.frame_ends[0] + 1
    got, want = _kernel_and_plain(d, frames=2, max_cycles=horizon)
    assert got.frame_ends == [full.frame_ends[0]]
    assert _sim_fields(got) == _sim_fields(want)


@pytest.mark.parametrize("app,frames,unbounded", [
    ("flow", 2, False), ("pyramid", 2, False), ("flow", 1, True)])
def test_cycle_kernel_event_jump_off(card, app, frames, unbounded):
    d = _cycle_design(app)
    got, want = _kernel_and_plain(d, {} if unbounded else None,
                                  frames=frames, unbounded=unbounded,
                                  event_jump=False)
    assert got.cycles_skipped == 0
    assert _sim_fields(got) == _sim_fields(want)


def test_cycle_kernel_block_stride_chain(card):
    """A chain of 300 Maps (E 299, M 300) exceeds the block's 256 threads,
    so modules and edges loop with a block stride; every third module is
    throttled to rate 1/2 or 2/3, latencies 0-6, depths 0-2."""
    from fractions import Fraction
    from repro_torch.core.buffers import Edge
    from repro_torch.core.dtypes import UInt
    from repro_torch.core.rigel import Interface, RModule, ScheduleType
    from repro_torch.kernels.cyclesim.ops import threads_for
    st = ScheduleType(UInt(8), 48, 1)
    rates = (Fraction(1), Fraction(1, 2), Fraction(1), Fraction(2, 3))
    mods = [RModule(f"m{i}", "Map", Interface("Static", st),
                    Interface("Static", st), rates[i % 4], i % 7)
            for i in range(300)]
    edges = [Edge(i, i + 1, 8, i % 7, 0) for i in range(299)]
    depths = {(i, i + 1): i % 3 for i in range(299)}
    assert threads_for(len(mods), len(edges)) < len(edges)
    from repro_torch.hwsim import VectorSim
    got, want = [VectorSim(mods, edges, depths, frames=2, device=dev).run()
                 for dev in ("cuda", "cpu")]
    assert got.deadlock is None and got.sink_tokens == 96
    assert _sim_fields(got) == _sim_fields(want)


@pytest.mark.parametrize("event_jump", [True, False])
def test_cycle_kernel_hand_set_need_table_stalls(card, event_jump):
    """A need table set by hand (need(k) = k, more than the producer ever
    makes) ships whole to the kernel: the same stall, diagnosis and
    counts as the plain version."""
    from fractions import Fraction
    from repro_torch.core.buffers import Edge
    from repro_torch.core.dtypes import UInt
    from repro_torch.core.rigel import Interface, RModule, ScheduleType
    from repro_torch.hwsim import VectorSim

    def mod(name, total):
        st = ScheduleType(UInt(8), total, 1)
        return RModule(name, "Map", Interface("Static", st),
                       Interface("Static", st), Fraction(1), 0)

    runs = []
    for dev in ("cuda", "cpu"):
        vs = VectorSim([mod("src", 5), mod("snk", 10)],
                       [Edge(0, 1, 8, 0, 0)], {(0, 1): 3}, device=dev)
        vs.need_buf = np.arange(1, 11, dtype=np.int64)
        runs.append(vs.run(event_jump=event_jump))
    got, want = runs
    assert "starved" in got.deadlock and got.sink_tokens == 5
    assert _sim_fields(got) == _sim_fields(want)


def _chain_kernel_and_plain(mods, edges, depths, frames=1, **run):
    from repro_torch.hwsim import VectorSim
    out = [VectorSim(mods, edges, depths, frames=frames, device=dev).run(
        **run) for dev in ("cuda", "cpu")]
    assert registry.get_kernel("cyclesim").launches() == 1
    return out


@pytest.mark.parametrize("event_jump", [True, False])
def test_cycle_kernel_ring_word_edges(card, event_jump):
    """Latencies 63, 64 and 65: rings of 64, 65 and 66 bits, a whole
    64-bit word and one or two bits past it, with plateaus the event jump
    leaps (throttled modules, 4 tokens a frame, 2 frames)."""
    from fractions import Fraction
    mods, edges, depths = map_chain((63, 64, 65, 0, 63, 64, 65, 1), total=4,
                                    rates=(Fraction(1), Fraction(1, 2)))
    got, want = _chain_kernel_and_plain(mods, edges, depths, frames=2,
                                        event_jump=event_jump)
    assert got.deadlock is None and got.sink_tokens == 8
    assert (got.cycles_skipped > 0) == event_jump
    assert _sim_fields(got) == _sim_fields(want)


@pytest.mark.parametrize("latency", [63, 64, 65, 100])
def test_cycle_kernel_jump_across_ring_wrap(card, latency):
    """One token, launched at cycle 1 by a module of the given latency: the
    jump from cycle 3 finds its maturation past the ring's end (its bit at
    position 1, the search starting at 4) and lands on it."""
    mods, edges, depths = map_chain((0, latency, 0), total=1)
    got, want = _chain_kernel_and_plain(mods, edges, depths)
    assert got.cycles_skipped == latency - 2 and got.deadlock is None
    assert _sim_fields(got) == _sim_fields(want)


@pytest.mark.parametrize("latency", [1, 3, 64])
def test_cycle_kernel_blocked_producer_long_jumps(card, latency):
    """A consumer throttled to rate 1/50 behind a depth-0 FIFO keeps its
    producer blocked with matured launches while the event jump leaps
    ~50 cycles at a time, longer than the producer's latency: each
    matured launch is counted once (8 tokens pushed, not 9)."""
    from fractions import Fraction
    mods, edges, depths = map_chain(
        (0, latency, 0), total=8, depth=1,
        rates=(Fraction(1), Fraction(1), Fraction(1, 50)))
    got, want = _chain_kernel_and_plain(mods, edges, depths)
    assert got.cycles_skipped > 300 and got.sink_tokens == 8
    assert _sim_fields(got) == _sim_fields(want)


def test_cycle_kernel_wide_counters(card):
    """2**16 tokens a frame over 2**15 + 1 frames: a module's count
    passes int32, so the warp form takes its 64-bit counters (every other
    card case counts in 32 bits); the horizon cuts the run."""
    from fractions import Fraction
    from repro_torch.hwsim import VectorSim
    from repro_torch.kernels.cyclesim import ops
    mods, edges, depths = map_chain((0, 2, 0, 1), total=2 ** 16,
                                    rates=(Fraction(1), Fraction(1, 2)))
    frames = 2 ** 15 + 1
    lay = ops.layout(VectorSim(mods, edges, depths, frames=frames,
                               device="cpu"))
    assert (lay["form"], lay["counters"]) == ("warp", 64)
    got, want = _chain_kernel_and_plain(mods, edges, depths, frames=frames,
                                        max_cycles=300)
    assert got.deadlock == "horizon exceeded (300 cycles)"
    assert _sim_fields(got) == _sim_fields(want)


def test_cycle_kernel_global_ring(card):
    """A latency of 1.9 M cycles needs a 1.9 M-bit ring, past the block's
    shared memory: the wrapper puts the rings in global memory.  The
    horizon cuts the run while the tokens drain."""
    from repro_torch.hwsim import VectorSim
    from repro_torch.kernels.cyclesim import ops
    latency = 1_900_000
    mods, edges, depths = map_chain((0, latency, 0), total=8)
    assert ops.layout(VectorSim(mods, edges, depths, device="cpu"))[
        "ring"] == "global"
    got, want = _chain_kernel_and_plain(mods, edges, depths,
                                        max_cycles=latency + 6)
    assert got.deadlock == f"horizon exceeded ({latency + 6} cycles)"
    assert 0 < got.sink_tokens < 8
    assert _sim_fields(got) == _sim_fields(want)


def test_cycle_kernel_warp_form_equals_block_form_on_flow(card):
    """FLOW's sim_case (58 modules, 73 edges), 2 frames, in both forms of
    the kernel: the same state, frame ends and stop code, and the plain
    version's."""
    import torch
    from repro_torch.hwsim import VectorSim
    from repro_torch.kernels.cyclesim import ops
    d = _cycle_design("flow")
    vs = VectorSim(d.modules, d.edges, dict(d.fifo.depth), frames=2)
    assert ops.layout(vs)["form"] == "warp"
    caps = torch.from_numpy(vs.cap[None].copy()).cuda()
    horizon, stall = vs._default_horizon(), vs._stall_limit()
    runs = {form: ops.run_kernel(vs, caps, horizon, stall, form=form)[0]
            for form in ("warp", "block")}
    from repro_torch.kernels import _build
    assert _build.launch_count("cyclesim:warp") == 1
    assert _build.launch_count("cyclesim:block") == 1
    want = vs.with_caps(vs.cap)._run_plain(horizon, stall)
    for form, (s, fe, code) in runs.items():
        assert (fe, code) == (want[1], want[2]), form
        assert s.keys() == want[0].keys()
        for key, v in want[0].items():
            assert np.array_equal(s[key], v), (form, key)


def test_cycle_kernel_population_equals_single_runs(card):
    """K = 16 designs in one launch against 16 launches of K = 1, and the
    first few against the plain version."""
    from repro_torch.hwsim import PopulationSim, VectorSim
    d = _cycle_design("pyramid")
    ana = dict(d.fifo.depth)
    sets = [{k: int(round(v * f)) for k, v in ana.items()}
            for f in np.linspace(0.0, 2.0, 16)]
    pop = PopulationSim(d.modules, d.edges, sets, frames=2).run()
    assert registry.get_kernel("cyclesim").launches() == 1
    singles = [VectorSim(d.modules, d.edges, ds, frames=2).run()
               for ds in sets]
    assert registry.get_kernel("cyclesim").launches() == 17
    assert any(r.deadlock for r in pop) and any(not r.deadlock for r in pop)
    for p, s in zip(pop, singles):
        assert p.engine == "population" and s.engine == "vector"
        assert _sim_fields(p) == _sim_fields(s)
    plain = PopulationSim(d.modules, d.edges, sets[:4], frames=2,
                          device="cpu").run()
    for p, s in zip(pop, plain):
        assert _sim_fields(p) == _sim_fields(s)


# ---- the static verifier's oracle and the frame server on the card ----


@pytest.mark.parametrize("app", ["convolution", "descriptor", "flow",
                                 "pyramid", "stereo"])
def test_cross_check_on_card_equals_scalar_engine(card, app):
    """``verify``'s three-way oracle on the cycle kernel (the default on
    the card) against the scalar engine (``device="cpu"``): the same
    marks, bounds and verdict, in one launch."""
    from repro_torch import SimOptions
    from repro_torch.analysis import cross_check
    d = _cycle_design(app)
    res = d.verify()
    assert registry.get_kernel("cyclesim").launches() == 1
    assert res.ok and res.cross.engine == "vector"
    host = cross_check(d, device="cpu")
    assert host.engine == "scalar"
    for key in ("hwm", "lower", "upper", "violations", "completed"):
        assert getattr(res.cross, key) == getattr(host, key), key
    assert d.verify(options=SimOptions(device="cpu")).report_lines()[1:] \
        == [ln.replace("engine=vector", "engine=scalar")
            for ln in res.report_lines()[1:]]


def _serve_frames(inputs, n, base=0):
    return [inputs(np.random.RandomState(base + i)) for i in range(n)]


def _stack_frames(frames):
    def st(vals):
        if isinstance(vals[0], tuple):
            return tuple(st([v[i] for v in vals])
                         for i in range(len(vals[0])))
        return np.stack(vals)
    return {k: st([f[k] for f in frames]) for k in frames[0]}


def _frame_of(out, i):
    return tuple(_frame_of(e, i) for e in out) \
        if isinstance(out, tuple) else out[i]


def test_served_round_trip_on_card_bit_exact(card):
    """Every app served on the card: each frame equal to ``run_batch`` of
    the same frames on the card and on the CPU, with K1, K2 and K3 each
    launched by the served traffic."""
    from repro_torch.serve import FrameServer, ServeConfig
    designs = {}
    srv = FrameServer(ServeConfig(max_batch=4, max_delay_ms=5.0))
    try:
        for app, case in sorted(BENCH_CASES.items()):
            uf, inputs = case()
            designs[app] = (compile_pipeline(uf), inputs)
            srv.register(designs[app][0], name=app,
                         warm_inputs=_serve_frames(inputs, 1, 50))
        srv.start()
        registry.reset_launch_counts()
        sent = [(app, fr, srv.submit(fr, app=app))
                for i in range(6) for app, (_d, inputs) in designs.items()
                for fr in _serve_frames(inputs, 1, 10 * i)]
        outs = [(app, fr, f.result(timeout=300)) for app, fr, f in sent]
    finally:
        srv.close(timeout=300)
    for name in ("conv2d", "sad", "megakernel"):
        assert registry.get_kernel(name).launches() > 0, name
    for app, (d, _inputs) in designs.items():
        mine = [(fr, out) for a, fr, out in outs if a == app]
        batch = _stack_frames([fr for fr, _ in mine])
        on_card = d.run_batch(batch)
        on_cpu = d.run_batch(batch, device="cpu")
        for i, (_fr, out) in enumerate(mine):
            _same(out, _frame_of(on_card, i))
            _same(out, _frame_of(on_cpu, i))
    assert srv.stats.frames_out == 6 * len(designs)


def test_back_to_back_batches_read_back_their_own_frames(card):
    """Three batches on one dispatcher before any readback (the third
    reuses the first one's pinned slot), read back last first: each
    equal to ``run_batch`` of its own frames."""
    from repro_torch.serve import BatchDispatcher, FrameRequest
    from repro_torch.serve import frame_signature
    uf, inputs = BENCH_CASES["flow"]()
    d = compile_pipeline(uf)
    disp = BatchDispatcher([d.lower("kernels")], depth=2)
    batches = [_serve_frames(inputs, 4, 100 * k) for k in range(3)]
    handles = [disp.submit([FrameRequest("flow", f, frame_signature(f), 0.0)
                            for f in frames]) for frames in batches]
    for frames, h in reversed(list(zip(batches, handles))):
        want = d.run_batch(_stack_frames(frames), device="cpu")
        for i, out in enumerate(h.wait()):
            _same(out, _frame_of(want, i))
    assert registry.get_kernel("megakernel").launches() == 3


def test_read_back_runs_on_its_own_streams(card):
    """Each slot reads back on a stream of its own, not the compute
    stream, into page-locked buffers; what a read returns is the
    caller's: the slot's next read leaves it as it was."""
    from repro_torch.serve import BatchDispatcher, FrameRequest
    from repro_torch.serve import frame_signature
    uf, inputs = BENCH_CASES["convolution"]()
    d = compile_pipeline(uf)
    disp = BatchDispatcher([d.lower("kernels")], depth=2)
    (compute,), (slots,) = disp._streams, disp._readback
    streams = [st for st, _bufs in slots] + [compute]
    assert len({st.cuda_stream for st in streams}) == 3
    batches = [_serve_frames(inputs, 3, 100 * k) for k in range(3)]
    first = disp.submit([FrameRequest("conv", f, frame_signature(f), 0.0)
                         for f in batches[0]]).wait()
    kept = copy.deepcopy(first)
    disp.submit([FrameRequest("conv", f, frame_signature(f), 0.0)
                 for f in batches[1]]).wait()
    third = disp.submit([FrameRequest("conv", f, frame_signature(f), 0.0)
                         for f in batches[2]]).wait()
    for _st, bufs in slots:
        assert bufs and all(b.is_pinned() for b in bufs.values())
    for k, outs in ((0, first), (2, third)):
        want = d.run_batch(_stack_frames(batches[k]), device="cpu")
        for i, out in enumerate(outs):
            _same(out, _frame_of(want, i))
    for a, b in zip(first, kept):
        _same(a, b)


def test_moe_a2a_through_nccl_matches_moe_ffn(card):
    """moe_ffn_a2a on the card through a one-rank NCCL process group and a
    (1, 1) mesh (its all-to-alls and local_map at size 1), reduced granite
    in f32 at capacity factor 8: the loss and every gradient leaf of
    build_forward with the mesh against moe_ffn without it, at the
    reference test's rtol 1e-5 / atol 1e-4."""
    import socket
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import reduced
    from repro_torch.models import build_forward, init_params
    from repro_torch.models.model import tree_leaves
    from repro_torch.parallel import collective_bytes
    from repro_torch.train import value_and_grad
    torch.backends.cuda.matmul.allow_tf32 = False
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        cfg = reduced(ARCHS["granite-moe-3b-a800m"]).replace(
            dtype="float32", head_dim=64, attn_impl="blocked",
            moe_capacity_factor=8.0)
        params = init_params(cfg, 0, "cuda")
        rng = np.random.RandomState(0)
        batch = {k: torch.from_numpy(rng.randint(2, cfg.vocab, (4, 16))
                                     .astype(np.int32)).cuda()
                 for k in ("tokens", "labels")}
        la, ga = value_and_grad(build_forward(cfg)[0], params, batch)
        with collective_bytes() as rec:
            lb, gb = value_and_grad(build_forward(
                cfg.replace(moe_impl="a2a"), mesh=mesh)[0], params, batch)
            torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    assert rec.calls.get("all-to-all") == 5 * cfg.n_layers
    np.testing.assert_allclose(float(lb), float(la), rtol=1e-5)
    for a, b in zip(tree_leaves(gb), tree_leaves(ga)):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   rtol=1e-5, atol=1e-4)
