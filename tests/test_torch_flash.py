"""The port's flash attention (repro_torch.kernels.flash, K4) against the
reference's (repro.kernels.flash): on the CPU a wrapper takes its plain
version, which is held against the Pallas kernel (interpret mode, as
tests/test_kernels.py runs it) and the reference's oracle on the same
numpy-seeded inputs, at tests/test_kernels.py's tolerances: atol 2e-5 in
f32, 3e-2 in bf16 (the bf16 outputs round to bf16, and the Pallas kernel
rounds p to bf16 before p . v).

test_torch_card.py holds K4 itself against the plain version on the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash.ops import flash_attention_tpu, flash_decode_tpu  # noqa: E402
from repro.kernels.flash.ref import attention_ref as jax_attention_ref  # noqa: E402
from repro_torch.kernels.flash import flash_attention, flash_decode  # noqa: E402
from repro_torch.kernels.flash.ref import attention_ref  # noqa: E402

_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_JAX = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
ATOL = {"float32": 2e-5, "bfloat16": 3e-2}

# tests/test_kernels.py's four coverage classes: GQA f32, windowed bf16,
# MHA D=256 f32, ragged bf16 (40 rows, no multiple of its 16-row tiles);
# then f32 at D 256 with a window at a ragged Sq, and GQA with g 4 at a
# ragged Sq (the card's SIMT form takes 64-row q and 32-key tiles); then
# the wgmma form's groups in bf16 at a reduced size: qwen2-vl's g 7 at D
# 128 and gemma-2b's g 8 (MQA) at D 256, ragged and windowed
CLASSES = [
    (2, 48, 4, 2, 128, None, "float32"),
    (2, 48, 4, 4, 128, 13, "bfloat16"),
    (1, 64, 8, 2, 256, None, "float32"),
    (1, 40, 4, 1, 128, None, "bfloat16"),
    (1, 200, 4, 1, 256, 70, "float32"),
    (2, 130, 8, 2, 256, None, "float32"),
    (1, 40, 14, 2, 128, None, "bfloat16"),
    (1, 72, 8, 1, 256, 30, "bfloat16"),
]


def _inputs(seed, B, Sq, Skv, H, Hkv, D, dtype):
    """q, k, v drawn with numpy, rounded to ``dtype`` by JAX, and the same
    bits as torch tensors."""
    rng = np.random.RandomState(seed)
    arrays = [jnp.asarray(rng.randn(B, S, h, D), _JAX[dtype])
              for S, h in ((Sq, H), (Skv, Hkv), (Skv, Hkv))]
    tensors = [torch.from_numpy(np.array(a, np.float32)).to(_TORCH[dtype])
               for a in arrays]
    return arrays, tensors


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


@pytest.mark.parametrize("B,S,H,Hkv,D,window,dtype", CLASSES)
def test_flash_attention_matches_reference(B, S, H, Hkv, D, window, dtype):
    (jq, jk, jv), (q, k, v) = _inputs(S + D, B, S, S, H, Hkv, D, dtype)
    out = flash_attention(q, k, v, causal=True, window=window)
    assert out.shape == (B, S, H, D) and out.dtype == _TORCH[dtype]
    pallas = flash_attention_tpu(jq, jk, jv, causal=True, window=window,
                                 bq=16, bk=16)
    oracle = jax_attention_ref(jq, jk, jv, causal=True, window=window)
    assert np.allclose(_f32(out), _f32(pallas), atol=ATOL[dtype])
    assert np.allclose(_f32(out), _f32(oracle), atol=ATOL[dtype])
    # the plain version itself returns f32, as the reference's does
    assert np.allclose(_f32(attention_ref(q, k, v, causal=True,
                                          window=window)),
                       _f32(oracle), atol=2e-5)


@pytest.mark.parametrize("g,window,dtype", [
    pytest.param(4, None, "float32", id="None"),
    pytest.param(4, 5, "float32", id="5"),
    pytest.param(7, None, "bfloat16", id="g7"),
    pytest.param(8, None, "bfloat16", id="g8"),
    pytest.param(12, None, "bfloat16", id="g12"),
])
def test_flash_decode_matches_reference(g, window, dtype):
    """tests/test_kernels.py's decode case (g 4, f32); the window drops no
    key, in the reference (the query sits at position 0) and in the port.
    Then the wide head groups whose bf16 decode takes the card's mma
    kernel (qwen2-vl's g 7, qwen2-72b's g 8, command-r-plus's g 12) at D
    128 over a ragged 100 keys."""
    B, Hkv, D = 2, 2, 128
    S = 64 if g == 4 else 100
    (jq, jk, jv), (q, k, v) = _inputs(7 + g, B, 1, S, g * Hkv, Hkv, D, dtype)
    out = flash_decode(q, k, v, window=window)
    pallas = flash_decode_tpu(jq, jk, jv, window=window, bk=32)
    oracle = jax_attention_ref(jq, jk, jv, causal=False)
    assert out.shape == (B, 1, g * Hkv, D) and out.dtype == _TORCH[dtype]
    assert np.allclose(_f32(out), _f32(pallas), atol=ATOL[dtype])
    assert np.allclose(_f32(out), _f32(oracle), atol=ATOL[dtype])


@pytest.mark.parametrize("Sq,Skv,causal,window", [
    (24, 37, False, None),     # ragged Skv, no mask
    (37, 37, True, 8),         # causal band no tile divides
    (40, 20, True, 6),         # rows past Skv + window - 1 see no key
])
def test_flash_attention_masks_match_reference(Sq, Skv, causal, window):
    """Masks the coverage classes miss, against the reference's oracle,
    including rows whose band holds no key: both average every key."""
    (jq, jk, jv), (q, k, v) = _inputs(Sq * Skv, 2, Sq, Skv, 4, 2, 64,
                                      "float32")
    out = flash_attention(q, k, v, causal=causal, window=window)
    oracle = jax_attention_ref(jq, jk, jv, causal=causal, window=window)
    assert np.allclose(_f32(out), _f32(oracle), atol=2e-5)


@pytest.mark.parametrize("Sq,Skv,q_offset,window,dtype", [
    (16, 40, 24, None, "float32"),    # the last rows of a causal span
    (16, 40, 10, 7, "bfloat16"),      # a window, keys past the rows
    (24, 24, 0, 5, "float32"),        # no offset
    (8, 64, 30, 40, "float32"),       # a window wider than the offset
])
def test_q_offset_matches_reference_rows_at_the_offset(Sq, Skv, q_offset,
                                                       window, dtype):
    """Query rows at positions q_offset .. q_offset + Sq - 1 (a context-
    parallel rank's rows): the output and log-sum-exp of the reference's
    oracle on the same rows after q_offset zero rows, which puts them at
    those positions."""
    (jq, jk, jv), (q, k, v) = _inputs(Sq + Skv + q_offset, 2, Sq, Skv, 4, 2,
                                      64, dtype)
    out, lse = flash_attention(q, k, v, causal=True, window=window,
                               q_offset=q_offset, return_lse=True)
    assert out.dtype == q.dtype and lse.shape == (2, 4, Sq)
    jq_at = jnp.concatenate([jnp.zeros((2, q_offset, 4, 64), jq.dtype), jq],
                            axis=1)
    oracle = jax_attention_ref(jq_at, jk, jv, causal=True,
                               window=window)[:, q_offset:]
    assert np.allclose(_f32(out), _f32(oracle), atol=ATOL[dtype])
    q_at = torch.cat([q.new_zeros((2, q_offset, 4, 64)), q], 1)
    _, lse_at = attention_ref(q_at, k, v, causal=True, window=window,
                              return_lse=True)
    assert torch.equal(lse, lse_at[..., q_offset:])


def test_cpu_prefill_is_an_operator_with_k4s_flops():
    """On fake tensors the CPU prefill (the operator
    ``repro_torch::flash_attention``) gives its outputs' shapes without an
    S x S score matrix, and FlopCounterMode counts K4's flops: 2 (D + Dv)
    per unmasked (q, k) pair."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.kernels.flash.ops import attention_pairs, prefill_flops
    assert attention_pairs(4, 10, True, None, 6) == 7 + 8 + 9 + 10
    assert attention_pairs(4, 10, True, 3, 6) == 12
    assert attention_pairs(3, 5, False, None) == 15
    with FakeTensorMode():
        q = torch.empty(2, 4096, 8, 64)
        kv = torch.empty(2, 4096, 2, 64)
        with FlopCounterMode(display=False) as fc:
            out, lse = flash_attention(q, kv, kv, window=512, q_offset=0,
                                       return_lse=True)
    assert out.shape == q.shape and lse.shape == (2, 8, 4096)
    pairs = attention_pairs(4096, 4096, True, 512)
    assert fc.get_total_flops() == 2 * 2 * 8 * 128 * pairs == prefill_flops(
        q.shape, kv.shape, kv.shape, True, 512)


def test_strided_views_give_the_same_result():
    """The model hands K4 a slice of its KV cache and head views of its
    projections; a view gives what its contiguous copy gives."""
    rng = np.random.RandomState(5)
    cache = torch.from_numpy(rng.randn(2, 30, 2, 64).astype(np.float32))
    q = torch.from_numpy(rng.randn(2, 1, 4, 64).astype(np.float32))
    k, v = cache[:, 3:17], cache.flip(1)[:, 3:17]
    assert not k.is_contiguous()
    want = flash_decode(q, k.contiguous(), v.contiguous())
    assert torch.equal(flash_decode(q, k, v), want)


@pytest.mark.parametrize("offset", [0, 1])
def test_f32_head_views_match_reference(offset):
    """f32 prefill on head views of one wider (B, S, H + 2 Hkv, D)
    projection, as a fused QKV product hands them over, its rows starting
    ``offset`` floats into a buffer (1: rows not 16-byte aligned), against
    the reference's Pallas kernel and oracle on the same values."""
    B, S, H, Hkv, D = 2, 40, 4, 2, 64
    rng = np.random.RandomState(17 + offset)
    flat = rng.randn(B, S, (H + 2 * Hkv) * D + offset).astype(np.float32)
    qkv = torch.from_numpy(flat)[:, :, offset:].unflatten(2, (H + 2 * Hkv,
                                                              D))
    q, k, v = qkv[:, :, :H], qkv[:, :, H:H + Hkv], qkv[:, :, H + Hkv:]
    assert not q.is_contiguous()
    out = flash_attention(q, k, v, causal=True, window=9)
    jq, jk, jv = (jnp.asarray(t.contiguous().numpy()) for t in (q, k, v))
    pallas = flash_attention_tpu(jq, jk, jv, causal=True, window=9, bq=16,
                                 bk=16)
    oracle = jax_attention_ref(jq, jk, jv, causal=True, window=9)
    assert np.allclose(_f32(out), _f32(pallas), atol=2e-5)
    assert np.allclose(_f32(out), _f32(oracle), atol=2e-5)


def test_operands_are_checked():
    q = torch.zeros(1, 4, 4, 64)
    kv = torch.zeros(1, 4, 2, 64)
    with pytest.raises(ValueError, match="window"):
        flash_attention(q, kv, kv, window=0)
    with pytest.raises(ValueError, match="do not fit"):
        flash_attention(q, kv, torch.zeros(1, 5, 2, 64))
    with pytest.raises(ValueError, match="kv heads"):
        flash_attention(q, torch.zeros(1, 4, 3, 64), torch.zeros(1, 4, 3, 64))
    with pytest.raises(TypeError, match="types"):
        flash_attention(q, kv.double(), kv)
    with pytest.raises(ValueError, match=r"\(B, 1, H, D\)"):
        flash_decode(q, kv, kv)
    with pytest.raises(ValueError, match="device"):
        flash_attention(q.to("meta"), kv.to("meta"), kv.to("meta"))



def _bf16(*shape):
    return torch.zeros(*shape, dtype=torch.bfloat16)


def test_mma_alignment_rule_accepts_aligned_views():
    """The tensor-core form's rule on CPU tensors: contiguous operands,
    head views of a fused QKV projection and a slice of a KV cache keep
    16-byte rows; a size-1 dim's stride is never stepped over."""
    from repro_torch.kernels._checks import row_misalignment, rows_aligned
    qkv = _bf16(2, 50, 12, 128)
    cache = _bf16(2, 100, 2, 64)
    views = {"contiguous": _bf16(2, 50, 4, 64),
             "q_heads": qkv[:, :, :8], "k_heads": qkv[:, :, 8:10],
             "cache_slice": cache[:, 13:77],
             "size1_dims": _bf16(1, 50, 1, 64).as_strided(
                 (1, 50, 1, 64), (3, 64, 5, 1))}
    for name, t in views.items():
        assert row_misalignment(t) is None, name
    rows_aligned("k4", "bf16 prefill", **views)


@pytest.mark.parametrize("case", ["s_stride", "h_stride", "offset"])
def test_mma_alignment_rule_rejects_misaligned(case):
    from repro_torch.kernels._checks import row_misalignment, rows_aligned
    if case == "s_stride":        # rows H*D + 4 elements apart
        t = _bf16(1, 32, 4 * 64 + 4)[:, :, :256].unflatten(2, (4, 64))
        want = "stride 260 of dim 1"
    elif case == "h_stride":
        t = _bf16(1, 32, 4, 68)[..., :64]
        want = "stride 68 of dim 2"
    else:                         # 2 bytes past an aligned start
        t = _bf16(32 * 4 * 64 + 8)[1:1 + 32 * 4 * 64].view(1, 32, 4, 64)
        want = "not a multiple of 16 bytes"
    assert want in row_misalignment(t)
    with pytest.raises(ValueError, match="16-byte aligned rows; q's"):
        rows_aligned("k4", "bf16 prefill", q=t)


def test_row_alignment_rule_counts_bytes():
    """The decode form's rule is the same 16 bytes for both types: an f32
    stride of 4 elements keeps rows aligned where a bf16 one does not, and
    the cache slices the model's decode step passes (k_cache[:, lo:cur+1],
    stepping by Hkv * D elements) are aligned for every lo."""
    from repro_torch.kernels._checks import row_misalignment, rows_aligned
    f32 = torch.zeros(1, 8, 2, 68)[..., :64]              # h stride 68
    assert row_misalignment(f32) is None
    assert "136 bytes" in row_misalignment(_bf16(1, 8, 2, 68)[..., :64])
    odd = torch.zeros(1, 8, 2, 66)[..., :64]              # 264 bytes
    assert "264 bytes" in row_misalignment(odd)
    for dtype in (torch.float32, torch.bfloat16):
        cache = torch.zeros(4, 1056, 1, 256, dtype=dtype)
        for lo in (0, 1, 7, 513):
            rows_aligned("k4", "decode", k=cache[:, lo:1024])
    with pytest.raises(ValueError, match="decode form needs 16-byte"):
        rows_aligned("k4", "decode", q=odd)


@pytest.mark.parametrize("blocks", [1, 2, 4, 8, 15, 16, 24, 32, 96, 100,
                                    132, 500])
def test_decode_split_covers_every_key_once(blocks):
    """Every key in exactly one chunk, no chunk empty, at most one block
    per SM's worth of splits, no chunk but the last below MIN_CHUNK keys,
    spans shorter than 2 * MIN_CHUNK keys kept whole (no one-key pieces),
    and from CLUSTER_PAIRS pairs on at most MAX_CLUSTER splits (every
    span merges in a cluster)."""
    from repro_torch.kernels.flash.ops import (
        CLUSTER_PAIRS, MAX_CLUSTER, MIN_CHUNK, SMS, decode_cluster,
        decode_split)
    for skv in range(1, 2100):
        kc, nsplit = decode_split(skv, blocks)
        chunks = [range(c * kc, min((c + 1) * kc, skv))
                  for c in range(nsplit)]
        assert [j for ch in chunks for j in ch] == list(range(skv))
        assert all(len(ch) > 0 for ch in chunks)
        assert 1 <= nsplit <= max(1, -(-SMS // blocks))
        assert nsplit == 1 or kc >= MIN_CHUNK
        if skv < 2 * MIN_CHUNK:
            assert nsplit == 1
        if blocks >= CLUSTER_PAIRS:
            assert nsplit <= MAX_CLUSTER and decode_cluster(nsplit)
    with pytest.raises(ValueError, match="cannot split"):
        decode_split(0, blocks)


def test_decode_split_fills_the_card_on_the_main_path():
    """gemma3-1b's decode (B 4, Hkv 1): at least 128 split blocks over the
    prompt's 1024 keys, over the 1056-slot cache and over a local layer's
    512-slot span; chunks of 32 keys at 1024."""
    from repro_torch.kernels.flash.ops import decode_split
    assert decode_split(1024, 4) == (32, 32)
    for skv in (512, 1024, 1056):
        kc, nsplit = decode_split(skv, 4)
        assert 4 * nsplit >= 128


@pytest.mark.parametrize("skv,blocks,split,cluster", [
    (160, 32, (32, 5), True),       # granite's serving cache, B 4 x Hkv 8
    (100, 32, (20, 5), True),       # granite, a 100-slot span
    (128, 16, (16, 8), True),       # granite's f32 check, B 2 x Hkv 8
    (64, 4, (16, 4), True),         # gemma3-1b's short span, B 4 x Hkv 1
    (1024, 4, (32, 32), False),     # gemma3-1b's prompt: the merge kernel
    (512, 4, (16, 32), False),      # gemma3-1b's local-layer span
    (1024, 16, (128, 8), True),     # 16 pairs: capped at 8 (9 uncapped)
    (160, 16, (20, 8), True),       # qwen2-vl, B 4 x Hkv 4
    (160, 96, (80, 2), True),       # musicgen, B 4 x Hkv 24
    (20, 32, (20, 1), True),        # one chunk, a cluster of one block
])
def test_decode_split_at_the_model_shapes(skv, blocks, split, cluster):
    """decode_split and the kernels it gives (the cluster kernel up to
    MAX_CLUSTER splits, the split and merge kernels past it) at the model
    paths' decode shapes and at the widths of the archs not yet
    served."""
    from repro_torch.kernels.flash.ops import decode_cluster, decode_split
    assert decode_split(skv, blocks) == split
    assert decode_cluster(split[1]) == cluster


# (B, Hkv, g, keys, dtype): each path's decode shape, its split and kernel
@pytest.mark.parametrize("B,Hkv,g,keys,dtype,split,kernel", [
    # the wide groups' serving steps (160 keys) and a 100-key span
    (4, 4, 7, 160, torch.bfloat16, (20, 8), "decode_mma"),     # qwen2-vl
    (4, 4, 7, 100, torch.bfloat16, (17, 6), "decode_mma"),
    (4, 8, 8, 160, torch.bfloat16, (32, 5), "decode_mma"),     # qwen2-72b
    (4, 8, 8, 100, torch.bfloat16, (20, 5), "decode_mma"),     # and jamba
    (4, 8, 12, 160, torch.bfloat16, (32, 5), "decode_mma"),    # command-r+
    (4, 8, 12, 100, torch.bfloat16, (20, 5), "decode_mma"),
    # gemma-2b's MQA (D 256): 6 splits at 100 keys, 10 at 160
    (4, 1, 8, 100, torch.bfloat16, (17, 6), "decode_mma"),
    (4, 1, 8, 160, torch.bfloat16, (16, 10), "decode_split"),
    # granite's g 3, musicgen's MHA, gemma3-1b's g 4 (the prompt's 1024
    # keys and a 64-key span)
    (4, 8, 3, 160, torch.bfloat16, (32, 5), "decode_cluster"),
    (4, 8, 3, 100, torch.bfloat16, (20, 5), "decode_cluster"),
    (4, 24, 1, 160, torch.bfloat16, (80, 2), "decode_cluster"),
    (4, 1, 4, 1024, torch.bfloat16, (32, 32), "decode_split"),
    (4, 1, 4, 64, torch.bfloat16, (16, 4), "decode_cluster"),
    # an f32 check at g 12 (command-r-plus's, B 2 over 64 keys)
    (2, 8, 12, 64, torch.float32, (16, 4), "decode_cluster"),
])
def test_decode_kernel_at_the_model_shapes(B, Hkv, g, keys, dtype, split,
                                           kernel):
    """decode_split and decode_kernel (the mirror of the C++ dispatch) at
    every path's decode shape: a bf16 decode at g >= 5 up to MAX_CLUSTER
    splits takes the mma kernel, g <= 4 and every f32 decode the cluster
    kernel, more splits the split and merge kernels."""
    from repro_torch.kernels.flash.ops import decode_kernel, decode_split
    assert decode_split(keys, B * Hkv) == split
    assert decode_kernel(dtype, g, split[1]) == kernel


def test_decode_kernel_rule():
    """The rule whole: past MAX_CLUSTER splits the split kernel; up to it
    bf16 at g >= MMA_MIN_GROUP the mma kernel, else the cluster kernel;
    DECODE_KERNELS orders the names by the C++ codes."""
    from repro_torch.kernels.flash.ops import (
        DECODE_KERNELS, MAX_CLUSTER, MMA_MIN_GROUP, decode_kernel)
    assert MMA_MIN_GROUP == 5
    assert DECODE_KERNELS == ("decode_split", "decode_cluster", "decode_mma")
    for dtype in (torch.float32, torch.bfloat16):
        for g in range(1, 97):
            for n in range(1, 133):
                want = ("decode_split" if n > MAX_CLUSTER
                        else "decode_mma" if dtype == torch.bfloat16
                        and g >= MMA_MIN_GROUP else "decode_cluster")
                assert decode_kernel(dtype, g, n) == want
    for g, n in ((0, 1), (1, 0)):
        with pytest.raises(ValueError, match="no decode kernel"):
            decode_kernel(torch.bfloat16, g, n)


def test_decode_head_group_sizes_groups_to_g():
    """The decode form's query heads a block: g itself up to 4, 6 and 8
    above it, and past 8 the largest of 8, 6, 4 that divides g (else 8):
    granite's 3 and command-r-plus's 12 leave no slot idle, qwen2-vl's 7
    one."""
    from repro_torch.kernels.flash.ops import decode_head_group
    want = {1: 1, 2: 2, 3: 3, 4: 4, 5: 6, 6: 6, 7: 8, 8: 8, 9: 8, 10: 8,
            12: 6, 16: 8, 18: 6, 20: 4, 24: 8, 28: 4, 30: 6, 96: 8}
    assert {g: decode_head_group(g) for g in want} == want
    for g in range(1, 200):
        gt = decode_head_group(g)
        assert gt in (1, 2, 3, 4, 6, 8)
        idle = -(-g // gt) * gt - g
        assert idle == 0 or g in (5, 7) or all(g % c for c in (8, 6, 4))
    with pytest.raises(ValueError):
        decode_head_group(0)


def test_decode_cluster_takes_one_to_eight_splits():
    from repro_torch.kernels.flash.ops import MAX_CLUSTER, decode_cluster
    assert MAX_CLUSTER == 8
    assert [n for n in range(1, 140) if decode_cluster(n)] == \
        list(range(1, 9))


def test_prefill_form_by_dtype():
    from repro_torch.kernels.flash.ops import FORMS, prefill_form
    assert prefill_form(torch.bfloat16, 64, 64) == "prefill_wgmma"
    assert prefill_form(torch.bfloat16, 192, 128) == "prefill_wgmma"
    assert prefill_form(torch.float32, 64, 64) == "prefill_simt"
    assert set(FORMS) == {"prefill_wgmma", "prefill_simt", "decode"}


@pytest.mark.parametrize("dtype,dk,dv,form", [
    (torch.bfloat16, 128, 128, "prefill_wgmma"),
    (torch.bfloat16, 256, 256, "prefill_wgmma"),
    (torch.bfloat16, 64, 64, "prefill_wgmma"),
    (torch.bfloat16, 192, 128, "prefill_wgmma"),
    (torch.float32, 64, 64, "prefill_simt"),
    (torch.float32, 128, 128, "prefill_simt"),
    (torch.float32, 192, 128, "prefill_simt"),
    (torch.float32, 256, 256, "prefill_simt"),
])
def test_prefill_form_by_head_dims(dtype, dk, dv, form):
    """The Python mirror of the C++ dispatch: the (dtype, Dk, Dv) of a
    prefill alone picks its form (bf16 the wgmma form at every pair,
    MLA's (192, 128) included, f32 the SIMT form); a pair K4 is not built
    for has none."""
    from repro_torch.kernels.flash.ops import prefill_form
    assert prefill_form(dtype, dk, dv) == form
    with pytest.raises(ValueError, match="no prefill form"):
        prefill_form(dtype, dk, dk + 64)


@pytest.mark.parametrize("dk,dv,keys,stages,qbufs,smem", [
    (64, 64, 128, 2, 2, 99424), (128, 128, 128, 2, 2, 197728),
    (256, 256, 64, 2, 1, 197712), (192, 128, 128, 2, 1, 214096)])
def test_wgmma_plan_fits_a_block(dk, dv, keys, stages, qbufs, smem):
    """The wgmma form's tile plan (the Python mirror of
    csrc/flash_attn_wgmma.cuh's): 128 query rows a work item in two
    warpgroups of 64, 128 keys a tile at D 64 and 128 and at MLA's (192,
    128), 64 at D 256, two stages of K and V, two Q buffers where they fit
    beside the ring (one at D 256 and (192, 128)), and its shared bytes
    within the 232,448 a block can have; a pair the form is not built for
    raises."""
    from repro_torch.kernels.flash.ops import wgmma_plan
    plan = wgmma_plan(dk, dv)
    assert plan == {"rows": 128, "keys": keys, "stages": stages,
                    "q_buffers": qbufs, "smem_bytes": smem}
    # the Q buffers (128 x dk each), the stages of K (keys x dk) and V
    # (keys x dv), all bf16; two mbarriers a Q buffer and four a stage;
    # 1024 bytes of alignment slack
    assert smem == 2 * (qbufs * 128 * dk + stages * keys * (dk + dv)) \
        + 8 * (2 * qbufs + 4 * stages) + 1024
    assert smem <= 232448
    # a second Q buffer would not fit where the plan keeps one
    assert qbufs == 2 or smem + 2 * 128 * dk + 16 > 232448
    with pytest.raises(ValueError):
        wgmma_plan(192, 192)


# (B, H, Hkv, S, Dk, Dv): deepseek-v2's MLA serving and training (B 2),
# qwen2-vl, command-r-plus, musicgen, qwen2-72b at the paths' 1024, and
# longer or ragged prompts (q tiles that do not divide a pass pair)
WORK_CASES = [(4, 128, 128, 1024, 192, 128), (2, 128, 128, 1024, 192, 128),
              (4, 28, 4, 1024, 128, 128), (4, 96, 8, 1024, 128, 128),
              (4, 24, 24, 1024, 64, 64), (4, 64, 8, 1024, 128, 128),
              (1, 28, 4, 4096, 128, 128), (2, 32, 32, 2048, 128, 128),
              (4, 128, 128, 640, 192, 128), (2, 128, 128, 3000, 192, 128)]


@pytest.mark.parametrize("B,H,Hkv,S,dk,dv", WORK_CASES)
def test_wgmma_work_order_takes_each_item_once_and_evens_the_blocks(
        B, H, Hkv, S, dk, dv):
    """The wgmma form's work list (``ops.wgmma_item``, the kernel's
    ``work_item``), in its launcher's chunks (``wgmma_chunk``: two passes
    of the grid where K and V exceed half the L2) and as one chunk: every
    (batch x head, q tile) comes exactly once, and each block's causal key
    tiles are within 5 % of the mean over the blocks."""
    from repro_torch.kernels.flash import ops
    nqt = -(-S // 128)
    grid = ops.wgmma_grid(B, H, S)
    chunked = B * Hkv * S * (dk + dv) * 2 > ops.L2_BYTES // 2
    assert ops.wgmma_chunk(B, H, Hkv, S, S, dk, dv) == \
        (2 * grid if chunked else B * H * nqt)
    for chunk in (2 * grid, B * H * nqt):
        blocks = ops.wgmma_blocks(B, H, S, chunk)
        assert len(blocks) == grid == min(B * H * nqt, 132)
        items = [it for b in blocks for it in b]
        assert sorted(items) == [(bh, t) for bh in range(B * H)
                                 for t in range(nqt)]
        tiles = [sum(ops.item_band(t, S, S, True, None)[1] for _, t in b)
                 for b in blocks]
        assert max(tiles) <= 1.05 * sum(tiles) / grid


def test_wgmma_work_order_reads_mla_keys_about_once():
    """At deepseek-v2's MLA serving shape (B 4, 128 heads, S 1024, (192,
    128)) the chunked list reads K and V from device memory at most twice
    over (0.336 GB once) under ``kv_read_bytes``' model of the 50 MB L2,
    where the list as one chunk (every head's last q tile first) reads
    nearly every q tile's keys anew: 36 of a head's 8 x 8 key tiles, 1.51
    GB."""
    from repro_torch.kernels.flash import ops
    B, H, S, dk, dv = 4, 128, 1024, 192, 128
    once = B * H * S * (dk + dv) * 2
    every = B * H * 36 * 128 * (dk + dv) * 2       # 1.51 GB
    read, got_once = ops.kv_read_bytes(B, H, H, S, S, dk, dv)
    assert got_once == once == 335544320
    assert read <= 2 * once
    one, _ = ops.kv_read_bytes(B, H, H, S, S, dk, dv, chunk=B * H * 8)
    assert 0.95 * every <= one <= every and abs(every - 1.51e9) < 0.01e9
    # the same with its lse at B 2 (training), and a shape whose K and V
    # fit half the L2 keeps one chunk and reads them once
    read, once = ops.kv_read_bytes(2, H, H, S, S, dk, dv)
    assert read <= 2 * once
    read, once = ops.kv_read_bytes(4, 28, 4, S, S, 128, 128)
    assert read == once


def test_cpu_route_takes_plain_version():
    """On the CPU a bf16 prefill takes attention_ref, even through views
    the tensor-core form would refuse, and counts no launch of any
    form."""
    from repro_torch.kernels import registry
    from repro_torch.kernels.flash.ops import form_launches
    registry.reset_launch_counts()
    rng = np.random.RandomState(9)
    wide = torch.from_numpy(rng.randn(1, 20, 4 * 64 + 4).astype(
        np.float32)).to(torch.bfloat16)
    q = wide[:, :, :256].unflatten(2, (4, 64))
    kv = torch.from_numpy(rng.randn(1, 20, 2, 64).astype(np.float32)).to(
        torch.bfloat16)
    out = flash_attention(q, kv, kv, causal=True, window=7)
    want = attention_ref(q, kv, kv, causal=True, window=7).to(torch.bfloat16)
    assert torch.equal(out, want)
    assert form_launches() == {"prefill_wgmma": 0, "prefill_simt": 0,
                               "decode": 0}
    assert registry.get_kernel("flash_attention").launches() == 0


def test_form_counts_sit_beside_the_registry_count():
    """A launch counts under flash_attention and under its form; the
    registry's reset clears both.  (A stand-in launcher: no card here.)"""
    from repro_torch.kernels import _build, registry
    from repro_torch.kernels.flash.ops import KERNEL, form_launches
    registry.reset_launch_counts()
    for form in ("prefill_wgmma", "prefill_wgmma", "decode"):
        _build.launch(KERNEL, lambda: 0, form=form)
    assert form_launches() == {"prefill_wgmma": 2, "prefill_simt": 0,
                               "decode": 1}
    entry = registry.get_kernel(KERNEL)
    assert entry.launches() == 3
    _build.launch(KERNEL, lambda: 0, form="prefill_simt")
    assert form_launches()["prefill_simt"] == 1 and entry.launches() == 4
    registry.reset_launch_counts()
    assert entry.launches() == 0 and sum(form_launches().values()) == 0
    with pytest.raises(RuntimeError, match="prefill_wgmma"):
        _build.launch(KERNEL, lambda: 2, form="prefill_wgmma")
    assert entry.launches() == 0


# ---- (Dk, Dv) with Dv != Dk: DeepSeek-V2's MLA at (192, 128), unpadded ----

# (Sq, Skv, q_offset, window, causal)
DKDV_MASKS = [(24, 24, 0, None, True), (16, 40, 24, None, True),
              (16, 40, 10, 7, True), (24, 37, 0, None, False)]


@pytest.mark.parametrize("dk,dv", [(48, 32), (192, 128)])
@pytest.mark.parametrize("Sq,Skv,q_offset,window,causal", DKDV_MASKS)
def test_flash_attention_dk_dv_matches_blocked_attention(dk, dv, Sq, Skv,
                                                         q_offset, window,
                                                         causal):
    """The plain route at a v head dim of its own: out (B, Sq, H, Dv) and
    the row log-sum-exp against the reference's ``blocked_attention``
    (``repro.models.layers``, which scales by 1/sqrt(Dk)) on the same
    numpy-seeded f32 operands, within 1e-5: causal, rows at an offset, a
    window, and no mask over a ragged Skv."""
    from repro.models.layers import blocked_attention
    rng = np.random.RandomState(dk + Sq + q_offset)
    B, H, Hkv = 2, 4, 2
    q = rng.randn(B, Sq, H, dk).astype(np.float32)
    k = rng.randn(B, Skv, Hkv, dk).astype(np.float32)
    v = rng.randn(B, Skv, Hkv, dv).astype(np.float32)
    out, lse = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                               causal=causal, window=window,
                               q_offset=q_offset, return_lse=True)
    want, want_lse = blocked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, block_kv=16, q_offset=q_offset)
    assert out.shape == (B, Sq, H, dv) and lse.shape == (B, H, Sq)
    assert np.allclose(_f32(out), _f32(want), atol=1e-5, rtol=0)
    assert np.allclose(_f32(lse), np.asarray(want_lse).reshape(B, H, Sq),
                       atol=1e-5, rtol=0)


@pytest.mark.parametrize("H,Hkv,window", [(4, 4, None), (6, 2, 5)])
def test_attention_function_dk_dv_grads_match_reference_vjp(H, Hkv, window):
    """``FlashAttention`` (K4's plain version with its lse, the plain
    block-recompute backward) at Dk 24, Dv 16, unpadded: dq, dk, dv
    against ``jax.vjp`` of the reference's ``flash_attention`` within 2e-5
    of each tensor's largest (tests/test_torch_train_models.py's
    tolerance)."""
    import jax
    from repro.models import layers as RL
    from repro_torch.models.layers import FlashAttention
    rng = np.random.RandomState(H + Hkv)
    B, S, dk, dv = 2, 20, 24, 16
    q = rng.randn(B, S, H, dk).astype(np.float32)
    k = rng.randn(B, S, Hkv, dk).astype(np.float32)
    v = rng.randn(B, S, Hkv, dv).astype(np.float32)
    do = rng.randn(B, S, H, dv).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b, c: RL.flash_attention(
        a, b, c, True, window, 8, False), *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = FlashAttention.apply(*ts, True, window, None, 8)
    assert out.shape == (B, S, H, dv)
    out.backward(torch.from_numpy(do))
    for t, w in zip(ts, want):
        g, w = _f32(t.grad), _f32(w)
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= 2e-5 * np.abs(w).max()


def test_checks_take_v_head_dim_and_refuse_k_v_that_disagree():
    """``_checks.attention`` takes v's own head dim, and k and v must agree
    in batch, keys and kv heads; the card's pairs are the four K4 is
    built for, the decode form's three."""
    from repro_torch.kernels import _checks
    q = torch.zeros(2, 5, 4, 192)
    k = torch.zeros(2, 7, 2, 192)
    assert _checks.attention("k4", q, k, torch.zeros(2, 7, 2, 128)) == "cpu"
    for bad in [(2, 8, 2, 128), (2, 7, 1, 128), (1, 7, 2, 128)]:
        with pytest.raises(ValueError, match="do not fit"):
            _checks.attention("k4", q, k, torch.zeros(*bad))
    with pytest.raises(ValueError, match="do not fit"):
        _checks.attention("k4", q, torch.zeros(2, 7, 2, 128),
                          torch.zeros(2, 7, 2, 128))
    assert _checks.ATTENTION_HEAD_DIMS == ((64, 64), (128, 128), (192, 128),
                                           (256, 256))
    assert (192, 128) not in _checks.DECODE_HEAD_DIMS


def test_prefill_flops_count_dk_plus_dv_a_pair():
    """K4's flop formula at MLA's (192, 128): 2 (192 + 128) = 640 a pair,
    against 1024 a pair at the padded (256, 256)."""
    from repro_torch.kernels.flash.ops import attention_pairs, prefill_flops
    q, k, v = (4, 1024, 128, 192), (4, 1024, 128, 192), (4, 1024, 128, 128)
    pairs = attention_pairs(1024, 1024, True, None)
    assert pairs == 1024 * 1025 // 2
    assert prefill_flops(q, k, v, True, None) == 2 * 320 * 4 * 128 * pairs
    assert prefill_flops((4, 1024, 128, 256), (4, 1024, 128, 256),
                         (4, 1024, 128, 256), True, None) == \
        2 * 512 * 4 * 128 * pairs


@pytest.mark.parametrize("name,form,key", [
    ("_ZN12_GLOBAL__N_12wg18flash_wgmma_kernelILi192ELi128EEEv14CUtensorMap"
     "_stS2_S2_S2_Pfiiiiiiiiifi", "prefill_wgmma", "bf16_d192_128"),
    ("_ZN12_GLOBAL__N_12wg18flash_wgmma_kernelILi64ELi64EEEv14CUtensorMap_st"
     "S2_S2_S2_Pfiiiiiiiiifi", "prefill_wgmma", "bf16_d64"),
    ("_ZN12_GLOBAL__N_12wg18flash_wgmma_kernelILi256ELi256EEEv14CUtensorMap"
     "_stS2_S2_S2_Pfiiiiiiiiifi", "prefill_wgmma", "bf16_d256"),
    ("_ZN12_GLOBAL__N_12wg18flash_wgmma_kernelILi128ELi128EEEv14CUtensorMap"
     "_stS2_S2_S2_Pfiiiiiiiiifi", "prefill_wgmma", "bf16_d128"),
    ("void (anonymous namespace)::wg::flash_wgmma_kernel<128, 128>("
     "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
     "float*, int, int, int, int, int, int, int, int, float, int)",
     "prefill_wgmma", None),
    ("_ZN12_GLOBAL__N_14simt20flash_prefill_kernelIfLi192ELi128EEEvPT_",
     "prefill_simt", "f32_d192_128"),
    ("_ZN12_GLOBAL__N_13dec25flash_decode_split_kernelI13__nv_bfloat16Li64"
     "ELi4EEEvPT_", "decode_split", "bf16_d64_g4"),
    ("_ZN12_GLOBAL__N_13dec27flash_decode_cluster_kernelIfLi128ELi6EEEvPT_",
     "decode_cluster", "f32_d128_g6"),
    ("void (anonymous namespace)::dec::flash_decode_cluster_kernel<"
     "__nv_bfloat16, 64, 3>(__nv_bfloat16*)", "decode_cluster", None),
    ("_ZN12_GLOBAL__N_13dec23flash_decode_mma_kernelILi128EEEvP13__nv_bfloat"
     "16PKS2_S5_S5_NS_7StridesES6_S6_iiiiiif", "decode_mma", "bf16_d128"),
    ("void (anonymous namespace)::dec::flash_decode_mma_kernel<256>("
     "__nv_bfloat16*, __nv_bfloat16 const*, __nv_bfloat16 const*, "
     "__nv_bfloat16 const*, (anonymous namespace)::Strides, "
     "(anonymous namespace)::Strides, (anonymous namespace)::Strides, int, "
     "int, int, int, int, int, float)", "decode_mma", None),
    ("void (anonymous namespace)::wg::flash_wgmma_kernel<192, 128>("
     "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
     "float*, int, int, int, int, int, int, int, int, float, int)",
     "prefill_wgmma", None),
    ("void (anonymous namespace)::wg::flash_wgmma_kernel<64, 64>("
     "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
     "float*, int, int, int, int, int, int, int, int, float, int)",
     "prefill_wgmma", None),
    ("void (anonymous namespace)::conv2d_general_kernel(int*, int const*)",
     None, None),
])
def test_kernel_names_map_to_forms(name, form, key):
    """Profiler (demangled) and ptxas (mangled) names of K4's kernels map
    to their form, the wgmma kernel's (at every (Dk, Dv)) to
    prefill_wgmma; a mangled name also gives its ``resources`` key (type,
    head dims, Dv where it differs, a decode kernel's heads a block);
    a kernel that is not K4's is no form's."""
    from repro_torch.kernels.flash import ops
    assert ops.kernel_form(name) == form
    if key is not None:
        assert ops._resource_key(*ops._entry(name)) == key
