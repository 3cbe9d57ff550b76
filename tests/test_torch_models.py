"""The port's model substrate (repro_torch.configs, .models, .launch.serve)
against the reference's (repro.configs, .models, .launch.serve) on the CPU,
at reduced sizes (``reduced(...)``), on the same numpy-seeded inputs.

Tolerances: both compute the same f32 expressions in another order, so
f32 layers agree to 1e-5 and f32 logits (magnitude 1 to 4) to atol 2e-5,
rtol 1e-5 (they measure about 1e-6; the reference's own decode-against-
prefill tolerance, tests/test_models.py, is atol 2e-3, rtol 1e-3).  bf16
forwards round every activation to bf16 (8 bits of mantissa), at other
places in XLA and in torch, so bf16 logits agree to a few bf16 ulps:
atol 6e-2 (they measure up to 0.031, two ulps at 3.7, on the dense
families, and 0.045, three ulps at 3.4, on the hybrid's decode).  The
reference runs eagerly with its layer scans unrolled (``unroll_scans``),
which tests/test_models.py::test_unroll_scans_matches_scan holds equal to
the scanned form; its SSD inter-chunk scan stays a ``lax.scan``.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.launch.serve import zero_cache as ref_zero_cache  # noqa: E402
from repro.models import build_forward as ref_build_forward  # noqa: E402
from repro.models import init_params as ref_init_params  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models.model import cache_specs as ref_cache_specs  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels.flash import flash_attention  # noqa: E402
from repro_torch.kernels.flash.ref import attention_ref  # noqa: E402
from repro_torch.launch import serve as port_serve  # noqa: E402
from repro_torch.models import build_forward, init_params  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models.convert import cast_params, params_from_numpy  # noqa: E402
from repro_torch.models.model import (  # noqa: E402
    cache_specs, moe_experts_padded, tree_leaves, zero_cache)

ALL_ARCHS = sorted(configs.ARCHS)
F32_TOL = dict(atol=2e-5, rtol=1e-5)
BF16_ATOL = 6e-2


def _cfgs(arch, **kw):
    """The reduced config of ``arch`` in both packages, with ``kw``."""
    return (ref_configs.reduced(ref_configs.ARCHS[arch]).replace(
                unroll_scans=True, **kw),
            configs.reduced(configs.ARCHS[arch]).replace(**kw))


def _params(ref_cfg, cfg):
    ref = ref_init_params(ref_cfg, 0)
    return ref, init_params(cfg, 0, "cpu")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a, np.float32))
    return t if dtype is None else t.to(dtype)


def _batch(cfg, B, S, rng):
    """Tokens or embedding frames (rounded to the activation type by JAX),
    and M-RoPE positions where the config has them, for both packages."""
    if cfg.input_mode == "tokens":
        toks = rng.randint(2, cfg.vocab, (B, S)).astype(np.int32)
        ref, port = {"tokens": jnp.asarray(toks)}, {
            "tokens": torch.from_numpy(toks)}
    else:
        frames = jnp.asarray(rng.randn(B, S, cfg.d_model) * 0.3,
                             jnp.dtype(cfg.dtype))
        ref = {"tokens": frames}
        port = {"tokens": _t(frames).to(
            {"float32": torch.float32, "bfloat16": torch.bfloat16}[
                cfg.dtype])}
    if cfg.mrope_sections:
        pos = np.broadcast_to(np.arange(S)[None, None], (3, B, S))
        ref["positions"] = jnp.asarray(pos, jnp.int32)
        port["positions"] = torch.from_numpy(pos.copy())
    return ref, port


def _step(batch, i, B, mrope, mod):
    """Decode step i's inputs, from a whole-prompt batch."""
    shape = (3, B, 1) if mrope else (B, 1)
    if mod is jnp:
        return {"tokens": batch["tokens"][:, i:i + 1],
                "positions": jnp.full(shape, i, jnp.int32)}
    return {"tokens": batch["tokens"][:, i:i + 1],
            "positions": torch.full(shape, i, dtype=torch.int32)}


# --------------------------------------------------------------------------
# configs and parameters


@pytest.mark.parametrize("arch", sorted(configs.ARCHS))
def test_configs_are_the_references(arch):
    ref = ref_configs.ARCHS[arch]
    port = configs.ARCHS[arch]
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(configs.reduced(port)) == \
        dataclasses.asdict(ref_configs.reduced(ref))
    assert port.param_count() == ref.param_count()
    assert configs.SHAPES == ref_configs.SHAPES
    assert configs.cells(True) == ref_configs.cells(True)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_carried_weights_equal_init_params_bit_for_bit(arch):
    """params_from_numpy(the reference's init_params) is the port's own
    init_params, leaf for leaf, in bf16 and in f32."""
    for dtype in ("bfloat16", "float32"):
        ref_cfg, cfg = _cfgs(arch, dtype=dtype)
        ref, port = _params(ref_cfg, cfg)
        carried = params_from_numpy(jax.tree.map(np.asarray, ref), "cpu")
        want = list(tree_leaves(carried))
        got = list(tree_leaves(port))
        assert len(got) == len(jax.tree.leaves(ref)) > 0
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b)
        assert carried.keys() == port.keys()


@pytest.mark.parametrize("arch", ["gemma3-1b", "qwen2-72b", "deepseek-v2-236b",
                                  "mamba2-1.3b", "jamba-1.5-large-398b"])
def test_cache_specs_and_cast(arch):
    ref_cfg, cfg = _cfgs(arch, window_cache=True)
    ref = jax.tree.leaves(ref_cache_specs(ref_cfg, 2, 12),
                          is_leaf=lambda x: hasattr(x, "axes"))
    got = list(tree_leaves(cache_specs(cfg, 2, 12)))
    assert [(p.shape, p.dtype) for p in got] == \
        [(p.shape, p.dtype) for p in ref]
    f32 = init_params(cfg.replace(dtype="float32"), 0, "cpu")
    want = [t.clone() for t in tree_leaves(f32)]
    bf16 = cast_params(f32, cfg)                 # in place
    assert bf16 is f32
    for a, b, p in zip(tree_leaves(bf16), want,
                       tree_leaves(init_params(cfg, 0, "cpu"))):
        assert a.dtype == p.dtype and torch.equal(a, b.to(p.dtype))


# --------------------------------------------------------------------------
# layers, in f32


def test_norms_match_reference():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 64).astype(np.float32) * 3
    scale = rng.randn(64).astype(np.float32) * 0.1
    for ref_fn, fn in ((RL.rms_norm, TL.rms_norm),
                       (RL.layer_norm, TL.layer_norm)):
        want = ref_fn(jnp.asarray(x), jnp.asarray(scale), 1e-6)
        got = fn(_t(x), _t(scale), 1e-6)
        assert np.allclose(_np(got), _np(want), atol=1e-5)


@pytest.mark.parametrize("mrope", [None, (4, 2, 2)])
def test_apply_rope_matches_reference(mrope):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 7, 3, 16).astype(np.float32)
    pos = rng.randint(0, 500, (3, 2, 7) if mrope else (2, 7))
    want = RL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6, mrope)
    got = TL.apply_rope(_t(x), torch.from_numpy(pos), 1e6, mrope)
    # angles up to 500 rad: an ulp of difference in a frequency moves the
    # angle by up to 3e-5
    assert np.allclose(_np(got), _np(want), atol=2e-4)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp_matches_reference(act):
    """GeGLU is tanh-approximated in both (jax.nn.gelu's default)."""
    ref_cfg, cfg = _cfgs("gemma3-1b", dtype="float32", mlp_act=act)
    rng = np.random.RandomState(2)
    p = {k: rng.randn(*s).astype(np.float32) * 0.2 for k, s in
         (("w_gate", (64, 96)), ("w_up", (64, 96)), ("w_down", (96, 64)))}
    x = rng.randn(2, 5, 64).astype(np.float32)
    want = RL.mlp(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()},
                  ref_cfg)
    got = TL.mlp(_t(x), {k: _t(v) for k, v in p.items()}, cfg)
    assert np.allclose(_np(got), _np(want), atol=1e-5)


def _attn_params(rng, D, H, Hkv, hd, bias):
    p = {"wq": rng.randn(D, H, hd), "wk": rng.randn(D, Hkv, hd),
         "wv": rng.randn(D, Hkv, hd), "wo": rng.randn(H, hd, D)}
    p = {k: (v / np.sqrt(D)).astype(np.float32) for k, v in p.items()}
    if bias:
        for k, h in (("bq", H), ("bk", Hkv), ("bv", Hkv)):
            p[k] = rng.randn(h, hd).astype(np.float32) * 0.5
    return p


@pytest.mark.parametrize("impl,window,bias", [
    ("naive", None, False), ("blocked", None, True), ("naive", 5, True),
    ("blocked", 5, False)])
def test_attention_block_prefill_matches_reference(impl, window, bias):
    ref_cfg, cfg = _cfgs("qwen2-72b", dtype="float32", attn_impl=impl,
                         qkv_bias=bias)
    rng = np.random.RandomState(3)
    p = _attn_params(rng, 64, 4, 4, 16, bias)
    x = rng.randn(2, 11, 64).astype(np.float32)
    pos = np.broadcast_to(np.arange(11)[None], (2, 11))
    want, _ = RL.attention_block(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}, ref_cfg,
        positions=jnp.asarray(pos), window=window)
    got, cache = TL.attention_block(
        _t(x), {k: _t(v) for k, v in p.items()}, cfg,
        positions=torch.from_numpy(pos.copy()), window=window)
    assert cache is None
    assert np.allclose(_np(got), _np(want), atol=1e-5)


@pytest.mark.parametrize("cache_len,window,pos", [
    (16, None, 9),       # full cache, no window
    (16, 4, 9),          # full cache, window: slots 6..9
    (16, 4, 2),          # window longer than the history
    (4, 4, 9),           # rolling cache, wrapped
    (4, 4, 2),           # rolling cache, not yet full
])
def test_attention_block_decode_matches_reference(cache_len, window, pos):
    """One decode step: the same output, and the same cache after the
    in-place write."""
    ref_cfg, cfg = _cfgs("qwen2-72b", dtype="float32", qkv_bias=True)
    rng = np.random.RandomState(cache_len + pos)
    p = _attn_params(rng, 64, 4, 2, 16, True)
    ref_cfg, cfg = (ref_cfg.replace(n_kv_heads=2), cfg.replace(n_kv_heads=2))
    x = rng.randn(2, 1, 64).astype(np.float32)
    kc = rng.randn(2, cache_len, 2, 16).astype(np.float32)
    vc = rng.randn(2, cache_len, 2, 16).astype(np.float32)
    positions = np.full((2, 1), pos, np.int32)
    want, ref_cache = RL.attention_block(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}, ref_cfg,
        positions=jnp.asarray(positions), window=window,
        cache={"k": jnp.asarray(kc), "v": jnp.asarray(vc)})
    cache = {"k": _t(kc), "v": _t(vc)}
    got, out_cache = TL.attention_block(
        _t(x), {k: _t(v) for k, v in p.items()}, cfg,
        positions=torch.from_numpy(positions), window=window, cache=cache,
        cache_pos=pos)
    assert out_cache is cache
    assert np.allclose(_np(got), _np(want), atol=1e-5)
    for k in ("k", "v"):
        assert np.allclose(_np(cache[k]), _np(ref_cache[k]), atol=1e-6)


@pytest.mark.parametrize("arch", ["qwen2-vl-7b", "gemma3-1b"])
def test_attention_prefill_cache_matches_reference(arch):
    """A prompt's k and v in the cache's layout: qwen2-vl's qkv bias and
    M-RoPE over three position streams, gemma3-1b's plain RoPE."""
    ref_p, p, ref_cfg, cfg = _slot(arch, "attn")
    rng = np.random.RandomState(7)
    B, S = 2, 11
    x = rng.randn(B, S, cfg.d_model).astype(np.float32)
    base = np.arange(S)[None] + rng.randint(0, 5, (B, 1))
    if cfg.mrope_sections:
        assert cfg.qkv_bias and "bk" in p
        pos = base[None] + rng.randint(0, 4, (3, B, 1))
    else:
        assert not cfg.qkv_bias
        pos = base
    want = RL.attention_prefill_cache(jnp.asarray(x), ref_p, ref_cfg,
                                      positions=jnp.asarray(pos))
    got = TL.attention_prefill_cache(_t(x), p, cfg,
                                     positions=torch.from_numpy(pos))
    assert set(got) == set(want) == {"k", "v"}
    for key in ("k", "v"):
        assert got[key].shape == (B, S, cfg.n_kv_heads, cfg.hd)
        assert np.allclose(_np(got[key]), _np(want[key]), atol=1e-5)


# --------------------------------------------------------------------------
# MLA, MoE and the Mamba2 mixer, in f32


def _slot(arch, key, **kw):
    """Slot 0's ``key`` subtree of the reduced ``arch``'s first period, as
    the reference's init_params draws it (f32): (jnp tree, torch tree),
    and both configs."""
    ref_cfg, cfg = _cfgs(arch, dtype="float32", **kw)
    tree = jax.tree.map(lambda a: np.asarray(a)[0], ref_init_params(
        ref_cfg, 0)["period_slots"][0][key])
    return (jax.tree.map(jnp.asarray, tree),
            jax.tree.map(lambda a: _t(a), tree), ref_cfg, cfg)


def test_attention_ref_scale_on_zero_padded_head_dims():
    """MLA's prefill through K4's contract: q and k at 24 and v at 16,
    zero-padded to 64 with the scale 1/sqrt(24), are the reference's
    naive attention on the unpadded operands; without ``scale``,
    attention_ref scales by 1/sqrt(D)."""
    rng = np.random.RandomState(7)
    q = rng.randn(2, 9, 4, 24).astype(np.float32)
    k = rng.randn(2, 9, 2, 24).astype(np.float32)
    v = rng.randn(2, 9, 2, 16).astype(np.float32)
    want = RL.naive_attention(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), causal=True)

    def pad(a):
        return torch.nn.functional.pad(_t(a), (0, 64 - a.shape[-1]))

    scale = 1.0 / math.sqrt(24)
    for fn in (attention_ref, flash_attention):
        out = fn(pad(q), pad(k), pad(v), causal=True, scale=scale)
        assert out.shape == (2, 9, 4, 64)
        assert torch.equal(out[..., 16:], torch.zeros_like(out[..., 16:]))
        assert np.allclose(_np(out[..., :16]), _np(want), atol=1e-5)
    assert torch.allclose(attention_ref(_t(q), _t(k), _t(k), causal=False),
                          attention_ref(_t(q), _t(k), _t(k), causal=False,
                                        scale=scale), atol=1e-6)


def _k4_spy(monkeypatch):
    """Record the operand shapes and scale of every call that reaches
    K4's prefill (``flash_attention``) from the model's layers."""
    calls = []

    def spy(q, k, v, **kw):
        calls.append((tuple(q.shape), tuple(k.shape), tuple(v.shape),
                      kw.get("scale")))
        return flash_attention(q, k, v, **kw)
    monkeypatch.setattr(TL, "flash_attention", spy)
    return calls


@pytest.mark.parametrize("q_lora", [32, 0])
@pytest.mark.parametrize("impl", ["naive", "blocked"])
def test_mla_block_prefill_matches_reference(impl, q_lora, monkeypatch):
    """The naive oracle, and K4's path (its plain version here), for
    dn + dr = 32, dv = 16, which is no pair K4 is built for: K4 receives
    q, k and v zero-padded to the pair (64, 64) and the scale 1/sqrt(32);
    with and without q's LoRA."""
    ref_p, p, ref_cfg, cfg = _slot("deepseek-v2-236b", "attn",
                                   attn_impl=impl, q_lora_rank=q_lora)
    assert ("wq_a" in p) == bool(q_lora)
    dk, dv = cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim
    assert (dk, dv) == (32, 16) and TL.k4_head_dims(dk, dv) == (64, 64)
    calls = _k4_spy(monkeypatch)
    rng = np.random.RandomState(8)
    x = rng.randn(2, 11, 64).astype(np.float32)
    pos = np.broadcast_to(np.arange(3, 14)[None], (2, 11))
    want, _ = RL.mla_block(jnp.asarray(x), ref_p, ref_cfg,
                           positions=jnp.asarray(pos))
    got, cache = TL.mla_block(_t(x), p, cfg,
                              positions=torch.from_numpy(pos.copy()))
    assert cache is None
    assert np.allclose(_np(got), _np(want), atol=1e-5)
    H = cfg.n_heads
    want_calls = [((2, 11, H, 64),) * 3 + (1.0 / math.sqrt(32),)]
    assert calls == (want_calls if impl == "blocked" else [])


def test_mla_block_prefill_at_full_width_head_dims_is_unpadded(monkeypatch):
    """At DeepSeek-V2's own head dims (dn 128 + dr 64, dv 128; the other
    widths reduced) K4 receives q and k at 192 and v at 128 as they are:
    no zero columns, no slice; the block matches the reference's."""
    ref_p, p, ref_cfg, cfg = _slot("deepseek-v2-236b", "attn",
                                   attn_impl="blocked", qk_nope_dim=128,
                                   qk_rope_dim=64, v_head_dim=128)
    assert TL.k4_head_dims(192, 128) == (192, 128)
    calls = _k4_spy(monkeypatch)
    rng = np.random.RandomState(9)
    x = rng.randn(2, 11, 64).astype(np.float32)
    pos = np.broadcast_to(np.arange(11)[None], (2, 11))
    want, _ = RL.mla_block(jnp.asarray(x), ref_p, ref_cfg,
                           positions=jnp.asarray(pos))
    got, _ = TL.mla_block(_t(x), p, cfg,
                          positions=torch.from_numpy(pos.copy()))
    assert np.allclose(_np(got), _np(want), atol=1e-5)
    H = cfg.n_heads
    assert calls == [((2, 11, H, 192), (2, 11, H, 192), (2, 11, H, 128),
                      1.0 / math.sqrt(192))]


@pytest.mark.parametrize("cache_len,pos", [(16, 9), (8, 11)])
def test_mla_block_absorbed_decode_matches_reference(cache_len, pos):
    """One absorbed decode step over a random latent cache, the second
    case past the cache's length (the write wraps to slot pos % 8): the
    same output, and the same cache after the in-place write."""
    ref_p, p, ref_cfg, cfg = _slot("deepseek-v2-236b", "attn")
    rng = np.random.RandomState(cache_len + pos)
    x = rng.randn(2, 1, 64).astype(np.float32)
    ckv = rng.randn(2, cache_len, cfg.kv_lora_rank).astype(np.float32)
    kr = rng.randn(2, cache_len, cfg.qk_rope_dim).astype(np.float32)
    positions = np.full((2, 1), pos, np.int32)
    want, ref_cache = RL.mla_block(
        jnp.asarray(x), ref_p, ref_cfg, positions=jnp.asarray(positions),
        cache={"ckv": jnp.asarray(ckv), "k_rope": jnp.asarray(kr)})
    cache = {"ckv": _t(ckv), "k_rope": _t(kr)}
    got, out_cache = TL.mla_block(_t(x), p, cfg,
                                  positions=torch.from_numpy(positions),
                                  cache=cache, cache_pos=pos)
    assert out_cache is cache
    assert np.allclose(_np(got), _np(want), atol=1e-5)
    for k in ("ckv", "k_rope"):
        assert np.allclose(_np(cache[k]), _np(ref_cache[k]), atol=1e-6)


@pytest.mark.parametrize("cf", [0.5, 8.0])
@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "deepseek-v2-236b"])
def test_moe_ffn_matches_reference(arch, cf):
    """16 padded experts, top-2, 16 tokens a row: at capacity factor 0.5
    (one slot an expert) tokens drop, the same ones as in the reference;
    at 8 none do.  deepseek adds its shared expert."""
    ref_p, p, ref_cfg, cfg = _slot(arch, "moe", moe_capacity_factor=cf)
    E = moe_experts_padded(cfg)
    assert E == 16 and ("shared" in p) == bool(cfg.moe_shared_ff)
    x = np.random.RandomState(9).randn(2, 16, 64).astype(np.float32)
    want = RL.moe_ffn(jnp.asarray(x), ref_p, ref_cfg, n_experts_padded=E)
    got = TL.moe_ffn(_t(x), p, cfg, n_experts_padded=E)
    assert np.allclose(_np(got), _np(want), atol=1e-5)
    if cf < 1:
        no_drop = TL.moe_ffn(_t(x), p, cfg.replace(moe_capacity_factor=8.0),
                             n_experts_padded=E)
        assert not torch.allclose(got, no_drop, atol=1e-3)


def _ssd_inputs(rng, dtype=np.float32):
    b, S, H, P_, G, N = 2, 64, 4, 8, 1, 16
    return (rng.randn(b, S, H, P_) * 0.5,
            -np.abs(rng.randn(b, S, H)) * 0.3,
            rng.randn(b, S, G, N) * 0.3, rng.randn(b, S, G, N) * 0.3)


@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_ssd_chunked_matches_reference(chunk):
    """The reference's ssd_chunked and both per-step oracles
    (tests/test_models.py holds the reference's at 1e-4)."""
    xh, a, Bm, Cm = (a.astype(np.float32)
                     for a in _ssd_inputs(np.random.RandomState(10)))
    want = RL.ssd_chunked(*map(jnp.asarray, (xh, a, Bm, Cm)), chunk)
    got = TL.ssd_chunked(*map(_t, (xh, a, Bm, Cm)), chunk)
    assert np.allclose(_np(got), _np(want), atol=1e-5)
    oracle = TL.ssd_reference(*map(_t, (xh, a, Bm, Cm)))
    assert np.allclose(_np(oracle), _np(RL.ssd_reference(
        *map(jnp.asarray, (xh, a, Bm, Cm)))), atol=1e-5)
    assert np.allclose(_np(got), _np(oracle), atol=1e-4)


def test_ssd_chunked_bf16_matches_reference():
    """bf16 inputs with an f32 decay, the reference's cast points."""
    xh, a, Bm, Cm = _ssd_inputs(np.random.RandomState(11))
    bf = [jnp.asarray(t, jnp.bfloat16) for t in (xh, Bm, Cm)]
    a32 = jnp.asarray(a, jnp.float32)
    want = RL.ssd_chunked(bf[0], a32, bf[1], bf[2], 16)
    got = TL.ssd_chunked(_t(bf[0], torch.bfloat16), _t(a32),
                         _t(bf[1], torch.bfloat16),
                         _t(bf[2], torch.bfloat16), 16)
    assert got.dtype == torch.bfloat16
    assert np.abs(_np(got) - _np(want)).max() <= BF16_ATOL


@pytest.mark.parametrize("cached", [False, True])
def test_causal_conv1d_matches_reference(cached):
    """Without a cache the window starts on zeros; with one it continues
    from the cache, which is shifted in place."""
    rng = np.random.RandomState(12)
    S = 1 if cached else 9
    x = rng.randn(2, S, 24).astype(np.float32)
    w = rng.randn(4, 24).astype(np.float32)
    c = rng.randn(2, 3, 24).astype(np.float32) if cached else None
    want, ref_cache = RL.causal_conv1d(
        jnp.asarray(x), jnp.asarray(w), None if c is None else jnp.asarray(c))
    cache = None if c is None else _t(c)
    got, out_cache = TL.causal_conv1d(_t(x), _t(w), cache)
    assert out_cache is cache
    assert np.allclose(_np(got), _np(want), atol=1e-6)
    if cached:
        assert np.array_equal(_np(cache), _np(ref_cache))


@pytest.mark.parametrize("S", [11, 16])
def test_mamba_block_prefill_matches_reference(S):
    """Chunk 8: 11 tokens pad the tail to 16, 16 fill two chunks."""
    ref_p, p, ref_cfg, cfg = _slot("mamba2-1.3b", "mamba")
    x = np.random.RandomState(13).randn(2, S, 64).astype(np.float32)
    want, _ = RL.mamba_block(jnp.asarray(x), ref_p, ref_cfg)
    got, cache = TL.mamba_block(_t(x), p, cfg)
    assert cache is None
    assert np.allclose(_np(got), _np(want), atol=1e-5)


def test_mamba_block_decode_matches_reference():
    """One decode step from a random conv window and state: the same
    output, and the same conv window and state, written in place."""
    ref_p, p, ref_cfg, cfg = _slot("mamba2-1.3b", "mamba")
    rng = np.random.RandomState(14)
    x = rng.randn(2, 1, 64).astype(np.float32)
    spec = cache_specs(cfg, 2, 4)["period_slots"][0]
    c0 = {k: rng.randn(*spec[k].shape[1:]).astype(np.float32)
          for k in ("conv", "state")}
    want, ref_cache = RL.mamba_block(
        jnp.asarray(x), ref_p, ref_cfg,
        cache={k: jnp.asarray(v) for k, v in c0.items()})
    cache = {k: _t(v) for k, v in c0.items()}
    got, out_cache = TL.mamba_block(_t(x), p, cfg, cache=cache)
    assert out_cache is cache
    assert np.allclose(_np(got), _np(want), atol=1e-5)
    for k in ("conv", "state"):
        assert np.allclose(_np(cache[k]), _np(ref_cache[k]), atol=1e-6)


# --------------------------------------------------------------------------
# whole forwards


def _forwards(arch, dtype, attn_impl="naive", decode=True, **kw):
    """{"prefill": (reference, port)} last-position logits of prefill_fn
    and, with ``decode``, {"decode": ...} the last step's logits of a
    decode loop over the same 12-token prompt."""
    B, S = 2, 12
    ref_cfg, cfg = _cfgs(arch, dtype=dtype, attn_impl=attn_impl, **kw)
    ref_params, params = _params(ref_cfg, cfg)
    ref_batch, batch = _batch(cfg, B, S, np.random.RandomState(0))
    _, ref_prefill, ref_decode = ref_build_forward(ref_cfg)
    _, prefill_fn, decode_fn = build_forward(cfg)
    out = {"prefill": (ref_prefill(ref_params, ref_batch),
                       prefill_fn(params, batch))}
    if decode:
        ref_cache = ref_zero_cache(ref_cfg, B, S)
        cache = zero_cache(cfg, B, S, "cpu")
        for i in range(S):
            ref_logits, ref_cache = ref_decode(
                ref_params, ref_cache,
                _step(ref_batch, i, B, cfg.mrope_sections, jnp))
            logits, cache = decode_fn(params, cache, _step(
                batch, i, B, cfg.mrope_sections, torch))
        out["decode"] = (ref_logits, logits)
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_forwards_match_reference(arch, dtype):
    """prefill_fn with naive attention and with K4 (its plain version
    here; the reference's pure-JAX blocked flash), and the decode loop,
    which runs K4's decode form."""
    out = _forwards(arch, dtype)
    out["prefill_blocked"] = _forwards(arch, dtype, attn_impl="blocked",
                                       decode=False)["prefill"]
    for name, (want, got) in out.items():
        w, g = _np(want), _np(got)
        assert g.shape == w.shape and np.isfinite(g).all()
        if dtype == "float32":
            assert np.allclose(g, w, **F32_TOL), (name, np.abs(g - w).max())
        else:
            assert np.abs(g - w).max() <= BF16_ATOL, (name,
                                                      np.abs(g - w).max())


def test_rolling_window_cache_decode_matches_reference():
    """gemma3's rolling window cache (window_cache): 12 steps through a
    window of 8, so the local layers' caches wrap."""
    out = _forwards("gemma3-1b", "float32", window_cache=True)
    for want, got in out.values():
        assert np.allclose(_np(got), _np(want), **F32_TOL)


# --------------------------------------------------------------------------
# serving


def _ref_serve_loop(cfg, params, tokens, gen):
    """repro.launch.serve's loop, returning the greedy ids and the logits
    after the prompt and after the last step."""
    B, S = tokens.shape
    decode = jax.jit(ref_build_forward(cfg)[2])
    cache = ref_zero_cache(cfg, B, S + gen)
    for i in range(S):
        logits, cache = decode(params, cache, {
            "tokens": jnp.asarray(tokens[:, i]).reshape(B, 1),
            "positions": jnp.full((B, 1), i, jnp.int32)})
    prompt_logits = logits[:, -1]
    toks = jnp.argmax(logits[:, -1], axis=-1)
    out = [toks]
    for i in range(S, S + gen):
        logits, cache = decode(params, cache, {
            "tokens": toks.reshape(B, 1),
            "positions": jnp.full((B, 1), i, jnp.int32)})
        toks = jnp.argmax(logits[:, -1], axis=-1)
        out.append(toks)
    return np.stack([np.asarray(t) for t in out], 1), prompt_logits, \
        logits[:, -1]


def _check_serve(arch, dtype):
    """launch.serve.serve on reduced ``arch`` against the reference's loop:
    in f32 the same greedy ids, so every step is teacher-forced, and the
    same logits; in bf16, whose near-ties may flip an id, the logits after
    the prompt."""
    ref_cfg, cfg = _cfgs(arch, dtype=dtype)
    ref_params, params = _params(ref_cfg, cfg)
    prompt = port_serve.make_prompt(cfg, 3, 10)
    ids, prompt_logits, logits = _ref_serve_loop(ref_cfg, ref_params,
                                                 prompt.tokens, 6)
    res = port_serve.serve(cfg, params, prompt, 6, "cpu")
    assert res.steps == 16 and res.tokens.shape == (3, 7)
    if dtype == "float32":
        assert np.array_equal(res.tokens.numpy(), ids)
        assert np.allclose(_np(res.logits), _np(logits), **F32_TOL)
        assert np.allclose(_np(res.prompt_logits), _np(prompt_logits),
                           **F32_TOL)
    else:
        assert np.abs(_np(res.prompt_logits)
                      - _np(prompt_logits)).max() <= BF16_ATOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_serve_matches_reference_loop(dtype):
    """Reduced gemma3-1b, past its window."""
    _check_serve("gemma3-1b", dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "mamba2-1.3b",
                                  "jamba-1.5-large-398b"])
def test_serve_families_match_reference_loop(arch, dtype):
    """MoE, Mamba2 and the hybrid (Mamba2, attention and MoE in one
    stack)."""
    _check_serve(arch, dtype)


def test_serve_cli_runs_on_cpu_and_wants_a_card_otherwise(capsys,
                                                          monkeypatch):
    port_serve.main(["--arch", "gemma3-1b", "--smoke", "--batch", "2",
                     "--prompt-len", "4", "--gen", "2", "--device", "cpu"])
    assert "sampled ids (greedy)" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_serve.main(["--arch", "gemma3-1b", "--smoke"])
