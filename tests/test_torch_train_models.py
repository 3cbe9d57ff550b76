"""The port's model gradients against the reference's on the CPU: K4's
log-sum-exp (its plain version), the attention ``Function`` against
``jax.vjp`` of the reference's ``custom_vjp`` ``flash_attention``, and
``loss_fn`` with every gradient leaf against ``jax.value_and_grad`` on
every arch's reduced config (f32, ``attn_impl="blocked"``), on the same
numpy-seeded inputs.

Tolerances (f32, the same expressions in another order): the lse within
2e-6, attention gradients within 2e-5 of each tensor's largest (they
measure about 1e-6); the loss within 2e-6 and each gradient leaf within
2e-5 of the leaf's largest (they measure up to 6.8e-6, jamba's).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.models import build_forward as ref_build_forward  # noqa: E402
from repro.models import init_params as ref_init_params  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels.flash import flash_attention  # noqa: E402
from repro_torch.kernels.flash.ref import attention_ref  # noqa: E402
from repro_torch.models import build_forward, init_params  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.model import tree_leaves  # noqa: E402
from repro_torch.train.steps import value_and_grad  # noqa: E402

ALL_ARCHS = sorted(configs.ARCHS)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _rel_close(got, want, rel):
    g, w = _np(got), _np(want)
    assert g.shape == w.shape
    err = np.abs(g - w).max()
    assert err <= rel * np.abs(w).max() + 1e-12, (err, np.abs(w).max())


def _qkv(rng, B, S, H, Hkv, D, Dv=None):
    Dv = Dv or D
    return (rng.randn(B, S, H, D).astype(np.float32),
            rng.randn(B, S, Hkv, D).astype(np.float32),
            rng.randn(B, S, Hkv, Dv).astype(np.float32))


# --------------------------------------------------------------------------
# K4's log-sum-exp (the plain version: the CPU's) and the attention backward


@pytest.mark.parametrize("window,H,Hkv", [(None, 4, 4), (5, 4, 2),
                                          (None, 6, 2)])
def test_lse_matches_reference_blocked_attention(window, H, Hkv):
    q, k, v = _qkv(np.random.RandomState(0), 2, 40, H, Hkv, 16)
    _, ref_lse = RL.blocked_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), causal=True,
                                      window=window, block_kv=16)
    out, lse = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal=True,
                               window=window, return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (2, H, 40)
    assert np.allclose(_np(lse), np.asarray(ref_lse).reshape(2, H, 40),
                       atol=2e-6, rtol=0)
    plain = attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=True, window=window)
    assert torch.equal(out, plain)


def test_lse_of_rows_with_no_key_in_their_band():
    """Sq 12 against Skv 4 with window 3: rows 6.. see no key.  Their lse
    is -1e30 (+ log 4, lost in f32), the plain version's."""
    rng = np.random.RandomState(1)
    q = torch.from_numpy(rng.randn(1, 12, 2, 16).astype(np.float32))
    k = torch.from_numpy(rng.randn(1, 4, 2, 16).astype(np.float32))
    _, lse = attention_ref(q, k, k, causal=True, window=3, return_lse=True)
    assert torch.all(lse[:, :, 6:] == -1e30)
    assert torch.all(lse[:, :, :6] > -1e3)


def _ref_vjp(q, k, v, do, *, window, block_kv, scale=None):
    """(dq, dk, dv) of the reference's flash_attention, which scales by
    1/sqrt(q's head dim)."""
    args = tuple(jnp.asarray(a) for a in (q, k, v))
    _, vjp = jax.vjp(lambda a, b, c: RL.flash_attention(
        a, b, c, True, window, block_kv, False), *args)
    return vjp(jnp.asarray(do))


@pytest.mark.parametrize("case", ["causal", "window", "gqa", "ragged_block"])
def test_attention_function_grad_matches_reference_vjp(case):
    B, S, H, Hkv, D, window, block = {
        "causal": (2, 32, 4, 4, 16, None, 16),
        "window": (2, 32, 4, 4, 16, 7, 16),
        "gqa": (2, 24, 6, 2, 32, 9, 8),
        "ragged_block": (1, 40, 4, 1, 16, None, 16)}[case]
    rng = np.random.RandomState(2)
    q, k, v = _qkv(rng, B, S, H, Hkv, D)
    do = rng.randn(B, S, H, D).astype(np.float32)
    want = _ref_vjp(q, k, v, do, window=window, block_kv=block)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = TL.FlashAttention.apply(*ts, True, window, None, block)
    out.backward(torch.from_numpy(do))
    for t, w in zip(ts, want):
        _rel_close(t.grad, w, 2e-5)


@pytest.mark.parametrize("q_offset,window", [(12, None), (12, 5), (3, 9)])
def test_attention_function_grad_at_a_row_offset(q_offset, window):
    """The rows of a context-parallel rank: q's rows at q_offset against
    every key before them.  The gradients of q, k, v against the
    reference's flash_attention vjp on the rows after q_offset zero rows
    (the zero rows' cotangent 0)."""
    rng = np.random.RandomState(4)
    B, Sq, H, Hkv, D = 2, 16, 4, 2, 16
    Skv = q_offset + Sq
    q = rng.randn(B, Sq, H, D).astype(np.float32)
    _, k, v = _qkv(rng, B, Skv, H, Hkv, D)
    do = rng.randn(B, Sq, H, D).astype(np.float32)
    zeros = np.zeros((B, q_offset, H, D), np.float32)
    want = _ref_vjp(np.concatenate([zeros, q], 1), k, v,
                    np.concatenate([zeros, do], 1), window=window,
                    block_kv=8)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = TL.FlashAttention.apply(*ts, True, window, None, 8, q_offset)
    out.backward(torch.from_numpy(do))
    _rel_close(ts[0].grad, np.asarray(want[0])[:, q_offset:], 2e-5)
    for t, w in zip(ts[1:], want[1:]):
        _rel_close(t.grad, w, 2e-5)


def test_attention_function_grad_on_mla_padded_operands():
    """MLA's prefill as mla_block hands it to K4: q, k at dn + dr = 24 and
    v at 16, zero-padded to 64, scale 1/sqrt(24); the gradients of the
    unpadded operands against the reference's flash_attention on them."""
    rng = np.random.RandomState(3)
    B, S, H, dk, dv, dp = 2, 20, 4, 24, 16, 64
    q, k, v = _qkv(rng, B, S, H, H, dk, dv)
    do = rng.randn(B, S, H, dv).astype(np.float32)
    want = _ref_vjp(q, k, v, do, window=None, block_kv=8)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    padded = [torch.nn.functional.pad(t, (0, dp - t.shape[-1])) for t in ts]
    out = TL.FlashAttention.apply(*padded, True, None, 1.0 / math.sqrt(dk),
                                  8)[..., :dv]
    out.backward(torch.from_numpy(do))
    for t, w in zip(ts, want):
        _rel_close(t.grad, w, 2e-5)


def test_serving_calls_skip_the_function(monkeypatch):
    """prefill_fn on parameters that want no gradient makes K4's plain
    call; loss_fn under value_and_grad goes through FlashAttention once
    per attention layer."""
    calls = []
    real = TL.FlashAttention.apply
    monkeypatch.setattr(TL.FlashAttention, "apply",
                        lambda *a: (calls.append(1), real(*a))[1])
    cfg = configs.reduced(configs.ARCHS["gemma3-1b"]).replace(
        dtype="float32", attn_impl="blocked")
    params = init_params(cfg, 0, "cpu")
    loss_fn, prefill_fn, _ = build_forward(cfg)
    toks = torch.from_numpy(np.random.RandomState(0).randint(
        2, cfg.vocab, (2, 16)).astype(np.int32))
    prefill_fn(params, {"tokens": toks})
    assert calls == []
    value_and_grad(loss_fn, params, {"tokens": toks, "labels": toks})
    assert len(calls) == cfg.n_layers


# --------------------------------------------------------------------------
# loss_fn and every gradient leaf


def _batch(cfg, B, S, rng):
    if cfg.input_mode == "tokens":
        toks = rng.randint(2, cfg.vocab, (B, S)).astype(np.int32)
        ref, port = {"tokens": jnp.asarray(toks)}, {
            "tokens": torch.from_numpy(toks)}
    else:
        frames = (rng.randn(B, S, cfg.d_model) * 0.3).astype(np.float32)
        ref, port = {"tokens": jnp.asarray(frames)}, {
            "tokens": torch.from_numpy(frames)}
    labels = rng.randint(2, cfg.vocab, (B, S)).astype(np.int32)
    ref["labels"], port["labels"] = jnp.asarray(labels), torch.from_numpy(
        labels)
    if cfg.mrope_sections:
        pos = np.broadcast_to(np.arange(S)[None, None], (3, B, S)).astype(
            np.int32)
        ref["positions"] = jnp.asarray(pos)
        port["positions"] = torch.from_numpy(pos.copy())
    return ref, port


def _loss_and_grads(arch, S=16, **kw):
    kw = dict(dtype="float32", attn_impl="blocked", **kw)
    ref_cfg = ref_configs.reduced(ref_configs.ARCHS[arch]).replace(**kw)
    cfg = configs.reduced(configs.ARCHS[arch]).replace(**kw)
    ref_b, b = _batch(cfg, 2, S, np.random.RandomState(0))
    ref_l, ref_g = jax.jit(jax.value_and_grad(ref_build_forward(ref_cfg)[0]))(
        ref_init_params(ref_cfg, 0), ref_b)
    loss, grads = value_and_grad(build_forward(cfg)[0],
                                 init_params(cfg, 0, "cpu"), b)
    return (ref_l, ref_g), (loss, grads)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_loss_and_every_grad_leaf_match_reference(arch):
    (ref_l, ref_g), (loss, grads) = _loss_and_grads(arch)
    assert loss.dtype == torch.float32 and loss.dim() == 0
    assert abs(float(loss) - float(ref_l)) <= 2e-6
    got, want = list(tree_leaves(grads)), jax.tree.leaves(ref_g)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _rel_close(g, w, 2e-5)


def test_remat_matches_reference_remat():
    """gemma3-1b reduced to 7 layers (one period of 6 and a tail of one)
    with remat on in both packages: each period checkpointed, the same
    loss and gradients."""
    (ref_l, ref_g), (loss, grads) = _loss_and_grads(
        "gemma3-1b", n_layers=7, remat=True)
    assert abs(float(loss) - float(ref_l)) <= 2e-6
    for g, w in zip(tree_leaves(grads), jax.tree.leaves(ref_g)):
        _rel_close(g, w, 2e-5)


def test_remat_recomputes_each_period_once_in_the_backward(monkeypatch):
    """With remat, a period's attention runs twice a step (the forward and
    its recompute); the tail's once."""
    calls = []
    real = TL.FlashAttention.apply
    monkeypatch.setattr(TL.FlashAttention, "apply",
                        lambda *a: (calls.append(1), real(*a))[1])
    cfg = configs.reduced(configs.ARCHS["gemma3-1b"]).replace(
        dtype="float32", attn_impl="blocked", n_layers=7, remat=True)
    toks = torch.from_numpy(np.random.RandomState(0).randint(
        2, cfg.vocab, (2, 16)).astype(np.int32))
    loss, grads = value_and_grad(build_forward(cfg)[0],
                                 init_params(cfg, 0, "cpu"),
                                 {"tokens": toks, "labels": toks})
    assert len(calls) == 7 + 6
    off, _ = value_and_grad(build_forward(cfg.replace(remat=False))[0],
                            init_params(cfg, 0, "cpu"),
                            {"tokens": toks, "labels": toks})
    assert float(off) == float(loss)


@pytest.mark.parametrize("S,chunk", [(16, 4), (16, 256), (24, 8)])
def test_chunked_xent_matches_reference(S, chunk):
    rng = np.random.RandomState(4)
    cfg = configs.reduced(configs.ARCHS["gemma-2b"]).replace(dtype="float32")
    ref_cfg = ref_configs.reduced(ref_configs.ARCHS["gemma-2b"]).replace(
        dtype="float32")
    h = rng.randn(2, S, cfg.d_model).astype(np.float32)
    labels = rng.randint(0, cfg.vocab, (2, S)).astype(np.int32)
    ref_p = ref_init_params(ref_cfg, 0)
    want = RM.chunked_xent(ref_p, ref_cfg, jnp.asarray(h),
                           jnp.asarray(labels), chunk=chunk)
    p = init_params(cfg, 0, "cpu")
    ht = torch.from_numpy(h).requires_grad_(True)
    got = TM.chunked_xent(p, cfg, ht, torch.from_numpy(labels), chunk=chunk)
    assert abs(float(got) - float(want)) <= 2e-6
    got.backward()
    dh = jax.grad(lambda x: RM.chunked_xent(
        ref_p, ref_cfg, x, jnp.asarray(labels), chunk=chunk))(jnp.asarray(h))
    _rel_close(ht.grad, dh, 2e-5)


def test_ssd_gradient_stays_finite_where_the_reference_overflows():
    """The reduced jamba at head_dim 64 on these tokens: a chunk's decay
    passes e^88, and the reference's ssd_chunked, which masks after
    exp(cum_i - cum_j), gives NaN gradients (0 * inf above the diagonal);
    the port masks inside the exp: the same loss, finite gradients."""
    arch = "jamba-1.5-large-398b"
    kw = dict(dtype="float32", head_dim=64, attn_impl="blocked",
              moe_capacity_factor=8.0)
    ref_cfg = ref_configs.reduced(ref_configs.ARCHS[arch]).replace(**kw)
    cfg = configs.reduced(configs.ARCHS[arch]).replace(**kw)
    rng = np.random.RandomState(5)
    toks = rng.randint(2, cfg.vocab, (2, 16)).astype(np.int32)
    labels = rng.randint(2, cfg.vocab, (2, 16)).astype(np.int32)
    ref_l, ref_g = jax.jit(jax.value_and_grad(ref_build_forward(ref_cfg)[0]))(
        ref_init_params(ref_cfg, 0), {"tokens": jnp.asarray(toks),
                                      "labels": jnp.asarray(labels)})
    loss, grads = value_and_grad(build_forward(cfg)[0],
                                 init_params(cfg, 0, "cpu"),
                                 {"tokens": torch.from_numpy(toks),
                                  "labels": torch.from_numpy(labels)})
    assert abs(float(loss) - float(ref_l)) <= 2e-6
    assert any(np.isnan(np.asarray(g)).any() for g in jax.tree.leaves(ref_g))
    for g, w in zip(tree_leaves(grads), jax.tree.leaves(ref_g)):
        assert bool(torch.isfinite(g).all())
        w = np.asarray(w)
        if not np.isnan(w).any():
            _rel_close(g, w, 2e-5)
