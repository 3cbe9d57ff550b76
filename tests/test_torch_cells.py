"""The shape cells' paths (``repro_torch.launch.cells``) against the
reference on the CPU: reduced configs (``reduced(...)``) at spans long
for them, f32, the weights carried across from the reference's
``init_params`` (``models.convert.params_from_numpy``), the same numpy
inputs and caches given to both.

- ``prefill_fn`` at S 512: 64 windows of 8 for gemma3-1b's local layers,
  64 SSD chunks of 8 for the Mamba2 layers (mamba2-1.3b, jamba);
- ``decode_fn`` at index 511 over a numpy-seeded cache of 512 slots,
  full, and for gemma3-1b with ``window_cache`` too, whose local layers'
  rolling caches of 8 slots have then wrapped 64 times;
- at ``tests/test_models.py``'s decode-against-prefill tolerance (atol
  2e-3, rtol 1e-3): both compute the same f32 expressions in another
  order;
- ``cells.cache_bytes`` and ``reckon``'s cache against the port's and the
  reference's ``cache_specs`` at every cell of the two archs the cells
  phase runs;
- ``cells.plain_rows`` (the row windows the cells phase holds K4's 32k
  launch to) against the plain version's rows over the whole sequence;
- ``cells.k4_limit`` (the hold at long spans) passing the plain output
  rounded to bf16 and failing the output over half the keys, which the
  absolute 3e-2 alone passes;
- K4's launch counters by form and shape (``ops.shape_launches``), which
  the cells phase reads each case's launches from;
- the launcher on ``--device cpu --smoke``, and its refusal without a
  card.
"""
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.models import build_forward as ref_build_forward  # noqa: E402
from repro.models import init_params as ref_init_params  # noqa: E402
from repro.models.model import cache_specs as ref_cache_specs  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels.flash.ref import attention_ref  # noqa: E402
from repro_torch.launch import cells  # noqa: E402
from repro_torch.models import build_forward  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.model import cache_specs  # noqa: E402

TOL = dict(atol=2e-3, rtol=1e-3)        # tests/test_models.py:83
S = 512
ARCHS = ("gemma3-1b", "mamba2-1.3b", "jamba-1.5-large-398b")
CELL_ARCHS = ("gemma3-1b", "mamba2-1.3b")


def _cfgs(arch, **kw):
    """The reduced f32 config of ``arch`` in both packages, with ``kw``."""
    return (ref_configs.reduced(ref_configs.ARCHS[arch]).replace(
                unroll_scans=True, dtype="float32", **kw),
            configs.reduced(configs.ARCHS[arch]).replace(dtype="float32",
                                                         **kw))


def _params(ref_cfg):
    ref = ref_init_params(ref_cfg, 0)
    return ref, params_from_numpy(jax.tree.map(np.asarray, ref), "cpu")


def _tree(spec, f):
    """``spec`` (dicts and lists of leaves) with f(leaf) at each leaf."""
    if isinstance(spec, dict):
        return {k: _tree(v, f) for k, v in spec.items()}
    if isinstance(spec, list):
        return [_tree(v, f) for v in spec]
    return f(spec)


def _close(got, want):
    g = got.float().numpy().reshape(want.shape)
    w = np.asarray(want, np.float32)
    assert np.isfinite(g).all() and np.allclose(g, w, **TOL), \
        np.abs(g - w).max()


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_at_long_span_matches_reference(arch):
    ref_cfg, cfg = _cfgs(arch)
    ref_params, params = _params(ref_cfg)
    toks = np.random.RandomState(1).randint(2, cfg.vocab, (2, S)).astype(
        np.int32)
    want = ref_build_forward(ref_cfg)[1](ref_params,
                                         {"tokens": jnp.asarray(toks)})
    got = build_forward(cfg)[1](params, {"tokens": torch.from_numpy(toks)})
    assert tuple(got.shape) == (2, 1, cfg.padded_vocab)
    _close(got, want)


@pytest.mark.parametrize("arch,window_cache", [
    ("gemma3-1b", False), ("gemma3-1b", True), ("mamba2-1.3b", False),
    ("jamba-1.5-large-398b", False)])
def test_decode_over_seeded_cache_matches_reference(arch, window_cache):
    """One step at index S - 1 over a cache of S slots whose every entry
    (K and V, conv and SSM state) is drawn from numpy: the cells' decode
    at their last prompt position, at reduced size."""
    ref_cfg, cfg = _cfgs(arch, window_cache=window_cache)
    ref_params, params = _params(ref_cfg)
    rng = np.random.RandomState(2)
    host = _tree(cache_specs(cfg, 2, S),
                 lambda p: rng.randn(*p.shape).astype(np.float32))
    ref_cache = jax.tree.map(jnp.asarray, host)
    cache = _tree(host, lambda a: torch.from_numpy(a.copy()))
    tok = rng.randint(2, cfg.vocab, (2, 1)).astype(np.int32)
    want, _ = ref_build_forward(ref_cfg)[2](ref_params, ref_cache, {
        "tokens": jnp.asarray(tok),
        "positions": jnp.full((2, 1), S - 1, jnp.int32)})
    got, _ = build_forward(cfg)[2](params, cache, {
        "tokens": torch.from_numpy(tok),
        "positions": torch.full((2, 1), S - 1, dtype=torch.int32)},
        index=S - 1)
    _close(got, want)


def _entries():
    out = []
    for arch, shape in configs.cells():
        if arch in CELL_ARCHS:
            out.append((arch, shape, False))
            if arch == "gemma3-1b" and configs.SHAPES[shape][2] == "decode":
                out.append((arch, shape, True))
    return out


@pytest.mark.parametrize("arch,shape,window_cache", _entries())
def test_reckoned_cache_bytes_are_cache_specs(arch, shape, window_cache):
    """At the cell's own batch and length, full width and depth (specs
    only, nothing allocated)."""
    seq, batch, kind = configs.SHAPES[shape]
    cfg = configs.ARCHS[arch].replace(window_cache=window_cache)
    ref_cfg = ref_configs.ARCHS[arch].replace(window_cache=window_cache)

    def nbytes(tree):
        leaves = jax.tree.leaves(tree, is_leaf=lambda x: hasattr(x, "shape"))
        return sum(math.prod(p.shape) * np.dtype(jnp.dtype(p.dtype)).itemsize
                   for p in leaves)

    got = cells.cache_bytes(cfg, batch, seq)
    assert got == nbytes(cache_specs(cfg, batch, seq))
    assert got == nbytes(ref_cache_specs(ref_cfg, batch, seq))
    need = cells.reckon(cfg, kind, batch, seq)
    assert need["cache"] == (cells.cache_bytes(
        cfg, batch, seq + cells.STEPS - 1) if kind == "decode" else 0)
    assert need["total"] == sum(v for k, v in need.items() if k != "total")


def test_reckoned_cache_bytes_are_the_issue_table():
    """gemma3-1b's caches at decode_32k: 26 layers x 1 KB a token full,
    4 global layers of 32768 slots and 22 local ones of 512 with the
    rolling window; mamba2's state a sequence."""
    g = configs.ARCHS["gemma3-1b"]
    assert cells.cache_bytes(g, 1, 32768) == 26 * 1024 * 32768
    assert cells.cache_bytes(g.replace(window_cache=True), 1, 32768) == \
        1024 * (4 * 32768 + 22 * 512)
    m = configs.ARCHS["mamba2-1.3b"]
    assert cells.cache_bytes(m, 1, 32768) == \
        48 * 2 * (64 * 128 * 64 + 3 * 4352)


@pytest.mark.parametrize("causal,window,lo,hi", [
    (True, None, 0, 24), (True, None, 40, 64), (True, 7, 20, 45),
    (True, 7, 0, 5), (False, None, 10, 30)])
def test_plain_rows_are_the_full_plain_rows(causal, window, lo, hi):
    rng = np.random.RandomState(3)
    q, k, v = (torch.from_numpy(rng.randn(2, 64, h, 16).astype(np.float32))
               for h in (4, 2, 2))
    full = attention_ref(q, k, v, causal=causal, window=window)
    rows = cells.plain_rows(q, k, v, lo, hi, causal=causal, window=window)
    assert torch.allclose(rows, full[:, lo:hi], atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("keys,B,blind", [(32768, 4, False),
                                          (131072, 1, True)])
def test_k4_limit_sees_half_the_keys_lost(keys, B, blind):
    """Decode at gemma3-1b's heads (H 4, Hkv 1, D 256) over a long span of
    unit normals: the plain output rounded to bf16 is within the limit;
    the output over the first half of the keys alone (a merge that lost
    half of its splits' partials) is not; at B 1 over 131072 keys it is
    within 3e-2 (``blind``: the absolute tolerance alone passes it)."""
    gen = torch.Generator().manual_seed(keys)
    q = torch.randn((B, 1, 4, 256), generator=gen)
    k, v = (torch.randn((B, keys, 1, 256), generator=gen) for _ in range(2))
    want = attention_ref(q, k, v, causal=False)
    limit = cells.k4_limit(want, 3e-2)
    assert limit < 3e-2
    assert (want.bfloat16().float() - want).abs().max() <= limit
    half = attention_ref(q, k[:, :keys // 2], v[:, :keys // 2],
                         causal=False)
    err = float((half - want).abs().max())
    assert limit < err and (err <= 3e-2) == blind
    assert cells.k4_limit(torch.full((2,), 10.0), 3e-2) == 3e-2


def test_shape_launches_sit_beside_the_form_counts():
    """A launch given its shape counts under its form and under its form
    and shape; the registry's reset clears both.  (A stand-in launcher:
    no card here.)"""
    from repro_torch.kernels import _build, registry
    from repro_torch.kernels.flash.ops import (KERNEL, form_launches,
                                               shape_launches)
    registry.reset_launch_counts()
    a, b = (2, 64, 64, 4, 1, 8, True), (2, 1, 64, 4, 1, None, False)
    for form, shape in (("prefill_wgmma", a), ("prefill_wgmma", a),
                        ("decode", b), ("decode", None)):
        _build.launch(KERNEL, lambda: 0, form=form, shape=shape)
    assert form_launches() == {"prefill_wgmma": 2, "prefill_simt": 0,
                               "decode": 2}
    assert shape_launches("prefill_wgmma") == {a: 2}
    assert shape_launches("decode") == {b: 1}
    assert cells.k4_counts()["k4_shapes"] == [
        ["prefill_wgmma", *a, 2], ["decode", *b, 1]]
    registry.reset_launch_counts()
    assert shape_launches("prefill_wgmma") == {} == shape_launches("decode")


@pytest.mark.parametrize("arch,shape", [
    (a, s) for a, s in configs.cells() if a in CELL_ARCHS])
def test_cells_launcher_on_the_cpu(arch, shape, capsys):
    line = cells.main(["--arch", arch, "--shape", shape, "--device", "cpu",
                       "--smoke"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == json.loads(json.dumps(line))
    seq, batch, kind = configs.SHAPES[shape]
    assert (line["arch"], line["shape"], line["kind"]) == (arch, shape, kind)
    assert line["seq"] == cells.SMOKE_SEQ and line["ref_batch"] == batch
    assert line["reduced"]["seq"] == [seq, cells.SMOKE_SEQ]
    assert line["host_ms"] > 0 and line["tokens_per_s"] > 0
    assert line["device_ms"] is None and line["k4_shapes"] == []


def test_cells_launcher_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cells.main(["--arch", "gemma3-1b", "--shape", "decode_32k",
                    "--smoke"])


def test_long_500k_is_skipped_outside_long_context_archs(capsys):
    assert cells.main(["--arch", "gemma-2b", "--shape", "long_500k",
                       "--device", "cpu", "--smoke"]) is None
    assert "SKIP" in capsys.readouterr().out
    with pytest.raises(ValueError, match="not a cell"):
        cells.run_cell("gemma-2b", "long_500k", device="cpu", smoke=True)
