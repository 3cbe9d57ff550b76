"""The port's training substrate (repro_torch.data, .optim, .checkpoint,
.train, .launch.train) against the reference's (repro.data, .optim,
.checkpoint, .train) on the CPU, on the same numpy-seeded inputs.

Tolerances: the data stream is bit-equal.  f32 optimizer updates agree
within 1e-6 relative (both compute the same f32 expressions; they measure
about 1e-7), and bf16 parameters within one bf16 ulp (the f32 values
before the cast may straddle a rounding boundary).  Checkpoints carry
every leaf exactly, in both directions.  A train step of the reduced
gemma3-1b in f32 agrees within 2e-6 on the loss, 1e-5 relative on the
gradient norm, and 1e-5 of each leaf's largest on the gradients it hands
to AdamW (they measure about 2e-6; int8 compression may move a value on
a rounding boundary by one code).  The new parameters are not compared
after two independent steps: AdamW's mh / (sqrt(vh) + 1e-8) divides out
a gradient's size, so a 1e-6 relative difference in a small element
moves its parameter by up to lr times that ratio (3.7e-6 measured on 1
element in 6,144); the test instead holds AdamW of the captured
gradients to the reference's.
"""
import os
import signal

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import checkpoint as ref_ckpt  # noqa: E402
from repro import configs as ref_configs  # noqa: E402
from repro import optim as ref_optim  # noqa: E402
from repro.data import pipeline as ref_data  # noqa: E402
from repro.models import init_params as ref_init_params  # noqa: E402
from repro.train import steps as ref_steps  # noqa: E402
from repro_torch import checkpoint as ckpt  # noqa: E402
from repro_torch import configs, optim  # noqa: E402
from repro_torch.data import pipeline as data  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.model import tree_leaves  # noqa: E402
from repro_torch.train import steps  # noqa: E402


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _bf16_ulp(x):
    """One bf16 ulp at |x| (8 bits of mantissa)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 1e-30)))
    return 2.0 ** (e - 7)


# --------------------------------------------------------------------------
# data


@pytest.mark.parametrize("mode", ["tokens", "embeddings"])
@pytest.mark.parametrize("step,lo,hi", [(0, 0, 8), (5, 0, 8), (5, 2, 6),
                                        (1234567, 3, 4)])
def test_batch_at_is_the_references_bit_for_bit(mode, step, lo, hi):
    kw = dict(seq_len=37, global_batch=8, vocab=1000, seed=3,
              input_mode=mode, d_model=12)
    got = data._batch_at(data.DataConfig(**kw), step, lo, hi)
    want = ref_data._batch_at(ref_data.DataConfig(**kw), step, lo, hi)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert np.array_equal(got[k], want[k])


def test_make_dataset_matches_reference_stream():
    kw = dict(seq_len=16, global_batch=4, vocab=300, seed=1)
    it = data.make_dataset(data.DataConfig(**kw), start_step=3, device="cpu")
    ref_it = ref_data.make_dataset(ref_data.DataConfig(**kw), start_step=3)
    for _ in range(4):
        got, want = next(it), next(ref_it)
        for k in want:
            assert got[k].device.type == "cpu"
            assert np.array_equal(got[k].numpy(), np.asarray(want[k]))
    it.close()
    ref_it.close()


def test_make_dataset_takes_this_process_rows(monkeypatch):
    """Rank 1 of 2 (torch.distributed) makes rows [2, 4) of each global
    batch of 4, as the reference's process 1 of 2 does."""
    dist = torch.distributed
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    monkeypatch.setattr(dist, "get_rank", lambda: 1)
    cfg = data.DataConfig(seq_len=8, global_batch=4, vocab=50)
    it = data.make_dataset(cfg, start_step=2, device="cpu")
    for step in (2, 3):
        got = next(it)
        want = ref_data._batch_at(ref_data.DataConfig(
            seq_len=8, global_batch=4, vocab=50), step, 2, 4)
        assert np.array_equal(got["tokens"].numpy(), want["tokens"])
        assert np.array_equal(got["labels"].numpy(), want["labels"])
    it.close()


# --------------------------------------------------------------------------
# optimizers


def _trees(dtype, rng):
    """A parameter tree (a stacked 3-D leaf, matrices, vectors, a
    NamedTuple-free nest of dicts and lists) and three gradient trees."""
    shapes = {"a": (3, 8, 5), "b": [{"w": (6, 4)}, {"w": (6, 4)}],
              "n": (7,), "s": (1,)}

    def draw(scale):
        def leaf(shape):
            return rng.randn(*shape).astype(np.float32) * scale
        return {"a": leaf(shapes["a"]),
                "b": [{"w": leaf((6, 4))}, {"w": leaf((6, 4))}],
                "n": leaf((7,)), "s": leaf((1,))}

    p = draw(0.5)
    gs = [draw(0.1 * (i + 1)) for i in range(3)]
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    ref_p = jax.tree.map(lambda a: jnp.asarray(a, jdt), p)
    port_p = jax.tree.map(lambda a: torch.from_numpy(a).to(tdt), p)
    ref_g = [jax.tree.map(lambda a: jnp.asarray(a, jdt), g) for g in gs]
    port_g = [jax.tree.map(lambda a: torch.from_numpy(a).to(tdt), g)
              for g in gs]
    return ref_p, port_p, ref_g, port_g


def _close(got, want, dtype):
    g, w = _np(got), _np(want)
    if dtype == "bfloat16" and got.dtype == torch.bfloat16:
        assert np.all(np.abs(g - w) <= _bf16_ulp(w)), np.abs(g - w).max()
    else:
        assert np.allclose(g, w, rtol=1e-6, atol=1e-7), np.abs(g - w).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(dtype):
    ref_p, p, ref_gs, gs = _trees(dtype, np.random.RandomState(0))
    ref_st, st = ref_optim.adamw_init(ref_p), optim.adamw_init(p)
    for ref_g, g in zip(ref_gs, gs):
        kw = dict(lr=3e-2, clip_norm=0.5)
        ref_p, ref_st, ref_n = ref_optim.adamw_update(ref_p, ref_g, ref_st,
                                                      **kw)
        p, st, n = optim.adamw_update(p, g, st, **kw)
        assert np.allclose(float(n), float(ref_n), rtol=1e-6)
        assert int(st.step) == int(ref_st.step)
        assert st.step.dtype == torch.int32
        for a, b in zip(tree_leaves(p), jax.tree.leaves(ref_p)):
            assert str(a.dtype).split(".")[-1] == str(b.dtype)
            _close(a, b, dtype)
        for a, b in zip(tree_leaves((st.mu, st.nu)),
                        jax.tree.leaves((ref_st.mu, ref_st.nu))):
            assert a.dtype == torch.float32
            _close(a, b, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adafactor_update_matches_reference(dtype):
    ref_p, p, ref_gs, gs = _trees(dtype, np.random.RandomState(1))
    ref_st, st = ref_optim.adafactor_init(ref_p), optim.adafactor_init(p)
    for a, b in zip(tree_leaves((st.vr, st.vc)),
                    jax.tree.leaves((ref_st.vr, ref_st.vc))):
        assert tuple(a.shape) == b.shape
    for ref_g, g in zip(ref_gs, gs):
        ref_p, ref_st = ref_optim.adafactor_update(ref_p, ref_g, ref_st,
                                                   lr=2e-2)
        p, st = optim.adafactor_update(p, g, st, lr=2e-2)
        for a, b in zip(tree_leaves(p), jax.tree.leaves(ref_p)):
            _close(a, b, dtype)
        for a, b in zip(tree_leaves((st.vr, st.vc)),
                        jax.tree.leaves((ref_st.vr, ref_st.vc))):
            _close(a, b, "float32")


def test_adamw_and_adafactor_converge():
    """The reference's quadratic (tests/test_substrate.py)."""
    target = torch.tensor([0.5, 0.5, 0.5])
    for which in ("adamw", "adafactor"):
        p = {"w": torch.tensor([1.0, -2.0, 3.0])}
        st = getattr(optim, f"{which}_init")(p)
        for _ in range(400):
            g = {"w": 2 * (p["w"] - target)}
            if which == "adamw":
                p, st, _ = optim.adamw_update(p, g, st, lr=3e-2,
                                              weight_decay=0.0)
            else:
                p, st = optim.adafactor_update(p, g, st, lr=5e-2)
        assert float(((p["w"] - target) ** 2).sum()) < 5e-2


# --------------------------------------------------------------------------
# checkpoints


def _ckpt_trees(rng):
    """(reference tree, port tree): bf16 and f32 parameters in dicts and
    lists, and an AdamW state (0-d int32 step, f32 moments)."""
    w = rng.randn(4, 8).astype(np.float32)
    n = rng.randn(3).astype(np.float32)
    ref_p = {"w": jnp.asarray(w, jnp.bfloat16), "nested": [jnp.asarray(n)]}
    p = {"w": torch.from_numpy(w).to(torch.bfloat16),
         "nested": [torch.from_numpy(n)]}
    ref_st = ref_optim.adamw_init(ref_p)._replace(
        step=jnp.asarray(7, jnp.int32),
        mu=jax.tree.map(lambda a: a.astype(jnp.float32) * 0.5, ref_p))
    st = optim.adamw_init(p)._replace(
        step=torch.tensor(7, dtype=torch.int32),
        mu=jax.tree.map(lambda a: a.float() * 0.5, p))
    return (ref_p, ref_st), (p, st)


def _same_leaves(port_tree, ref_tree):
    a, b = list(tree_leaves(port_tree)), jax.tree.leaves(ref_tree)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert str(x.dtype).split(".")[-1] == str(y.dtype)
        assert tuple(x.shape) == tuple(y.shape)
        assert np.array_equal(_np(x), np.asarray(y, np.float32))


def test_checkpoint_written_by_reference_restores_in_port(tmp_path):
    ref_tree, tree = _ckpt_trees(np.random.RandomState(0))
    ref_ckpt.save_checkpoint(str(tmp_path), 3, ref_tree)
    assert ckpt.latest_step(str(tmp_path)) == 3
    back = ckpt.restore_checkpoint(str(tmp_path), 3, tree)
    assert isinstance(back[1], optim.AdamWState)
    _same_leaves(back, ref_tree)


def test_checkpoint_written_by_port_restores_in_reference(tmp_path):
    ref_tree, tree = _ckpt_trees(np.random.RandomState(1))
    ckpt.save_checkpoint(str(tmp_path), 4, tree)
    assert sorted(os.listdir(tmp_path / "step_4")) == [
        "COMMIT", "manifest.json", "proc0.npz"]
    assert ref_ckpt.latest_step(str(tmp_path)) == 4
    back = ref_ckpt.restore_checkpoint(str(tmp_path), 4, ref_tree)
    _same_leaves(tree, back)
    # the manifest's leaves, as the reference writes them
    ref_dir = tmp_path / "ref"
    ref_ckpt.save_checkpoint(str(ref_dir), 4, ref_tree)
    import json
    got = json.loads((tmp_path / "step_4" / "manifest.json").read_text())
    want = json.loads((ref_dir / "step_4" / "manifest.json").read_text())
    assert {k: got[k] for k in ("step", "n_leaves", "leaves")} == \
        {k: want[k] for k in ("step", "n_leaves", "leaves")}


def test_checkpoint_retention_commit_and_latest_as_reference(tmp_path):
    """Five saves keep the last three; a directory without COMMIT and a
    .tmp directory are ignored; the same in both packages."""
    for mod, sub in ((ckpt, "port"), (ref_ckpt, "ref")):
        d = tmp_path / sub
        tree = ({"w": torch.ones(2)} if mod is ckpt
                else {"w": jnp.ones((2,))})
        for s in [1, 2, 3, 4, 5]:
            mod.save_checkpoint(str(d), s, tree)
        os.makedirs(d / "step_99")
        os.makedirs(d / "step_100.tmp")
        (d / "step_100.tmp" / "COMMIT").write_text("ok")
    listing = {sub: sorted(os.listdir(tmp_path / sub))
               for sub in ("port", "ref")}
    assert listing["port"] == listing["ref"]
    assert ckpt.latest_step(str(tmp_path / "port")) == 5
    assert ckpt.latest_step(str(tmp_path / "empty")) is None
    with pytest.raises(FileNotFoundError, match="uncommitted"):
        ckpt.restore_checkpoint(str(tmp_path / "port"), 99, {"w": None})


def test_async_save_snapshots_before_returning(tmp_path):
    tree = {"w": torch.arange(6, dtype=torch.float32),
            "b": torch.ones(3, dtype=torch.bfloat16)}
    ckpt.async_save(str(tmp_path), 1, tree)
    tree["w"].add_(100.0)                     # after the snapshot
    ckpt.async_save(str(tmp_path), 2, tree)   # joins the first save
    ckpt.wait_for_save()
    back1 = ckpt.restore_checkpoint(str(tmp_path), 1, tree)
    back2 = ckpt.restore_checkpoint(str(tmp_path), 2, tree)
    assert torch.equal(back1["w"], torch.arange(6, dtype=torch.float32))
    assert torch.equal(back2["w"], tree["w"])
    assert back1["b"].dtype == torch.bfloat16


# --------------------------------------------------------------------------
# the train step


def _train_batch(cfg, B, S, seed):
    rng = np.random.RandomState(seed)
    toks = rng.randint(2, cfg.vocab, (B, S)).astype(np.int32)
    labels = rng.randint(2, cfg.vocab, (B, S)).astype(np.int32)
    return ({"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)},
            {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)})


def _torch_state(ref_p, ref_st):
    """The reference's parameters and AdamW state as the port's."""
    tree = jax.tree.map(np.asarray, (ref_p, ref_st.mu, ref_st.nu))
    p, mu, nu = params_from_numpy(tree, "cpu")
    return p, optim.AdamWState(
        torch.tensor(int(ref_st.step), dtype=torch.int32), mu, nu)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("microbatch", [1, 2])
def test_train_step_matches_reference(microbatch, int8, monkeypatch):
    """Two steps of the reduced gemma3-1b (f32, blocked attention), each
    from the reference's parameters and state: the loss, the gradient
    norm, the gradients the step hands to AdamW, and the new parameters
    as AdamW makes them from those gradients.  Both optimizers' inputs are
    captured by wrapping each step's AdamW for the test (the reference's
    ``adamw_update``, the port's in-place ``adamw_update_``); the port's
    step gets its own copy of the state, which it updates in place."""
    kw = dict(dtype="float32", attn_impl="blocked")
    ref_cfg = ref_configs.reduced(ref_configs.ARCHS["gemma3-1b"]).replace(
        **kw)
    cfg = configs.reduced(configs.ARCHS["gemma3-1b"]).replace(**kw)
    real_ref, real = ref_steps.adamw_update, steps.adamw_update_
    monkeypatch.setattr(ref_steps, "adamw_update", lambda p, g, st: (
        *real_ref(p, g, st)[:2], (real_ref(p, g, st)[2], g)))
    seen = []
    monkeypatch.setattr(steps, "adamw_update_", lambda p, g, st: (
        seen.append(g), real(p, g, st))[1])
    ref_step = jax.jit(ref_steps.build_train_step(
        ref_cfg, opts=ref_steps.StepOptions(microbatch=microbatch,
                                            grad_compress_int8=int8)))
    step = steps.build_train_step(cfg, opts=steps.StepOptions(
        microbatch=microbatch, grad_compress_int8=int8))
    ref_p = ref_init_params(ref_cfg, 0)
    ref_st = ref_optim.adamw_init(ref_p)
    ref_b, b = _train_batch(cfg, 4, 16, 2)
    for _ in range(2):
        p, st = _torch_state(ref_p, ref_st)
        new_p, new_st, m = step(*_torch_state(ref_p, ref_st), b)
        ref_p, ref_st, ref_m = ref_step(ref_p, ref_st, ref_b)
        ref_gnorm, ref_g = ref_m["gnorm"]
        assert abs(float(m["loss"]) - float(ref_m["loss"])) <= 2e-6
        assert np.isclose(float(m["gnorm"]), float(ref_gnorm), rtol=1e-5)
        # the gradients: within 1e-5 of each leaf's largest; with int8
        # compression a value on a rounding boundary may take the next
        # code, so within one code (max|g| / 127) more
        for g, r in zip(tree_leaves(seen[-1]), jax.tree.leaves(ref_g)):
            r = np.asarray(r)
            tol = 1e-5 * np.abs(r).max() + 1e-12
            if int8:
                tol += np.abs(r).max() / 127.0
            assert np.abs(_np(g) - r).max() <= tol
        # AdamW of those gradients: exactly the step's new parameters, and
        # from the reference's gradients the reference's, within
        # test_adamw_update_matches_reference's tolerance
        again = optim.adamw_update(p, seen[-1], st)[0]
        for a, c in zip(tree_leaves(new_p), tree_leaves(again)):
            assert torch.equal(a, c)
        from_ref = optim.adamw_update(
            p, params_from_numpy(jax.tree.map(np.asarray, ref_g), "cpu"),
            st)[0]
        for a, r in zip(tree_leaves(from_ref), jax.tree.leaves(ref_p)):
            _close(a, r, "float32")
        assert int(new_st.step) == int(ref_st.step)


def test_int8_compression_rounds_half_to_even():
    g = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.4])
    want = np.asarray(ref_steps._int8_compress_grads(
        {"g": jnp.asarray(g.numpy())})["g"])
    got = steps._int8_compress_grads({"g": g})["g"]
    assert np.array_equal(got.numpy(), want)


def test_value_and_grad_gives_zeros_for_unread_leaves():
    def loss_fn(p, _):
        return (p["a"] ** 2).sum()
    params = {"a": torch.ones(3), "unread": torch.ones(2)}
    loss, g = steps.value_and_grad(loss_fn, params, None)
    assert float(loss) == 3.0
    assert torch.equal(g["a"], torch.full((3,), 2.0))
    assert torch.equal(g["unread"], torch.zeros(2))
    assert params["a"].grad is None and not params["a"].requires_grad


# --------------------------------------------------------------------------
# the launcher


def _launch(tmp_path, name, steps_, extra=()):
    return launch_train.main([
        "--arch", "gemma3-1b", "--smoke", "--steps", str(steps_),
        "--batch", "4", "--seq", "32", "--ckpt-every", "3",
        "--log-every", "100", "--ckpt-dir", str(tmp_path / name),
        "--device", "cpu", *extra])


def test_launch_train_resumes_to_the_uninterrupted_losses(tmp_path):
    """A run stopped at its step-3 checkpoint and resumed reproduces the
    losses and the parameters of an uninterrupted 6-step run."""
    whole = _launch(tmp_path, "whole", 6)
    assert len(whole.losses) == 6 and np.all(np.isfinite(whole.losses))
    assert ckpt.latest_step(str(tmp_path / "whole")) == 6
    assert os.path.exists(tmp_path / "whole" / "step_3" / "COMMIT")
    assert os.path.exists(tmp_path / "whole" / "heartbeat_0")
    first = _launch(tmp_path, "split", 3)
    assert first.end_step == 3
    second = _launch(tmp_path, "split", 6)
    assert second.start_step == 3
    assert first.losses + second.losses == whole.losses
    for a, b in zip(tree_leaves(second.params), tree_leaves(whole.params)):
        assert torch.equal(a, b)


def test_launch_train_saves_and_stops_on_sigterm(tmp_path, monkeypatch):
    real = launch_train.build_train_step

    def build(cfg):
        step = real(cfg)
        calls = []

        def wrapped(*a):
            calls.append(1)
            if len(calls) == 2:
                signal.raise_signal(signal.SIGTERM)
            return step(*a)
        return wrapped

    monkeypatch.setattr(launch_train, "build_train_step", build)
    before = signal.getsignal(signal.SIGTERM)
    res = _launch(tmp_path, "term", 10)
    assert res.end_step == 2 and len(res.losses) == 2
    assert ckpt.latest_step(str(tmp_path / "term")) == 2
    assert signal.getsignal(signal.SIGTERM) == before

