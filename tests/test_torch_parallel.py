"""The port's distributed layer against the reference, on the CPU.

- The sharding mapper: every arch's parameter specs and decision log on
  both production meshes against ``repro.parallel.param_shardings`` (run
  in a subprocess with 512 host devices, as the reference's dry run
  does), its legality and fallback, and DTensor's order of shards on a
  dim split over two mesh axes against jax's ``devices_indices_map``.
- ``plan_1f1b`` against the reference's.
- On 8 gloo ranks as a 2x4 (data, model) mesh, in one job of 8
  processes (each with its own time limit; the job is joined with a
  timeout, so a dead rank fails the tests rather than hanging them):
  ``norm_dist`` against ``norm`` and the reference's norm (atol 1e-5, the
  reference test's); ``moe_ffn_a2a`` in reduced granite (f32, capacity
  factor 8): loss and every gradient leaf against the port's ``moe_ffn``
  and the reference's ``build_forward`` with ``jax.value_and_grad``
  (rtol 1e-5 / atol 1e-4, the reference test's); the collective recorder
  on a known all-gather and all-to-all; and the model on DTensors placed
  by the mapper (``shard`` and ``mesh``): loss, every gradient leaf,
  prefill and a decode loop against the same model without a mesh and
  against the reference's unsharded ``build_forward`` (loss and
  ``jax.value_and_grad``) on the same tokens.
  (The reference's own ``moe_ffn_a2a`` does not run under jax 0.9 here:
  ``with mesh:`` no longer sets the mesh, and under ``jax.set_mesh`` its
  layer scan and attention raise sharding type errors.)
- The dry run of reduced cells on a fake 2x4 process group.
"""
import json
import os
import subprocess
import sys
import tempfile
import textwrap

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.models import build_forward as ref_build_forward  # noqa: E402
from repro.models import init_params as ref_init_params  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.parallel.pipeline import plan_1f1b as ref_plan_1f1b  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.launch.mesh import MeshShape, production_shape  # noqa: E402
from repro_torch.models.model import tree_leaves  # noqa: E402
from repro_torch.parallel import param_shardings  # noqa: E402
from repro_torch.parallel.mapper import (ACT_RULES, PARAM_RULES,  # noqa: E402
                                         PartitionSpec, ShardingMapper,
                                         axis_sizes)
from repro_torch.parallel.pipeline import plan_1f1b  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
RANKS = 8
JOB_TIMEOUT = 420           # seconds for the whole gloo job

# the reference's param_shardings on both production meshes, and jax's
# device -> index map of three specs on a (2, 4) mesh
_REF_SCRIPT = textwrap.dedent("""
    import json
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs import ARCHS
    from repro.launch.mesh import make_production_mesh
    from repro.parallel import param_shardings

    def entry(e):
        return list(e) if isinstance(e, tuple) else e

    out = {"mapper": {}, "index_maps": []}
    for multi in (False, True):
        mesh = make_production_mesh(multi_pod=multi)
        for arch, cfg in sorted(ARCHS.items()):
            sh, mapper = param_shardings(cfg, mesh)
            specs = [[entry(e) for e in s.spec]
                     for s in jax.tree.leaves(sh)]
            out["mapper"][f"{arch}|{multi}"] = {
                "specs": specs, "decisions": mapper.decisions}
    mesh = jax.make_mesh((2, 4), ("data", "model"))
    for spec, shape in (((("data", "model"), None), (16, 4)),
                        ((None, ("data", "model")), (4, 16)),
                        (("model", "data"), (8, 4))):
        idx = NamedSharding(mesh, P(*spec)).devices_indices_map(shape)
        rows = [[[[s.start or 0, s.stop if s.stop is not None else n]
                  for s, n in zip(idx[mesh.devices[i, j]], shape)]
                 for j in range(4)] for i in range(2)]
        out["index_maps"].append({"spec": [entry(e) for e in spec],
                                  "shape": list(shape), "slices": rows})
    print("REF" + json.dumps(out))
""")


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512")
    proc = subprocess.run([sys.executable, "-c", _REF_SCRIPT], env=env,
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("REF")]
    return json.loads(line[-1][3:])


def _json_spec(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]


@pytest.mark.parametrize("multi", [False, True], ids=["pod", "multipod"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_mapper_specs_and_log_match_reference(reference, arch, multi):
    specs, mapper = param_shardings(ARCHS[arch],
                                    production_shape(multi_pod=multi))
    want = reference["mapper"][f"{arch}|{multi}"]
    got = [_json_spec(s) for s in tree_leaves(specs)]
    assert got == want["specs"]
    assert mapper.decisions == want["decisions"]


@given(st.integers(1, 4096), st.integers(1, 4096))
@settings(max_examples=50, deadline=None)
def test_mapper_specs_always_legal(d0, d1):
    """Meets-or-exceeds: the mapper never emits a spec whose axis size does
    not divide the dim; worst case it replicates (paper §2.4/§5.3)."""
    for mesh in (MeshShape((1, 1), ("data", "model")),
                 production_shape(multi_pod=True)):
        m = ShardingMapper(mesh, {**PARAM_RULES, **ACT_RULES})
        sizes = axis_sizes(mesh)
        for axes in (("embed", "ff"), ("act_batch", "kv_seq")):
            spec = m.resolve((d0, d1), axes)
            for dim, part in zip((d0, d1), spec):
                if part is None:
                    continue
                names = part if isinstance(part, tuple) else (part,)
                assert dim % int(np.prod([sizes[a] for a in names])) == 0


def test_mapper_fallback_logged():
    m = ShardingMapper(MeshShape((16,), ("model",)), {"heads": [("model",)]})
    assert m.resolve((3,), ("heads",)) == PartitionSpec(None)
    assert m.decisions == ["heads: dim 3 !% any of [('model',)] -> "
                           "replicate (meets-or-exceeds fallback)"]
    # act_batch falls back from (pod, data) to data, logged once
    m = ShardingMapper(production_shape(multi_pod=True), dict(ACT_RULES))
    assert m.resolve((16, 8), ("act_batch", None)) == PartitionSpec(
        "data", None)
    m.resolve((16, 8), ("act_batch", None))
    assert m.decisions == ["act_batch: dim 16 -> fallback ('data',)"]


@pytest.mark.parametrize("bwd_factor", [1, 2])
@pytest.mark.parametrize("p", [2, 4, 8])
def test_plan_1f1b_matches_reference(p, bwd_factor):
    for lat in (None, [3] + [1] * (p - 2) + [2], list(range(p, 0, -1))):
        got = plan_1f1b(p, 16, lat, bwd_factor=bwd_factor)
        want = ref_plan_1f1b(p, 16, lat, bwd_factor=bwd_factor)
        assert got.__dict__ == want.__dict__
    assert plan_1f1b(p, 16).stash_per_stage == list(range(p, 0, -1))


# --------------------------------------------------------------------------
# 8 gloo ranks as a (2, 4) mesh

_RANK_SCRIPT = textwrap.dedent("""
    import datetime, json, os, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.experimental import implicit_replication

    rank, out = int(os.environ["RANK"]), sys.argv[1]
    dist.init_process_group("gloo", rank=rank, world_size=8,
                            timeout=datetime.timedelta(seconds=120))
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.models import build_forward, init_params
    from repro_torch.models.layers import norm, norm_dist
    from repro_torch.models.model import (cache_specs, param_specs,
                                          tree_leaves, tree_map, zero_cache)
    from repro_torch.parallel import collective_bytes
    from repro_torch.parallel.mapper import (PartitionSpec, ShardingMapper,
                                             choose_rules)
    from repro_torch.parallel.spmd import to_mesh
    from repro_torch.train import value_and_grad
    res = {}

    def np_(t):
        t = t.full_tensor() if hasattr(t, "full_tensor") else t
        return t.detach().float().numpy()

    # DTensor's shards of a dim split over two axes, and of two dims
    for name, spec, shape in (
            ("dm0", PartitionSpec(("data", "model"), None), (16, 4)),
            ("dm1", PartitionSpec(None, ("data", "model")), (4, 16)),
            ("md", PartitionSpec("model", "data"), (8, 4))):
        g = torch.arange(int(np.prod(shape)), dtype=torch.float32)
        res["shard_" + name] = to_mesh(g.reshape(shape), mesh,
                                       spec).to_local().numpy()

    # norm_dist against norm
    rng = np.random.RandomState(0)
    x = torch.tensor(rng.randn(4, 8, 64), dtype=torch.float32)
    s = torch.tensor(rng.randn(64) * 0.1, dtype=torch.float32)
    for ln in (True, False):
        cfg = reduced(ARCHS["command-r-plus-104b"]).replace(
            dtype="float32", use_layernorm=ln)
        res[f"norm_{ln}"] = (norm(x, s, cfg).numpy(),
                             norm_dist(x, s, cfg, mesh).numpy())

    # the collective recorder on a known all-gather and all-to-all
    group = mesh.get_group("model")
    import torch.distributed._functional_collectives as funcol
    with collective_bytes() as rec:
        funcol.wait_tensor(funcol.all_gather_tensor(
            torch.ones(4, 8), 0, group))
        funcol.wait_tensor(funcol.all_to_all_single(
            torch.ones(8, 8), None, None, group))
        out_t = torch.empty(8, 2)
        dist.all_to_all_single(out_t, torch.ones(8, 2), group=group)
    res["recorder"] = (rec.counts, rec.calls)

    # moe_ffn_a2a in reduced granite against moe_ffn
    cfg = reduced(ARCHS["granite-moe-3b-a800m"]).replace(
        dtype="float32", moe_capacity_factor=8.0)
    params = init_params(cfg, 0, "cpu")
    rng = np.random.RandomState(0)
    B, S = 4, 16
    batch = {"tokens": torch.tensor(rng.randint(2, cfg.vocab, (B, S)),
                                    dtype=torch.int32),
             "labels": torch.tensor(rng.randint(2, cfg.vocab, (B, S)),
                                    dtype=torch.int32)}
    l1, g1 = value_and_grad(build_forward(cfg)[0], params, batch)
    with collective_bytes() as rec:
        l2, g2 = value_and_grad(build_forward(
            cfg.replace(moe_impl="a2a"), mesh=mesh)[0], params, batch)
    res["a2a"] = (float(l1), [np_(g) for g in tree_leaves(g1)],
                  float(l2), [np_(g) for g in tree_leaves(g2)],
                  rec.calls.get("all-to-all", 0))

    # the model on DTensors placed by the mapper, against no mesh
    for arch, kw in (("gemma3-1b", {"n_heads": 2, "n_kv_heads": 1}),
                     ("granite-moe-3b-a800m", {}), ("mamba2-1.3b", {}),
                     ("deepseek-v2-236b", {})):
        cfg = reduced(ARCHS[arch]).replace(
            dtype="float32", attn_impl="blocked", remat=True,
            moe_capacity_factor=8.0, **kw)
        rules, notes = choose_rules(cfg, mesh)
        mapper = ShardingMapper(mesh, rules)
        mapper.decisions.extend(notes)
        params = init_params(cfg, 0, "cpu")

        def place(t, p):
            return to_mesh(t, mesh, mapper.resolve(p.shape, p.axes))

        def placed_batch(b):
            return {k: to_mesh(v, mesh, mapper.resolve(
                v.shape, ("act_batch", None))) for k, v in b.items()}

        dparams = tree_map(place, params, param_specs(cfg))
        loss_fn, prefill_fn, decode_fn = build_forward(cfg)
        d_loss, d_prefill, d_decode = build_forward(
            cfg, shard=mapper.shard, mesh=mesh)
        row = {"decisions": mapper.decisions}
        la, ga = value_and_grad(loss_fn, params, batch)
        with implicit_replication():
            lb, gb = value_and_grad(d_loss, dparams, placed_batch(batch))
        row["loss"] = (float(la), float(np_(lb)))
        row["grads"] = [(np_(a), np_(b)) for a, b in zip(
            tree_leaves(ga), tree_leaves(gb))]
        with torch.no_grad():
            tok = {"tokens": batch["tokens"]}
            pa = prefill_fn(params, tok)
            with implicit_replication():
                pb = d_prefill(dparams, placed_batch(tok))
            row["prefill"] = (np_(pa), np_(pb))
            ca = zero_cache(cfg, B, S, "cpu")
            cb = tree_map(place, zero_cache(cfg, B, S, "cpu"),
                          cache_specs(cfg, B, S))
            for i in range(S):
                sb = {"tokens": batch["tokens"][:, i:i + 1],
                      "positions": torch.full((B, 1), i, dtype=torch.int32)}
                oa, ca = decode_fn(params, ca, sb, index=i)
                with implicit_replication():
                    ob, cb = d_decode(dparams, cb, placed_batch(sb), index=i)
            row["decode"] = (np_(oa), np_(ob))
        res["model_" + arch] = row
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    dist.destroy_process_group()
""")


@pytest.fixture(scope="module")
def gloo():
    """Each rank's results of _RANK_SCRIPT on 8 gloo ranks."""
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    out = tempfile.mkdtemp(prefix="gloo_")
    procs, logs = [], []
    for r in range(RANKS):
        env = dict(os.environ, PYTHONPATH=SRC, RANK=str(r),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   OMP_NUM_THREADS="1")
        log = open(os.path.join(out, f"rank{r}.log"), "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _RANK_SCRIPT, out], env=env, cwd=ROOT,
            stdout=log, stderr=subprocess.STDOUT))
    try:
        for p in procs:
            p.wait(timeout=JOB_TIMEOUT)
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        tail = open(os.path.join(out, f"rank{failed[0]}.log")).read()[-3000:]
        pytest.fail(f"gloo ranks {failed} failed or timed out:\n{tail}")
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(RANKS)]


def test_dtensor_shard_order_matches_jax(reference, gloo):
    """A dim split over (data, model) is split data-major, as jax's
    PartitionSpec(("data", "model")): each rank's shard is the slice jax's
    device at the same mesh position holds."""
    for case, name in zip(reference["index_maps"], ("dm0", "dm1", "md")):
        g = np.arange(int(np.prod(case["shape"])), dtype=np.float32
                      ).reshape(case["shape"])
        for r in range(RANKS):
            sl = case["slices"][r // 4][r % 4]
            want = g[tuple(slice(a, b) for a, b in sl)]
            np.testing.assert_array_equal(gloo[r]["shard_" + name], want)


@pytest.mark.parametrize("ln", [True, False], ids=["layernorm", "rmsnorm"])
def test_norm_dist_matches_norm(gloo, ln):
    rng = np.random.RandomState(0)
    x = rng.randn(4, 8, 64).astype(np.float32)
    s = (rng.randn(64) * 0.1).astype(np.float32)
    cfg = ref_configs.reduced(ref_configs.ARCHS["command-r-plus-104b"]
                              ).replace(dtype="float32", use_layernorm=ln)
    ref = np.asarray(RL.norm(x, s, cfg))
    for r in range(RANKS):
        local, dist_ = gloo[r][f"norm_{ln}"]
        np.testing.assert_allclose(dist_, local, atol=1e-5, rtol=0)
        np.testing.assert_allclose(dist_, ref, atol=1e-5, rtol=0)


def test_collective_recorder_counts_result_bytes(gloo):
    counts, calls = gloo[0]["recorder"]
    # all-gather of (4, 8) f32 over 4 ranks: a (16, 8) result; all-to-all
    # of (8, 8) f32 and, eagerly, of (8, 2) f32: their results
    assert counts["all-gather"] == 16 * 8 * 4
    assert counts["all-to-all"] == 8 * 8 * 4 + 8 * 2 * 4
    assert counts["total"] == counts["all-gather"] + counts["all-to-all"]
    assert calls == {"all-gather": 1, "all-to-all": 2}


def test_moe_a2a_matches_moe_ffn_and_reference(gloo):
    cfg = ref_configs.reduced(ref_configs.ARCHS["granite-moe-3b-a800m"]
                              ).replace(dtype="float32",
                                        moe_capacity_factor=8.0)
    rng = np.random.RandomState(0)
    B, S = 4, 16
    batch = {"tokens": jax.numpy.asarray(rng.randint(2, cfg.vocab, (B, S)),
                                         jax.numpy.int32),
             "labels": jax.numpy.asarray(rng.randint(2, cfg.vocab, (B, S)),
                                         jax.numpy.int32)}
    ref_l, ref_g = jax.value_and_grad(ref_build_forward(cfg)[0])(
        ref_init_params(cfg, 0), batch)
    ref_g = [np.asarray(g, np.float32) for g in jax.tree.leaves(ref_g)]
    for r in range(RANKS):
        l1, g1, l2, g2, n_a2a = gloo[r]["a2a"]
        # a layer: three in the forward (payload, metadata, the return),
        # two in the backward (the payload's and the return's reverse)
        assert n_a2a == 5 * cfg.n_layers
        for loss, grads in ((l1, g1), (l2, g2)):
            np.testing.assert_allclose(loss, float(ref_l), rtol=1e-5)
            assert len(grads) == len(ref_g)
            for a, b in zip(grads, ref_g):
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(l2, l1, rtol=1e-5)
        for a, b in zip(g2, g1):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-4)


# the four reduced archs of _RANK_SCRIPT's model on a mesh, their widths
MESH_ARCHS = {"gemma3-1b": {"n_heads": 2, "n_kv_heads": 1},
              "granite-moe-3b-a800m": {}, "mamba2-1.3b": {},
              "deepseek-v2-236b": {}}


def _reference_forwards(arch):
    """The reference's loss, ``jax.grad`` leaves, prefill logits and the
    last logits of a decode loop, unsharded, on _RANK_SCRIPT's tokens."""
    from repro.launch.serve import zero_cache as ref_zero_cache
    jnp = jax.numpy
    cfg = ref_configs.reduced(ref_configs.ARCHS[arch]).replace(
        dtype="float32", attn_impl="blocked", remat=True,
        moe_capacity_factor=8.0, **MESH_ARCHS[arch])
    vocab = ref_configs.reduced(
        ref_configs.ARCHS["granite-moe-3b-a800m"]).vocab
    rng = np.random.RandomState(0)
    B, S = 4, 16
    tokens = jnp.asarray(rng.randint(2, vocab, (B, S)), jnp.int32)
    labels = jnp.asarray(rng.randint(2, vocab, (B, S)), jnp.int32)
    params = ref_init_params(cfg, 0)
    loss_fn, prefill_fn, decode_fn = ref_build_forward(cfg)
    loss, grads = jax.value_and_grad(loss_fn)(
        params, {"tokens": tokens, "labels": labels})
    out = {"loss": float(loss),
           "grads": [np.asarray(g, np.float32)
                     for g in jax.tree.leaves(grads)],
           "prefill": np.asarray(prefill_fn(params, {"tokens": tokens}),
                                 np.float32)}
    cache = ref_zero_cache(cfg, B, S)
    for i in range(S):
        logits, cache = decode_fn(params, cache, {
            "tokens": tokens[:, i:i + 1],
            "positions": jnp.full((B, 1), i, jnp.int32)})
    out["decode"] = np.asarray(logits, np.float32)
    return out


@pytest.mark.parametrize("arch", sorted(MESH_ARCHS))
def test_model_on_mesh_matches_local(gloo, arch):
    """The model on DTensors (the mapper's placements and shard hook): the
    loss, every gradient leaf, the prefill logits and a decode loop
    within f32 rounding (the loss within 2e-6, the rest within 2e-5 of
    each leaf's largest) of the model without a mesh and of the
    reference's unsharded ``build_forward`` with ``jax.value_and_grad``.
    gemma3 runs with 2 heads on the model axis of 4: the context-parallel
    layout."""
    ref = _reference_forwards(arch)
    for r in range(RANKS):
        row = gloo[r]["model_" + arch]
        if arch == "gemma3-1b":
            assert any("context-parallel" in d for d in row["decisions"])
        a, b = row["loss"]
        assert abs(a - b) <= 2e-6
        assert abs(b - ref["loss"]) <= 2e-6
        assert len(row["grads"]) == len(ref["grads"]) > 0
        pairs = row["grads"] + [row["prefill"], row["decode"]]
        wants = ref["grads"] + [ref["prefill"], ref["decode"]]
        for (a, b), want in zip(pairs, wants):
            assert a.shape == b.shape == want.shape
            assert np.abs(a - b).max() <= 2e-5 * np.abs(a).max() + 1e-12
            assert (np.abs(b - want).max()
                    <= 2e-5 * np.abs(want).max() + 1e-12)


# --------------------------------------------------------------------------
# the dry run on a fake 2x4 process group

_DRYRUN_SCRIPT = textwrap.dedent("""
    import json
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.launch.dryrun import fake_mesh, lower_cell
    from repro_torch.models.model import (DTYPES, param_specs, tree_leaves,
                                          tree_map)
    from repro_torch.optim import adamw_init
    from repro_torch.train import build_serve_steps, build_train_step
    from repro_torch.train.steps import input_specs
    mesh = fake_mesh((2, 4), ("data", "model"))
    cfg = reduced(ARCHS["gemma3-1b"]).replace(attn_impl="blocked",
                                              remat=True)
    out = {}
    for kind in ("train", "prefill", "decode"):
        art = lower_cell(cfg, "reduced", False, mesh=mesh,
                         shape=(32, 4, kind))
        # the same step unsharded, on fake tensors, under FlopCounterMode
        with FakeTensorMode():
            params = tree_map(lambda p: torch.empty(
                p.shape, dtype=DTYPES[p.dtype]), param_specs(cfg))
            spec = input_specs(cfg, "", 32, 4, kind)
            fake = lambda t: torch.zeros(t.shape, dtype=t.dtype)
            b = {k: fake(v) for k, v in spec["batch"].items()}
            with FlopCounterMode(display=False) as fc:
                if kind == "train":
                    build_train_step(cfg)(params, adamw_init(params), b)
                elif kind == "prefill":
                    with torch.no_grad():
                        build_serve_steps(cfg)[0](params, b)
                else:
                    cache = tree_map(fake, spec["cache"])
                    with torch.no_grad():
                        build_serve_steps(cfg)[1](params, cache, b, index=31)
        art["unsharded_flops"] = fc.get_total_flops()
        out[kind] = art
    print("DRY" + json.dumps(out))
""")

_FIELDS = ("arch", "shape", "kind", "mesh", "n_chips", "seq", "batch",
           "t_lower_s", "t_compile_s", "flops_per_device", "bytes_per_device",
           "collective_bytes_per_device", "collectives", "compute_s",
           "memory_s", "collective_s", "dominant", "model_flops_global",
           "useful_flops_ratio", "memory_analysis", "hbm_gb", "fits_hbm_80g",
           "mapper_decisions", "params_global", "params_active",
           "extrapolation")


@pytest.fixture(scope="module")
def dryrun():
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", _DRYRUN_SCRIPT], env=env,
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("DRY")]
    return json.loads(line[-1][3:])


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_dryrun_reduced_cell(dryrun, kind):
    art = dryrun[kind]
    assert all(f in art for f in _FIELDS)
    assert art["kind"] == kind and art["n_chips"] == 8
    assert art["extrapolation"] == {"mode": "exact"}
    assert art["flops_per_device"] * 8 >= art["unsharded_flops"] > 0
    mem = art["memory_analysis"]
    assert mem["argument_size_in_bytes"] > 0 and mem["temp_size_in_bytes"] > 0
    coll = art["collectives"]
    assert coll["total"] == sum(v for k, v in coll.items() if k != "total")
    # the mapper splits weights over data (embed) and model: they are
    # gathered; a training step reduce-scatters its partial sums
    assert coll.get("all-gather", 0) > 0
    if kind == "train":
        assert coll.get("reduce-scatter", 0) > 0
    assert art["compute_s"] > 0 and art["memory_s"] > 0


def test_dryrun_cli_writes_artifact(tmp_path):
    """The CLI on a production cell (gemma3-1b x train_4k, 256 fake ranks)
    cut to one layer; long_500k of a full-attention arch is skipped."""
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "gemma3-1b", "--shape", "train_4k", "--override", "n_layers=1",
         "--out", str(tmp_path), "--tag", "t"], env=env, cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    art = json.loads((tmp_path / "gemma3-1b__train_4k__pod__t.json"
                      ).read_text())
    assert all(f in art for f in _FIELDS) and art["tag"] == "t"
    assert art["n_chips"] == 256 and art["mesh"] == "16x16"
    assert any("context-parallel" in d for d in art["mapper_decisions"])
    from repro_torch.launch import dryrun
    assert dryrun.main(["--arch", "qwen2-72b", "--shape", "long_500k",
                        "--out", str(tmp_path / "skip")]) is None
    assert not (tmp_path / "skip").exists()
