"""Sharded execution in the PyTorch port (ROADMAP A7), on the CPU with D
shards on one device (``make_serving_mesh(D, devices=("cpu",) * D)``):
the same code and the same exchanges run on a D-GPU machine with shard d
on ``cuda:d``.

Held bit for bit to the port's single-device path (the packer moves whole
CB superblocks and keeps tile slots, and the CPU sums in a fixed order):
`run_propagation` and chains of `make_superstep` for every backend at
D = 2 and 4 in the three gather modes, with a NaN planted in a row that
another shard's frame reads; the serving engine with the cache off and
on (and cached == cold); checkpointed offline inference, also killed at
every superstep and resumed, and its CLI with ``--shards 2``. Held to the
JAX package's sharded engine (a subprocess with 8 host devices) under the
threshold-margin rule of tests/torch_parity.py, one D and gather mode per
backend. `distributed_series` is held to the host `propagated_series`
(atol 2e-3, as the JAX package's test holds its own), and
`distributed_nap_distances` to numpy (rtol 1e-5)."""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.gnn.models import GNNConfig as JConfig
from repro.gnn.models import init_classifiers as j_init

from repro_torch.gnn import (GNNConfig, NAIConfig, load_dataset,
                             params_from_numpy, propagated_series)
from repro_torch.gnn.backends import (BACKENDS, GATHER_MODES, get_backend,
                                      make_superstep, normalize_mesh,
                                      run_propagation, shard_operands,
                                      split_rows)
from repro_torch.gnn.distributed import (distributed_nap_distances,
                                         distributed_series, pack_graph)
from repro_torch.gnn.nai import decision_distances
from repro_torch.gnn.packing import shard_batch_perm, shard_row_perm
from repro_torch.gnn.store import make_graph, save_graph_store
from repro_torch.launch.full_graph_infer import (EXIT_PREEMPTED,
                                                 OfflineConfig,
                                                 PreemptionSimulated,
                                                 first_step_distance_quantile,
                                                 run_full_graph_infer)
from repro_torch.launch.mesh import make_mesh, make_serving_mesh
from repro_torch.serving import NAIServingEngine, ServingFrontend
from repro_torch.serving.frontend import SLOClass

from torch_parity import (assert_orders_match, near_threshold,
                          plant_remote_nonfinite, sharded_pack_pair,
                          small_graph, step_operands)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
IMPLS = sorted(BACKENDS)
BATCH = 32
# every gather mode at D = 2, and the halo modes at D = 4 (dense at D = 4
# is covered by the propagation and superstep tests)
ENGINE_CASES = [(2, "halo"), (2, "dense"), (2, "alltoall"), (4, "halo"),
                (4, "alltoall")]
OFFLINE_GRAPH = dict(n=800, avg_deg=6.0, alpha=2.2, seed=3, path=None,
                     feat_dim=24, num_classes=5)


def cpu_mesh(D):
    return make_serving_mesh(D, devices=("cpu",) * D)


def same_bits(a, b) -> bool:
    """Bitwise equality, NaN payloads included."""
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


@pytest.fixture(scope="module")
def setup():
    g = small_graph(load_dataset)
    kw = dict(k=2, hidden=32, mlp_layers=2)
    jcfg = JConfig("sgc", 64, g.num_classes, **kw)
    cfg = GNNConfig("sgc", 64, g.num_classes, **kw)
    params = j_init(jcfg, jax.random.PRNGKey(0))
    tree = {l: {k: np.asarray(v) for k, v in p.items()}
            for l, p in params.items()}
    heads = params_from_numpy(cfg, tree, device="cpu")
    nai = NAIConfig(t_s=6.0, t_min=1, t_max=2, batch_size=BATCH)
    rng = np.random.default_rng(0)
    stream = [rng.choice(g.test_idx, size=s, replace=False)
              for s in (32, 30, 32, 28)]
    return dict(g=g, cfg=cfg, heads=heads, tree=tree, nai=nai,
                stream=stream)


# ------------------------------------------------------------- meshes
def test_make_serving_mesh_needs_the_gpus(monkeypatch):
    """Without ``devices=`` the mesh takes cuda:0..D-1 and raises when
    fewer GPUs exist: nothing drops to the CPU or serves fewer shards."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for n in (0, 1, 2, 4):
        with pytest.raises(ValueError, match="GPUs available"):
            make_serving_mesh(n)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="only 1 GPUs"):
        make_serving_mesh(2)
    with pytest.raises(ValueError, match="only 1 GPUs"):
        make_mesh(("cuda:1",), {"data": 1})


def test_mesh_from_explicit_devices():
    m = cpu_mesh(4)
    assert m.axis_names == ("data",) and m.shape == {"data": 4}
    assert m.devices == (torch.device("cpu"),) * 4
    assert str(m) == "mesh data=4 on (cpu x4)"
    with pytest.raises(ValueError, match="got 2 devices"):
        make_serving_mesh(4, devices=("cpu",) * 2)
    m2 = make_mesh(("cpu",) * 4, {"data": 2, "model": 2})
    assert m2.shape == {"data": 2, "model": 2}
    with pytest.raises(ValueError, match="do not fill"):
        make_mesh(("cpu",) * 3, {"data": 2, "model": 2})


def test_normalize_mesh():
    assert normalize_mesh(None) is None
    assert normalize_mesh(cpu_mesh(1)) is None       # the plain path
    m = cpu_mesh(2)
    assert normalize_mesh(m) is m
    with pytest.raises(ValueError, match="'data' mesh axis"):
        normalize_mesh(make_mesh(("cpu",) * 2, {"model": 2}))
    with pytest.raises(ValueError, match="'data' only"):
        normalize_mesh(make_mesh(("cpu",) * 4, {"data": 2, "model": 2}))


# -------------------------------------------------------- propagation
def _pack_pair(g, impl, D, gather_mode, **kw):
    return sharded_pack_pair(g, impl, D, gather_mode, **kw)


_ops = step_operands


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("gather_mode", GATHER_MODES)
def test_sharded_propagation_bitwise(setup, impl, D, gather_mode):
    nai = setup["nai"]
    be, base, sh = _pack_pair(setup["g"], impl, D, gather_mode)
    eo1, s1 = run_propagation(be, nai, _ops(be, base, 2), base.x0,
                              base.n_batch, device="cpu")
    eo2, s2 = run_propagation(be, nai, _ops(be, sh, 2), sh.x0, sh.n_batch,
                              mesh=cpu_mesh(D), gather_mode=gather_mode)
    perm = torch.from_numpy(shard_batch_perm(sh.n_batch, D))
    assert same_bits(eo2[perm], eo1) and same_bits(s2[:, perm], s1)
    assert set(eo1[:base.nb_real].tolist()) == {1, 2}
    if gather_mode != "dense":
        assert sh.halo_frac < 1.0


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("gather_mode", GATHER_MODES)
def test_nan_in_a_row_another_shard_reads(setup, impl, gather_mode):
    """A NaN planted in x0 at a row of shard 1 that an edge of shard 0
    reads travels through the exchange (and, on the tile backends, the
    exchanged non-finite flags): the sharded loop equals the single-device
    loop bit for bit, NaN payloads included."""
    nai = setup["nai"]
    D = 2
    be, base, sh = _pack_pair(setup["g"], impl, D, gather_mode, seed=1)
    x_b, x_sh = plant_remote_nonfinite(base, sh)
    eo1, s1 = run_propagation(be, nai, _ops(be, base, 2), x_b,
                              base.n_batch, device="cpu")
    eo2, s2 = run_propagation(be, nai, _ops(be, sh, 2), x_sh, sh.n_batch,
                              mesh=cpu_mesh(D), gather_mode=gather_mode)
    perm = torch.from_numpy(shard_batch_perm(sh.n_batch, D))
    assert same_bits(eo2[perm], eo1) and same_bits(s2[:, perm], s1)
    assert torch.isnan(s1).any()               # it reached the batch


def _graph_pair(impl, D, gather_mode, store):
    """Full-graph (offline) packs at D = 1 and D shards, one geometry."""
    _, ref = pack_graph(store, D, 0.5, impl, stationary=True)
    geom = dict(nb_bucket=ref.n_batch, s_bucket=ref.n_pad,
                tb_bucket=ref.tiles.shape[1] or None)
    be, base = pack_graph(store, 1, 0.5, impl, stationary=True, **geom)
    _, sh = pack_graph(store, D, 0.5, impl, stationary=True,
                       halo=gather_mode != "dense", **geom)
    return be, base, sh


@pytest.fixture(scope="module")
def offline():
    store = make_graph(**OFFLINE_GRAPH)
    t_s = first_step_distance_quantile(store, 0.5, 0.5)
    cfg = GNNConfig("sgc", store.feat_dim, store.num_classes, k=3, r=0.5,
                    hidden=16, mlp_layers=2)
    from repro_torch.gnn import init_classifiers
    heads = init_classifiers(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    return dict(store=store, cfg=cfg, heads=heads,
                nai=NAIConfig(t_s=t_s, t_min=1, t_max=3))


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("gather_mode", GATHER_MODES)
def test_sharded_superstep_chain_bitwise(offline, impl, gather_mode):
    """A chain of sharded supersteps (state per shard, operands placed
    once) equals the single-device chain bit for bit at every step, also
    resumed from a host copy of step 1."""
    nai, D = offline["nai"], 2
    be, base, sh = _graph_pair(impl, D, gather_mode, offline["store"])
    mesh = cpu_mesh(D)
    step1 = make_superstep(be, nai, n_batch=base.n_batch,
                           n_rows=base.n_pad, device="cpu")
    stepd = make_superstep(be, nai, n_batch=sh.n_batch, n_rows=sh.n_pad,
                           mesh=mesh, gather_mode=gather_mode)
    ops1 = _ops(be, base, 3)
    opsd = shard_operands(_ops(be, sh, 3), mesh.devices)
    row_perm = torch.from_numpy(shard_row_perm(sh.n_pad, D))
    bat_perm = torch.from_numpy(shard_batch_perm(sh.n_batch, D))
    x1 = torch.from_numpy(base.x0)
    e1 = torch.zeros(base.n_batch, dtype=torch.int32)
    xd = split_rows(sh.x0, mesh.devices)
    ed = split_rows(np.zeros(sh.n_batch, np.int32), mesh.devices)
    for l in range(1, 4):
        x1, e1 = step1(ops1, x1, e1, l)
        xd, ed = stepd(opsd, xd, ed, l)
        assert same_bits(torch.cat(xd)[row_perm], x1), l
        assert same_bits(torch.cat(ed)[bat_perm], e1), l
        if l == 1:     # resume from a host round trip, operands re-split
            xd = split_rows(torch.cat(xd).numpy().copy(), mesh.devices)
            opsd = _ops(be, sh, 3)
    assert set(torch.where(e1 == 0, 3, e1).tolist()) == {1, 2, 3}


def test_validation_errors(setup):
    nai, g = setup["nai"], setup["g"]
    be, base, sh = _pack_pair(g, "segment", 2, "halo")
    with pytest.raises(ValueError, match="cannot run single-device"):
        run_propagation(be, nai, _ops(be, sh, 2), sh.x0, sh.n_batch,
                        device="cpu")
    with pytest.raises(ValueError, match="disagree"):
        run_propagation(be, nai, _ops(be, sh, 2), sh.x0, sh.n_batch,
                        mesh=cpu_mesh(2), gather_mode="dense")
    _, _, dense = _pack_pair(g, "segment", 2, "dense")
    for gm in ("halo", "alltoall"):
        with pytest.raises(ValueError, match="disagree"):
            run_propagation(be, nai, _ops(be, dense, 2), dense.x0,
                            dense.n_batch, mesh=cpu_mesh(2), gather_mode=gm)
    with pytest.raises(ValueError, match="multiples of CB\\*D"):
        run_propagation(be, nai, _ops(be, base, 2), base.x0, base.n_batch,
                        mesh=cpu_mesh(4))
    with pytest.raises(ValueError, match="multiples of CB\\*D"):
        make_superstep(be, nai, n_batch=256, n_rows=384, mesh=cpu_mesh(2))
    for fn in (lambda: run_propagation(be, nai, {}, base.x0, base.n_batch,
                                       device="cpu", gather_mode="ragged"),
               lambda: make_superstep(be, nai, n_batch=8, n_rows=128,
                                      device="cpu", gather_mode="ring")):
        with pytest.raises(ValueError, match="unknown gather_mode"):
            fn()
    step = make_superstep(get_backend("fused"), nai, n_batch=sh.n_batch,
                          n_rows=sh.n_pad, mesh=cpu_mesh(2),
                          gather_mode="halo")
    with pytest.raises(ValueError, match="missing operands"):
        step({k: v for k, v in _ops(be, sh, 2).items()}, sh.x0,
             np.zeros(sh.n_batch, np.int32), 1)
    with pytest.raises(ValueError, match="first device"):
        run_propagation(be, nai, {}, sh.x0, sh.n_batch, mesh=cpu_mesh(2),
                        device="meta")
    # the engine: a mesh needs compiled mode; gather modes are checked
    with pytest.raises(ValueError, match="mode='compiled'"):
        NAIServingEngine(setup["cfg"], nai, setup["heads"], g, mode="host",
                         mesh=cpu_mesh(2))
    with pytest.raises(ValueError, match="unknown gather_mode"):
        NAIServingEngine(setup["cfg"], nai, setup["heads"], g,
                         mode="compiled", gather_mode="ragged",
                         device="cpu")
    with pytest.raises(ValueError, match="'data' mesh axis"):
        NAIServingEngine(setup["cfg"], nai, setup["heads"], g,
                         mode="compiled",
                         mesh=make_mesh(("cpu",) * 2, {"model": 2}))


# ------------------------------------------------------------ serving
def _serve(eng, stream):
    done = []
    for nodes in stream:
        eng.submit(nodes)
        done += eng.step()
    done += eng.flush()
    assert [r.status for r in done] == ["completed"] * len(done)
    return (np.array([r.node_id for r in done]),
            np.array([r.prediction for r in done]),
            np.array([r.exit_order for r in done]))


def _engine(s, impl, mesh=None, **kw):
    return NAIServingEngine(s["cfg"], s["nai"], s["heads"], s["g"],
                            device=None if mesh else "cpu",
                            max_wait_s=10.0, mode="compiled",
                            spmm_impl=impl, mesh=mesh, **kw)


@pytest.fixture(scope="module")
def single(setup):
    return {impl: _serve(_engine(setup, impl), setup["stream"])
            for impl in IMPLS}


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("D,gather_mode", ENGINE_CASES)
def test_sharded_engine_equals_single_device(setup, single, impl, D,
                                             gather_mode):
    """Pipelined sharded serving == serial single-device serving: the same
    completion order, predictions and exit orders; the halo frame shrinks
    the exchange; a steady pass allocates no pack buffer."""
    eng = _engine(setup, impl, cpu_mesh(D), pipeline_depth=2,
                  gather_mode=gather_mode)
    assert (eng.n_shards, eng.gather_mode) == (D, gather_mode)
    out = _serve(eng, setup["stream"])
    for got, want in zip(out, single[impl]):
        np.testing.assert_array_equal(got, want)
    hs = eng.halo_stats
    assert hs["s_pad"] > 0 and hs["exchange_bytes_per_step"] > 0
    if gather_mode != "dense":
        assert hs["halo_frac"] < 1.0
        assert hs["halo_rows"] <= hs["gather_rows_per_step"] <= hs["s_pad"]
    _serve(eng, setup["stream"])                       # pool converges
    allocs = eng.pack_stats["allocs"]
    _serve(eng, setup["stream"])                       # steady state
    assert eng.pack_stats["allocs"] == allocs, eng.pack_stats
    assert not eng._inflight


def test_one_device_mesh_serves_the_plain_path(setup, single):
    eng = _engine(setup, "segment", cpu_mesh(1), gather_mode="alltoall")
    assert eng.mesh is None and eng.n_shards == 1
    assert eng.gather_mode == "dense"
    for got, want in zip(_serve(eng, setup["stream"]), single["segment"]):
        np.testing.assert_array_equal(got, want)


JAX_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import sys, json, dataclasses
sys.path.insert(0, "src")
import jax, jax.numpy as jnp, numpy as np
from repro.gnn import GNNConfig, load_dataset
from repro.gnn.nai import NAIConfig
from repro.launch.mesh import make_serving_mesh
from repro.serving import NAIServingEngine

args = json.loads(sys.argv[1])
raw = np.load(args["params"])
params = {"cls": {}}
for key in raw.files:
    l, name = key.split("/")
    params["cls"].setdefault(int(l), {})[name] = jnp.asarray(raw[key])
g = load_dataset("pubmed-like", scale=0.02, seed=4)
g = dataclasses.replace(g, features=np.ascontiguousarray(g.features[:, :64]))
cfg = GNNConfig("sgc", 64, g.num_classes, k=2, hidden=32, mlp_layers=2)
nai = NAIConfig(t_s=6.0, t_min=1, t_max=2, batch_size=32)
out = {}
for impl, D, gm in args["cases"]:
    eng = NAIServingEngine(cfg, nai, params, g, max_wait_s=10.0,
                           mode="compiled", spmm_impl=impl,
                           pipeline_depth=2, mesh=make_serving_mesh(D),
                           gather_mode=gm)
    done = []
    for nodes in args["stream"]:
        eng.submit(np.asarray(nodes))
        done += eng.step()
    done += eng.flush()
    out[impl] = [[int(getattr(r, k)) for r in done]
                 for k in ("node_id", "prediction", "exit_order")]
print("JAX_SHARDED " + json.dumps(out))
"""


def test_sharded_engine_matches_jax_sharded_engine(setup, tmp_path):
    """The port's sharded engine against the JAX package's sharded engine
    on the same heads and requests, one D and gather mode per backend:
    equal outside the threshold margin."""
    cases = [("segment", 2, "dense"), ("block_ell", 4, "halo"),
             ("fused", 2, "alltoall")]
    np.savez(tmp_path / "params.npz", **{
        f"{l}/{k}": v for l, p in setup["tree"].items()
        for k, v in p.items()})
    arg = json.dumps({"params": str(tmp_path / "params.npz"),
                      "cases": cases,
                      "stream": [s.tolist() for s in setup["stream"]]})
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    p = subprocess.run([sys.executable, "-c", JAX_SCRIPT, arg], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=600)
    line = [ln for ln in p.stdout.splitlines()
            if ln.startswith("JAX_SHARDED ")]
    assert line, p.stdout + p.stderr
    jax_out = json.loads(line[0][len("JAX_SHARDED "):])
    nodes = np.concatenate(setup["stream"])
    near = near_threshold(decision_distances, setup["cfg"], setup["nai"],
                          setup["g"], nodes, BATCH)
    for impl, D, gm in cases:
        n, pr, eo = _serve(_engine(setup, impl, cpu_mesh(D),
                                   pipeline_depth=2, gather_mode=gm),
                           setup["stream"])
        jn, jp, je = (np.array(a) for a in jax_out[impl])
        np.testing.assert_array_equal(n, jn)
        assert_orders_match(pr, eo, jp, je, near)


@pytest.mark.parametrize("impl", IMPLS)
def test_cached_sharded_equals_cold_and_single_device(setup, impl):
    """Shard-partitioned caches: cached sharded serving equals cold
    sharded serving, and equals cached single-device serving bit for
    bit (same hits, same seeds); a steady pass allocates nothing."""
    rng = np.random.default_rng(3)
    pool = rng.choice(setup["g"].test_idx, size=64, replace=False)
    stream = [rng.choice(pool, size=32, replace=False) for _ in range(5)]
    D = 2
    hot = _engine(setup, impl, cpu_mesh(D), pipeline_depth=2,
                  gather_mode="halo", cache_nodes=4096)
    cold = _engine(setup, impl, cpu_mesh(D), pipeline_depth=2,
                   gather_mode="halo")
    hot1 = _engine(setup, impl, pipeline_depth=2, cache_nodes=4096)
    assert hot.cache.n_shards == D
    h, c, h1 = (_serve(e, stream) for e in (hot, cold, hot1))
    assert hot.cache_stats["hits"] > 0
    near = near_threshold(decision_distances, setup["cfg"], setup["nai"],
                          setup["g"], np.concatenate(stream), BATCH)
    assert_orders_match(h[1], h[2], c[1], c[2], near)
    for got, want in zip(h, h1):
        np.testing.assert_array_equal(got, want)
    assert hot.cache_stats == hot1.cache_stats
    _serve(hot, stream)
    allocs = hot.pack_stats["allocs"]
    _serve(hot, stream)
    assert hot.pack_stats["allocs"] == allocs


def test_frontend_serves_on_a_mesh(setup, single):
    """The front-end passes ``mesh=`` / ``gather_mode=`` to its class
    engines."""
    cls = SLOClass("gold", setup["nai"], deadline_s=100.0, max_wait_s=10.0)
    fe = ServingFrontend(setup["cfg"], setup["heads"], setup["g"], [cls],
                         spmm_impl="fused", mesh=cpu_mesh(2),
                         gather_mode="alltoall")
    eng = fe.engines["gold"]
    assert (eng.n_shards, eng.gather_mode) == (2, "alltoall")
    done = []
    for nodes in setup["stream"]:
        for nid in nodes:
            fe.submit(int(nid), now=0.0)
        done += fe.flush()
    pred = {r.node_id: r.prediction for r in done}
    n, p, _ = single["fused"]
    assert [pred[int(i)] for i in n] == p.tolist()


# ------------------------------------------------------------ offline
def _offline(s, ck, mesh=None, **kw):
    return run_full_graph_infer(s["store"], s["cfg"], s["heads"], s["nai"],
                                OfflineConfig(ckpt_dir=str(ck),
                                              device="cpu", **kw),
                                mesh=mesh)


@pytest.fixture(scope="module")
def offline_single(offline, tmp_path_factory):
    d = tmp_path_factory.mktemp("single")
    return {impl: _offline(offline, d / impl, spmm_impl=impl)
            for impl in IMPLS}


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("gather_mode", GATHER_MODES)
def test_sharded_offline_equals_single_device(offline, offline_single,
                                              tmp_path, impl, gather_mode):
    res = _offline(offline, tmp_path / "ck", cpu_mesh(2), spmm_impl=impl,
                   gather_mode=gather_mode)
    ref = offline_single[impl]
    np.testing.assert_array_equal(res.predictions, ref.predictions)
    np.testing.assert_array_equal(res.exit_orders, ref.exit_orders)
    st = res.stats
    assert (st["shards"], st["gather_mode"]) == (2, gather_mode)
    assert st["mesh"] == "mesh data=2 on (cpu x2)"
    assert st["exit_histogram"] == ref.stats["exit_histogram"]


@pytest.mark.parametrize("impl", IMPLS)
def test_sharded_offline_kill_at_every_superstep(offline, offline_single,
                                                 tmp_path, impl):
    mesh = cpu_mesh(4)
    for k in range(3):
        ck = tmp_path / f"k{k}"
        with pytest.raises(PreemptionSimulated):
            _offline(offline, ck, mesh, spmm_impl=impl, crash_after=k)
        res = _offline(offline, ck, mesh, spmm_impl=impl)
        assert res.stats["resumed_from"] == k
        assert res.stats["supersteps_run"] == 3 - k
        ref = offline_single[impl]
        np.testing.assert_array_equal(res.predictions, ref.predictions)
        np.testing.assert_array_equal(res.exit_orders, ref.exit_orders)


def test_cli_shards_on_the_cpu(tmp_path):
    """``--shards 2 --device cpu``: preempted after superstep 1 (exit 17),
    resumed, equal to the one-shard run; ``--shards 2`` without ``--device
    cpu`` asks for two GPUs and fails here."""
    store = str(tmp_path / "store")
    save_graph_store(make_graph(**{**OFFLINE_GRAPH, "n": 600}), store)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    base = [sys.executable, "-m", "repro_torch.launch.full_graph_infer",
            "--store", store, "--t-max", "3", "--t-s-quantile", "0.5",
            "--impl", "fused"]
    cpu = base + ["--device", "cpu"]
    subprocess.run(cpu + ["--ckpt", str(tmp_path / "one")], env=env,
                   check=True, timeout=300, capture_output=True)
    two = cpu + ["--shards", "2", "--gather", "alltoall", "--ckpt",
                 str(tmp_path / "two")]
    p = subprocess.run(two + ["--crash-after", "1"], env=env, timeout=300,
                       capture_output=True)
    assert p.returncode == EXIT_PREEMPTED, p.stderr
    p = subprocess.run(two, env=env, check=True, timeout=300,
                       capture_output=True, text=True)
    summary = json.loads(p.stdout.split("OFFLINE_SUMMARY ", 1)[1])
    assert summary["resumed_from"] == 1 and summary["shards"] == 2
    for name in ("predictions", "exit_orders"):
        a = np.load(tmp_path / "one" / "result" / f"{name}.npy")
        b = np.load(tmp_path / "two" / "result" / f"{name}.npy")
        np.testing.assert_array_equal(a, b)
    p = subprocess.run(base + ["--shards", "2", "--ckpt",
                               str(tmp_path / "gpu")],
                       env=dict(env, CUDA_VISIBLE_DEVICES=""), timeout=300,
                       capture_output=True, text=True)
    assert p.returncode != 0 and "CUDA is not available" in p.stderr


# -------------------------------------------------------- distributed
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("D,gather_mode", [(2, "dense"), (2, "halo"),
                                           (4, "alltoall")])
def test_distributed_series_matches_host(setup, impl, D, gather_mode):
    g = load_dataset("pubmed-like", scale=0.02, seed=0)
    k = 3
    host = propagated_series(g, g.features, k)
    series = distributed_series(cpu_mesh(D), g, k, spmm_impl=impl,
                                gather_mode=gather_mode)
    for l in range(k + 1):
        err = np.abs(series[l].numpy() - host[l]).max()
        assert err < 2e-3, (impl, l, err)
    one = distributed_series(None, g, k, spmm_impl=impl, device="cpu")
    assert len(one) == k + 1 and one[k].shape == series[k].shape


def test_distributed_nap_distances():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((256, 64)).astype(np.float32)
    xi = rng.standard_normal((256, 64)).astype(np.float32)
    mesh = make_mesh(("cpu",) * 4, {"data": 2, "model": 2})
    d = distributed_nap_distances(mesh, x, xi)
    np.testing.assert_allclose(d.numpy(), np.linalg.norm(x - xi, axis=1),
                               rtol=1e-5)
    with pytest.raises(ValueError, match="split"):
        distributed_nap_distances(mesh, x[:255], xi[:255])
    with pytest.raises(ValueError, match="'model'"):
        distributed_nap_distances(cpu_mesh(2), x, xi)
