"""The port's propagated-feature cache path against the JAX package's:
`PropCache` (same masks, values and `stats()` for one call sequence, also
across mutations and with shard partitions), `sample_support(cache=)` and
`pack_support(seeds=)` array-equal field by field, the seeded NAP loop
(`run_propagation` with seed operands), `exit_decision`, and the serving
engine with the cache on — for all three backends, predictions and exit
orders equal to the port's engine with the cache off and to the JAX
engine with the cache on, across a mutation round, with the same cache
counters; zero steady-state pack allocations with the cache on.

Host numpy stages are compared exactly; propagated series at rtol = atol
= 1e-5 (f32 sums in another order); predictions and exit orders equal
outside the threshold margin of tests/torch_parity.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.gnn import GNNConfig as JConfig
from repro.gnn import init_classifiers as j_init
from repro.gnn import load_dataset as j_load
from repro.gnn.backends import get_backend as j_backend
from repro.gnn.backends import pack_operands as j_pack_operands
from repro.gnn.backends import run_propagation as j_run
from repro.gnn.nai import NAIConfig as JNAI
from repro.gnn.nai import support_stationary_factors as j_factors
from repro.gnn.packing import pack_support as j_pack
from repro.gnn.packing import step_active_blocks as j_step_active
from repro.gnn.propcache import PropCache as JCache
from repro.gnn.sampler import sample_support as j_sample
from repro.gnn.store import InMemoryStore as JStore
from repro.gnn.store import make_graph as j_make_graph
from repro.kernels.nap_exit import exit_decision as j_exit_decision
from repro.serving import NAIServingEngine as JEngine

from repro_torch.gnn import (GNNConfig, NAIConfig, PropCache, load_dataset,
                             pack_support, params_from_numpy,
                             sample_support)
from repro_torch.gnn.backends import (get_backend, pack_operands,
                                      run_propagation)
from repro_torch.gnn.nai import (decision_distances,
                                 support_stationary_factors)
from repro_torch.gnn.packing import step_active_blocks
from repro_torch.gnn.store import InMemoryStore, make_graph
from repro_torch.kernels.nap_exit import exit_decision
from repro_torch.serving import EngineConfig, NAIServingEngine

from torch_parity import assert_orders_match, near_threshold, small_graph

torch.set_num_threads(1)

BATCH = 32
PACK_FIELDS = ("tiles", "tile_col", "valid", "hop_rb", "n_batch", "nb_real",
               "n_pad", "s_real", "x0", "x_inf", "src", "dst", "coef",
               "c_inf", "s_inf", "reused", "seed_rows", "seed_vals")
SUPPORT_FIELDS = ("nodes", "hop", "n_batch", "src", "dst", "coef",
                  "sub_edges", "hit", "seed_vals", "graph_version")


def _equal_fields(a, b, fields):
    for k in fields:
        va, vb = getattr(a, k), getattr(b, k)
        if isinstance(va, np.ndarray) or isinstance(vb, np.ndarray):
            np.testing.assert_array_equal(np.asarray(va), np.asarray(vb),
                                          err_msg=k)
        else:
            assert va == vb, k


@pytest.fixture(scope="module")
def setup():
    jg, tg = small_graph(j_load), small_graph(load_dataset)
    kw = dict(k=2, hidden=32, mlp_layers=2)
    jcfg = JConfig("sgc", 64, tg.num_classes, **kw)
    tcfg = GNNConfig("sgc", 64, tg.num_classes, **kw)
    params = {"cls": j_init(jcfg, jax.random.PRNGKey(0))}
    tree = {l: {k: np.asarray(v) for k, v in p.items()}
            for l, p in params["cls"].items()}
    rng = np.random.default_rng(3)
    pool = rng.choice(tg.test_idx, size=2 * BATCH, replace=False)
    # batches from a small pool: cross-batch frontier overlap is what
    # makes hits (batch rows themselves are never probed)
    stream = [rng.choice(pool, size=BATCH, replace=False) for _ in range(4)]
    return dict(jg=jg, tg=tg, jcfg=jcfg, tcfg=tcfg, params=params,
                heads=params_from_numpy(tcfg, tree, device="cpu"),
                jnai=JNAI(t_s=6.0, t_min=1, t_max=2, batch_size=BATCH),
                tnai=NAIConfig(t_s=6.0, t_min=1, t_max=2, batch_size=BATCH),
                stream=stream, jax_hot={})


# ------------------------------------------------------------ PropCache
@pytest.mark.parametrize("n_shards", [1, 2])
def test_propcache_matches_reference(n_shards):
    """One call sequence (fills, probes, gathers, LRU evictions, a
    mutation that stales some entries) on both packages' caches."""
    stores = (make_graph(600, avg_deg=4.0, seed=1, feat_dim=4),
              j_make_graph(600, avg_deg=4.0, seed=1, feat_dim=4))
    caches = (PropCache(40, 3, n_shards=n_shards),
              JCache(40, 3, n_shards=n_shards))
    rng = np.random.default_rng(n_shards)
    ops = []
    for step in range(6):
        nodes = rng.choice(600, size=25, replace=False)
        series = rng.standard_normal((25, 3, 4)).astype(np.float32)
        deps = np.unique(np.concatenate([nodes,
                                         rng.integers(0, 600, 50)]))
        probe = rng.integers(0, 600, 60)
        ops.append((nodes, series, deps, probe))
    for i, (nodes, series, deps, probe) in enumerate(ops):
        got = []
        for st, c in zip(stores, caches):
            gv = st.mutation_clock
            mask = c.probe(st, probe)
            vals = c.gather(probe[mask])
            c.fill(st, nodes, series, deps, gv)
            if i == 3:   # an edge inside a few fills' dependency blocks
                st.add_edges([int(deps[0]), int(deps[1])],
                             [int(deps[-1]), int(deps[-2])])
            got.append((mask, vals, c.stats(), len(c)))
        (m1, v1, s1, n1), (m2, v2, s2, n2) = got
        np.testing.assert_array_equal(m1, m2)
        np.testing.assert_array_equal(v1, v2)
        assert s1 == s2 and n1 == n2
    assert s1["hits"] > 0 and s1["stale"] > 0 and s1["evictions"] > 0
    for c in caches:
        c.reset_stats()
    assert caches[0].stats() == caches[1].stats()
    for bad in (dict(capacity=0, t_max=2), dict(capacity=4, t_max=0),
                dict(capacity=4, t_max=2, n_shards=0)):
        with pytest.raises(ValueError):
            PropCache(**bad)
    with pytest.raises(ValueError, match="series shape"):
        caches[0].fill(stores[0], np.arange(3), np.zeros((2, 3, 4)),
                       np.arange(3), 0)


# --------------------------------------------------- sample + pack + loop
def _hot_caches(s):
    """Both packages' caches filled identically from the first batch, with
    seeded random series standing in for its propagated rows."""
    stores = InMemoryStore(s["tg"]), JStore(s["jg"])
    caches = PropCache(4096, 2), JCache(4096, 2)
    nodes = np.unique(s["stream"][0])
    series = np.random.default_rng(5).standard_normal(
        (len(nodes), 2, 128)).astype(np.float32)
    deps = j_sample(stores[1], nodes, 2, 0.5).nodes
    for st, c in zip(stores, caches):
        c.fill(st, nodes, series, deps, 0)
    return stores, caches


def _packs(s, stores, caches, batch, impl, out=(None, None)):
    tsup = sample_support(stores[0], batch, 2, 0.5, cache=caches[0])
    jsup = j_sample(stores[1], batch, 2, 0.5, cache=caches[1])
    packs = []
    for st, sup, sf, pk, o in ((stores[0], tsup, support_stationary_factors,
                                pack_support, out[0]),
                               (stores[1], jsup, j_factors, j_pack, out[1])):
        x0 = st.gather_features(sup.nodes).astype(np.float32)
        c, f = (a.astype(np.float32) for a in sf(st, sup, x0, 0.5))
        packs.append(pk(sup, x0, c[:, None] * f[None, :],
                        x_inf_factors=(c, f) if impl == "fused" else None,
                        build_tiles=impl != "segment",
                        build_edges=impl == "segment",
                        seeds=(sup.hit, sup.seed_vals), out=o))
    return tsup, jsup, packs


@pytest.mark.parametrize("impl", ["segment", "block_ell", "fused"])
def test_sample_and_pack_with_seeds_match_reference(setup, impl):
    s = setup
    stores, caches = _hot_caches(s)
    batch = np.unique(s["stream"][1])
    tsup, jsup, (tp, jp) = _packs(s, stores, caches, batch, impl)
    _equal_fields(tsup, jsup, SUPPORT_FIELDS)
    assert tsup.hit.sum() > 0 and not tsup.hit[:tsup.n_batch].any()
    _equal_fields(tp, jp, PACK_FIELDS)
    assert (tp.seed_rows[:tsup.hit.sum()] < tp.n_pad).all()
    assert (tp.seed_rows[tsup.hit.sum():] == tp.n_pad).all()
    # the same support packed again into the first pack's buffers
    tsup2, _, (tp2, jp2) = _packs(s, stores, caches, batch, impl,
                                  out=(tp, jp))
    assert tp2 is tp and tp2.reused and jp2.reused
    _equal_fields(tp2, jp2, PACK_FIELDS)
    # a batch whose support holds no hit still emits (empty) seeds
    none = make_graph(400, avg_deg=3.0, seed=2, feat_dim=8)
    sup = sample_support(none, np.arange(8), 2, 0.5, cache=PropCache(8, 2))
    p = pack_support(sup, none.gather_features(sup.nodes),
                     np.zeros((8, 0), np.float32), seeds=(sup.hit,
                                                          sup.seed_vals))
    assert p.seed_pad == 1 and p.seed_rows[0] == p.n_pad
    with pytest.raises(ValueError, match="batch rows"):
        hit = sup.hit.copy()
        hit[0] = True
        pack_support(sup, none.gather_features(sup.nodes),
                     np.zeros((8, 0), np.float32), seeds=(hit, sup.seed_vals))


@pytest.mark.parametrize("impl", ["segment", "block_ell", "fused"])
def test_seeded_nap_loop_matches_reference(setup, impl):
    """The NAP loop with seed operands: exit orders equal and the batch
    rows' series allclose to the JAX loop's on the same pack."""
    s = setup
    stores, caches = _hot_caches(s)
    _, _, (tp, jp) = _packs(s, stores, caches, np.unique(s["stream"][1]),
                            impl)
    nai = s["tnai"]
    ops = pack_operands(get_backend(impl), tp,
                        step_active_blocks(tp.hop_rb, nai.t_max))
    jops = j_pack_operands(j_backend(impl), jp,
                           j_step_active(jp.hop_rb, nai.t_max))
    assert set(ops) == set(jops) >= {"seed_rows", "seed_vals"}
    if impl != "fused":
        ops["x_inf"], jops["x_inf"] = tp.x_inf, jnp.asarray(jp.x_inf)
    order, series = run_propagation(get_backend(impl), nai, ops, tp.x0,
                                    tp.n_batch, device="cpu")
    j_order, j_series = j_run(j_backend(impl), s["jnai"],
                              {k: jnp.asarray(v) for k, v in jops.items()},
                              jnp.asarray(jp.x0), jp.n_batch)
    np.testing.assert_array_equal(order.numpy(), np.asarray(j_order))
    np.testing.assert_allclose(series.numpy(), np.asarray(j_series),
                               rtol=1e-5, atol=1e-5)


def test_exit_decision_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((21, 200)).astype(np.float32)
    x_inf = rng.standard_normal((21, 200)).astype(np.float32) * 0.5
    act = rng.random(21) < 0.8
    t_s = float(np.median(np.linalg.norm(x - x_inf, axis=1)))
    got = exit_decision(torch.from_numpy(x), torch.from_numpy(x_inf),
                        torch.from_numpy(act), t_s)
    want = j_exit_decision(jnp.asarray(x), jnp.asarray(x_inf),
                           jnp.asarray(act), t_s)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-5, atol=1e-5)
    far = np.abs(np.asarray(want[0]) - t_s) > 1e-4 * t_s
    np.testing.assert_array_equal(got[1].numpy()[far],
                                  np.asarray(want[1])[far])
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert got[2].shape == (3,) and 0 < int(got[1].sum()) < 21


# --------------------------------------------------------------- engine
def _serve(engine, nodes):
    engine.submit(nodes)
    done = []
    while engine.queue:
        done += engine.step()
    done += engine.flush()
    assert [r.status for r in done] == ["completed"] * len(nodes)
    return (np.array([r.prediction for r in done]),
            np.array([r.exit_order for r in done]))


def _mutation(stores, served):
    """One mutation round, the same on every store: 8 edges between
    served nodes and their neighbours' ids, and two new nodes."""
    rng = np.random.default_rng(7)
    src = rng.choice(served, size=8, replace=False)
    dst = (src + 1) % stores[0].n
    feats = rng.normal(size=(2, 64)).astype(np.float32)
    for st in stores:
        st.add_edges(src, dst)
        new = st.add_nodes(feats)
    return new


@pytest.mark.parametrize("impl", ["segment", "block_ell", "fused"])
def test_cached_engine_matches_cold_and_reference(setup, impl):
    s = setup
    stores = InMemoryStore(s["tg"]), InMemoryStore(s["tg"]), \
        JStore(s["jg"])
    hot = NAIServingEngine(s["tcfg"], s["tnai"], s["heads"], stores[0],
                           device="cpu", max_wait_s=10.0, mode="compiled",
                           spmm_impl=impl, pipeline_depth=2,
                           cache_nodes=4096)
    cold = NAIServingEngine(s["tcfg"], s["tnai"], s["heads"], stores[1],
                            device="cpu", max_wait_s=10.0, mode="compiled",
                            spmm_impl=impl)
    jhot = JEngine(s["jcfg"], s["jnai"], s["params"], stores[2],
                   max_wait_s=10.0, mode="compiled", spmm_impl=impl,
                   cache_nodes=4096)
    stream = list(s["stream"])
    served = np.unique(np.concatenate(stream))
    for rnd in range(2):
        if rnd:
            new = _mutation(stores, served)
            stream = stream[1:3] + [np.concatenate([new, served[:30]])]
        for nodes in stream:
            ph, oh = _serve(hot, nodes)
            pc, oc = _serve(cold, nodes)
            pj, oj = _serve(jhot, nodes)
            near = near_threshold(decision_distances, s["tcfg"], s["tnai"],
                                  stores[1], nodes, BATCH)
            assert_orders_match(ph, oh, pc, oc, near)
            assert_orders_match(ph, oh, pj, oj, near)
    cs = hot.cache_stats
    assert cs["hits"] > 0 and cs["stale"] > 0, cs
    assert cs["rows_packed"] < cs["rows_support"], cs
    assert cs == jhot.cache_stats
    ccs = cold.cache_stats
    assert ccs["rows_packed"] == ccs["rows_support"] > 0
    assert "hits" not in ccs


def test_cached_engine_zero_steady_state_allocs(setup):
    s = setup
    eng = NAIServingEngine(s["tcfg"], s["tnai"], s["heads"], s["tg"],
                           device="cpu", max_wait_s=10.0, mode="compiled",
                           spmm_impl="fused", pipeline_depth=2,
                           cache_nodes=4096)
    for _ in range(3):   # warm: fills, hit saturation, bucket marks, pool
        for nodes in s["stream"]:
            _serve(eng, nodes)
    allocs = eng.pack_stats["allocs"]
    eng.reset_stats()
    for _ in range(2):
        for nodes in s["stream"]:
            _serve(eng, nodes)
    assert eng.pack_stats["allocs"] == allocs
    assert eng.pack_stats["reuses"] > 0
    cs = eng.cache_stats
    assert cs["hits"] > 0 and cs["size"] > 0
    eng.reset_stats()
    cs = eng.cache_stats
    assert cs["hits"] == cs["misses"] == cs["fills"] == 0
    assert cs["rows_support"] == cs["rows_packed"] == 0
    assert cs["size"] > 0 and eng.stats.served == 0
    eng.close()


def test_cache_config_validation():
    with pytest.raises(ValueError, match="cache_nodes"):
        EngineConfig(mode="compiled", cache_nodes=-1)
    with pytest.raises(ValueError, match="host"):
        EngineConfig(mode="host", cache_nodes=16)
    assert EngineConfig(mode="compiled", cache_nodes=16).cache_fill
