"""Invariants inside the PyTorch port's device path and engine, plus the
masked NAP loop held against the JAX package's on identical packs:

* the propagated series of every backend matches the JAX loop's
  (allclose, rtol = atol = 1e-5: f32 sums in another order) and exit
  orders match outside the threshold margin;
* `block_ell` and `fused` give identical exit orders and predictions,
  and pipelined serving gives what serial serving gives (exactly);
* the pack pool stops allocating once warm; batches dedupe; the batch
  former, `poll` and the result guard behave as in the reference."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.gnn.nai import NAIConfig as JNAI
from repro.gnn.nai import infer_batch_masked as j_masked

from repro_torch.gnn import (GNNConfig, NAIConfig, init_classifiers,
                             load_dataset, pack_support, sample_support,
                             step_active_blocks)
from repro_torch.gnn.nai import (decision_distances, infer_batch_masked,
                                 support_stationary_factors)
from repro_torch.gnn.store import as_store
from repro_torch.serving import (EngineConfig, NAIServingEngine,
                                 NaNGuardError)

from torch_parity import D2_MARGIN, small_graph

torch.set_num_threads(1)

BATCH = 32


@pytest.fixture(scope="module")
def setup():
    g = small_graph(load_dataset)
    cfg = GNNConfig("sgc", 64, g.num_classes, k=2, hidden=32, mlp_layers=2)
    heads = init_classifiers(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    nai = NAIConfig(t_s=6.0, t_min=1, t_max=2, batch_size=BATCH)
    return g, cfg, heads, nai


def _serve(engine, nodes):
    engine.submit(nodes)
    done = []
    while engine.queue:
        done += engine.step()
    done += engine.flush()
    return (np.array([r.prediction for r in done]),
            np.array([r.exit_order for r in done]))


# ------------------------------------------------ loop against the JAX loop
CFG3 = GNNConfig("sgc", 200, 3, k=3)


@pytest.fixture(scope="module")
def packed_case():
    """One packed support of 37 batch nodes (two feature blocks, T_max 3)
    with dense x_inf and its rank-1 factors, shared by both packages."""
    g = small_graph(load_dataset, features=200)
    batch = np.random.default_rng(0).choice(g.test_idx, size=37,
                                            replace=False)
    sup = sample_support(as_store(g), batch, 3, 0.5)
    x0 = g.features[sup.nodes].astype(np.float32)
    c, s = (a.astype(np.float32)
            for a in support_stationary_factors(g, sup, x0, 0.5))
    packed = pack_support(sup, x0, c[:, None] * s[None, :],
                          x_inf_factors=(c, s))
    return g, batch, packed


@pytest.mark.parametrize("impl", ["segment", "block_ell", "fused"])
def test_masked_loop_matches_jax(packed_case, impl):
    g, batch, p = packed_case
    t_s = 14.0
    sa = step_active_blocks(p.hop_rb, 3)
    kw = dict(spmm_impl=impl, ell=(p.tiles, p.tile_col, p.valid),
              step_active=sa, x_inf_factors=(p.c_inf, p.s_inf))
    orders, series = infer_batch_masked(
        CFG3, NAIConfig(t_s=t_s, t_min=1, t_max=3), p.src, p.dst, p.coef,
        p.x0, p.x_inf, p.n_batch, device="cpu", **kw)
    j_kw = {k: (tuple(jnp.asarray(a) for a in v) if isinstance(v, tuple)
                else jnp.asarray(v)) for k, v in kw.items() if k != "spmm_impl"}
    j_orders, j_series = j_masked(
        None, JNAI(t_s=t_s, t_min=1, t_max=3), None, jnp.asarray(p.src),
        jnp.asarray(p.dst), jnp.asarray(p.coef), jnp.asarray(p.x0),
        jnp.asarray(p.x_inf), p.n_batch, spmm_impl=impl, interpret=True,
        **j_kw)
    np.testing.assert_allclose(series.numpy(), np.asarray(j_series),
                               rtol=1e-5, atol=1e-5)
    d = decision_distances(CFG3, NAIConfig(t_s=t_s, t_min=1, t_max=3), g,
                           batch)
    near = (np.abs(d ** 2 - t_s ** 2) <= D2_MARGIN * t_s ** 2).any(axis=1)
    real = orders.numpy()[:p.nb_real]
    np.testing.assert_array_equal(real[~near],
                                  np.asarray(j_orders)[:p.nb_real][~near])
    assert set(real) == {1, 2, 3}


# ------------------------------------------------------ engine invariants
@pytest.mark.parametrize("depth", [1, 2])
def test_block_ell_equals_fused_and_serial(setup, depth):
    g, cfg, heads, nai = setup
    nodes = np.random.default_rng(2).choice(g.test_idx, size=2 * BATCH,
                                            replace=False)
    out = {}
    for impl in ("block_ell", "fused"):
        eng = NAIServingEngine(cfg, nai, heads, g, device="cpu",
                               max_wait_s=10.0, mode="compiled",
                               spmm_impl=impl, pipeline_depth=depth)
        out[impl] = _serve(eng, nodes)
    serial = NAIServingEngine(cfg, nai, heads, g, device="cpu",
                              max_wait_s=10.0, mode="compiled",
                              spmm_impl="fused")
    ref = _serve(serial, nodes)
    for impl in ("block_ell", "fused"):
        for a, b in zip(out[impl], ref):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("impl", ["segment", "fused"])
def test_pack_pool_stops_allocating(setup, impl):
    g, cfg, heads, nai = setup
    eng = NAIServingEngine(cfg, nai, heads, g, device="cpu",
                           max_wait_s=10.0, mode="compiled", spmm_impl=impl,
                           pipeline_depth=2)
    nodes = np.asarray(g.test_idx[:BATCH])
    first = _serve(eng, nodes)
    for _ in range(5):
        again = _serve(eng, nodes)
        for a, b in zip(first, again):
            np.testing.assert_array_equal(a, b)
    # pipeline_depth + 1 buffer sets, then every batch refills one
    assert eng.pack_stats == {"allocs": 3, "reuses": 3}


def test_engine_dedupes_batch(setup):
    g, cfg, heads, nai = setup
    base = np.asarray(g.test_idx[:8])
    nodes = np.concatenate([base, base[:4]])
    res = {}
    for mode in ("host", "compiled"):
        eng = NAIServingEngine(cfg, nai, heads, g, device="cpu",
                               max_wait_s=10.0, mode=mode)
        preds, orders = _serve(eng, nodes)
        np.testing.assert_array_equal(preds[:4], preds[8:])
        np.testing.assert_array_equal(orders[:4], orders[8:])
        res[mode] = (preds, orders)
    for a, b in zip(res["host"], res["compiled"]):
        np.testing.assert_array_equal(a, b)


def test_form_batch_size_or_age_and_poll(setup):
    g, cfg, heads, nai = setup
    eng = NAIServingEngine(cfg, nai, heads, g, device="cpu",
                           max_wait_s=0.5, mode="compiled",
                           spmm_impl="fused", pipeline_depth=2)
    ids = np.asarray(g.test_idx[:BATCH + 5])
    eng.submit(ids[:5], now=0.0)
    assert eng.form_batch(now=0.1) == []           # neither trigger
    assert eng.poll(now=0.1) == []
    eng.submit(ids[5:], now=0.2)                   # size trigger
    assert len(eng.form_batch(now=0.2)) == BATCH
    assert len(eng.queue) == 5
    assert eng.poll(now=0.3) == []                 # young partial batch
    assert eng.poll(now=0.71) == []                # aged: dispatched
    done = eng.poll(now=0.72)                      # CPU results are ready
    assert [r.node_id for r in done] == list(map(int, ids[BATCH:]))
    assert all(r.status == "completed" for r in done)
    with pytest.raises(ValueError, match="out of range"):
        eng.submit([g.n])


def test_guard_and_config_validation(setup):
    g, cfg, heads, nai = setup
    eng = NAIServingEngine(cfg, nai, heads, g, device="cpu",
                           mode="compiled")
    with pytest.raises(NaNGuardError):
        eng._guard_results(np.array([0, cfg.num_classes]), np.array([1, 1]),
                           2)
    with pytest.raises(NaNGuardError):
        eng._guard_results(np.array([0, 1]), np.array([0, 1]), 2)
    eng._guard_results(np.array([0, 1, 99]), np.array([1, 2, 0]), 2)
    for bad in (dict(mode="jit"), dict(spmm_impl="dense"),
                dict(pipeline_depth=0), dict(mode="host", pipeline_depth=2),
                dict(max_wait_s=-1.0), dict(latency_window=0)):
        with pytest.raises(ValueError):
            EngineConfig(**bad)
    with pytest.raises(ValueError, match="either"):
        NAIServingEngine(cfg, nai, heads, g, device="cpu",
                         config=EngineConfig(), mode="host")
