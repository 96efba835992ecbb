"""The whole slice: the PyTorch port's `NAIServingEngine` (host mode, and
compiled mode with each backend at pipeline depth 1 and 2) against the
JAX package's engine on the same requests, with the same classifier
parameters (carried across by `params_from_numpy`).

Predictions and exit orders must be equal on every node outside the
threshold margin (tests/torch_parity.py: decision-step d² within 1e-4 of
t_s², at most 5% of the nodes). The reference's own host and compiled
paths may disagree inside that margin (src/repro/gnn/nai.py:104-110)."""
import jax
import numpy as np
import pytest
import torch

from repro.gnn import GNNConfig as JConfig
from repro.gnn import init_classifiers as j_init
from repro.gnn import load_dataset as j_load
from repro.gnn.nai import NAIConfig as JNAI
from repro.serving import NAIServingEngine as JEngine

from repro_torch.gnn import GNNConfig, NAIConfig, load_dataset
from repro_torch.gnn import params_from_numpy
from repro_torch.gnn.nai import decision_distances
from repro_torch.serving import NAIServingEngine

from torch_parity import assert_orders_match, near_threshold, small_graph

torch.set_num_threads(1)

BATCH = 32


@pytest.fixture(scope="module")
def setup():
    jg, tg = small_graph(j_load), small_graph(load_dataset)
    kw = dict(k=2, hidden=32, mlp_layers=2)
    jcfg = JConfig("sgc", 64, tg.num_classes, **kw)
    tcfg = GNNConfig("sgc", 64, tg.num_classes, **kw)
    params = {"cls": j_init(jcfg, jax.random.PRNGKey(0))}
    tree = {l: {k: np.asarray(v) for k, v in p.items()}
            for l, p in params["cls"].items()}
    heads = params_from_numpy(tcfg, tree, device="cpu")
    jnai = JNAI(t_s=6.0, t_min=1, t_max=2, batch_size=BATCH)
    tnai = NAIConfig(t_s=6.0, t_min=1, t_max=2, batch_size=BATCH)
    nodes = np.random.default_rng(0).choice(tg.test_idx, size=2 * BATCH,
                                            replace=False)
    near = near_threshold(decision_distances, tcfg, tnai, tg, nodes, BATCH)
    return dict(jg=jg, tg=tg, jcfg=jcfg, tcfg=tcfg, params=params,
                heads=heads, jnai=jnai, tnai=tnai, nodes=nodes, near=near,
                jax_results={})


def _serve(engine, nodes):
    engine.submit(nodes)
    done = []
    while engine.queue:
        done += engine.step()
    done += engine.flush()
    assert [r.node_id for r in done] == list(map(int, nodes))
    return (np.array([r.prediction for r in done]),
            np.array([r.exit_order for r in done]))


def _jax_result(s, mode, impl):
    """The JAX engine's answer for (mode, impl), served once per module
    (its depth-2 pipeline is bit-identical to serial by its own
    invariants, so depth 1 stands for both)."""
    key = (mode, impl)
    if key not in s["jax_results"]:
        eng = JEngine(s["jcfg"], s["jnai"], s["params"], s["jg"],
                      max_wait_s=10.0, mode=mode, spmm_impl=impl)
        s["jax_results"][key] = _serve(eng, s["nodes"])
    return s["jax_results"][key]


@pytest.mark.parametrize("mode,impl,depth", [
    ("host", "block_ell", 1),
    ("compiled", "segment", 1), ("compiled", "segment", 2),
    ("compiled", "block_ell", 1), ("compiled", "block_ell", 2),
    ("compiled", "fused", 1), ("compiled", "fused", 2)])
def test_engine_matches_jax(setup, mode, impl, depth):
    s = setup
    eng = NAIServingEngine(s["tcfg"], s["tnai"], s["heads"], s["tg"],
                           device="cpu", max_wait_s=10.0, mode=mode,
                           spmm_impl=impl, pipeline_depth=depth)
    pt, ot = _serve(eng, s["nodes"])
    pj, oj = _jax_result(s, mode, impl)
    assert (pt >= 0).all() and set(ot) <= {1, 2}
    assert len(set(ot)) == 2           # both orders are exercised
    assert_orders_match(pt, ot, pj, oj, s["near"])
    assert eng.stats.served == len(s["nodes"]) and eng.stats.failed == 0


@pytest.fixture(scope="module")
def wide():
    """Two feature blocks (200 features), S2GC heads, T_max = 3 (two
    decision steps): t_s = 14 splits the batch over all three orders."""
    jg = small_graph(j_load, features=200)
    tg = small_graph(load_dataset, features=200)
    kw = dict(k=3, hidden=32, mlp_layers=2)
    jcfg = JConfig("s2gc", 200, tg.num_classes, **kw)
    tcfg = GNNConfig("s2gc", 200, tg.num_classes, **kw)
    params = {"cls": j_init(jcfg, jax.random.PRNGKey(3))}
    tree = {l: {k: np.asarray(v) for k, v in p.items()}
            for l, p in params["cls"].items()}
    batch = 24
    jnai = JNAI(t_s=14.0, t_min=1, t_max=3, batch_size=batch)
    tnai = NAIConfig(t_s=14.0, t_min=1, t_max=3, batch_size=batch)
    nodes = np.random.default_rng(1).choice(tg.test_idx, size=2 * batch,
                                            replace=False)
    return dict(jg=jg, tg=tg, jcfg=jcfg, tcfg=tcfg, params=params,
                heads=params_from_numpy(tcfg, tree, device="cpu"),
                jnai=jnai, tnai=tnai, nodes=nodes,
                near=near_threshold(decision_distances, tcfg, tnai, tg,
                                    nodes, batch),
                jax_results={})


@pytest.mark.parametrize("mode,impl,depth", [
    ("host", "block_ell", 1), ("compiled", "segment", 2),
    ("compiled", "block_ell", 2), ("compiled", "fused", 1)])
def test_engine_matches_jax_three_orders(wide, mode, impl, depth):
    s = wide
    eng = NAIServingEngine(s["tcfg"], s["tnai"], s["heads"], s["tg"],
                           device="cpu", max_wait_s=10.0, mode=mode,
                           spmm_impl=impl, pipeline_depth=depth)
    pt, ot = _serve(eng, s["nodes"])
    pj, oj = _jax_result(s, mode, impl)
    assert set(ot) == {1, 2, 3}
    assert_orders_match(pt, ot, pj, oj, s["near"])
