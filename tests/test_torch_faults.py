"""Fault injection and failure-domain isolation in the PyTorch port
(`repro_torch.serving.faults` and the engine's `faults` / `watchdog_s` /
`retry_failed`), against the JAX package: the same `FaultPlan` fires the
same faults event for event in both packages, and the same plan through
the same request stream gives every request the same outcome (status,
error type, retried flag; predictions and exit orders under the
threshold-margin rule of tests/torch_parity.py). Then the reference's
isolation scenarios inside the port: only the faulted batch fails, the
NaN guard, the watchdog and its re-arm, the host-path retry, a fault-free
plan serving exactly as no plan, and `FaultyStore`."""

import jax
import numpy as np
import pytest
import torch

from repro.gnn import GNNConfig as JConfig
from repro.gnn import init_classifiers as j_init
from repro.gnn import load_dataset as j_load
from repro.gnn.nai import NAIConfig as JNAI
from repro.gnn.store import as_store as j_as_store
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import FaultPlan as JPlan
from repro.serving import FaultSpec as JSpec
from repro.serving import FaultyStore as JFaultyStore
from repro.serving import NAIServingEngine as JEngine

from repro_torch.gnn import GNNConfig, NAIConfig, load_dataset
from repro_torch.gnn import params_from_numpy
from repro_torch.gnn.nai import decision_distances
from repro_torch.gnn.store import StoreIOError, as_store
from repro_torch.serving import (EngineConfig, FaultPlan, FaultSpec,
                                 FaultyStore, NAIServingEngine, Request)
from repro_torch.serving.faults import STAGES, poison_results

from torch_parity import near_threshold, small_graph

torch.set_num_threads(1)

BS = 8


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
    jnai = JNAI(t_s=6.0, t_min=1, t_max=2, batch_size=BS)
    nai = NAIConfig(t_s=6.0, t_min=1, t_max=2, batch_size=BS)
    # unique ids: each node is in exactly one batch, so clean and faulted
    # runs (same batching) compare by node id
    nodes = np.random.default_rng(0).choice(tg.test_idx, size=40,
                                            replace=False)
    near = near_threshold(decision_distances, tcfg, nai, tg, nodes, BS)
    return dict(jg=jg, g=tg, jcfg=jcfg, cfg=tcfg, params=params,
                heads=heads, jnai=jnai, nai=nai, nodes=nodes, near=near)


def _engine(s, impl="segment", **over):
    ec = EngineConfig(**{"mode": "compiled", "spmm_impl": impl,
                         "pipeline_depth": 2, **over})
    return NAIServingEngine(s["cfg"], s["nai"], s["heads"], s["g"],
                            device="cpu", config=ec)


def _jengine(s, **over):
    ec = JEngineConfig(**{"mode": "compiled", "spmm_impl": "segment",
                          "pipeline_depth": 2, **over})
    return JEngine(s["jcfg"], s["jnai"], s["params"], s["jg"], config=ec)


def _serve(eng, nids):
    done = []
    for i in range(0, len(nids), BS):
        eng.submit(nids[i:i + BS])
        done += eng.step()
    done += eng.flush()
    return done


def _outcome(r):
    return (r.node_id, r.status, r.error.split(":")[0], r.retried)


def _fires(injector, n=60):
    return [[(injector.fire(st) or None) and st for st in STAGES]
            for _ in range(n)]


# ----------------------------------------------------- the plan itself
PLANS = [
    [("host", dict(rate=0.3)), ("device", dict(at=(2, 5)))],
    [("nan", dict(rate=0.5, max_fires=3)), ("nan", dict(at=(0, 1))),
     ("hang", dict(rate=0.2))],
    [("store_read", dict(rate=0.25)), ("store_latency", dict(rate=0.5)),
     ("slow", dict(at=(3,), delay_s=0.0)), ("ckpt_write", dict(rate=0.1)),
     ("ckpt_read", dict(at=(4,))), ("superstep_hang", dict(rate=1.0,
                                                           max_fires=2))],
]


@pytest.mark.parametrize("plan", range(len(PLANS)))
@pytest.mark.parametrize("seed", [0, 9])
def test_injector_fires_as_jax(plan, seed):
    specs = PLANS[plan]
    ours = FaultPlan([FaultSpec(st, **kw) for st, kw in specs], seed=seed)
    theirs = JPlan([JSpec(st, **kw) for st, kw in specs], seed=seed)
    a, b = ours.injector(), theirs.injector()
    assert _fires(a) == _fires(b)
    assert a.summary() == b.summary()
    assert ours.describe() == theirs.describe()


def test_fault_plan_deterministic_and_validated():
    plan = FaultPlan([FaultSpec("host", rate=0.3),
                      FaultSpec("device", at=(2, 5))], seed=9)
    a, b = plan.injector(), plan.injector()
    assert _fires(a, 50) == _fires(b, 50)
    c = FaultPlan([FaultSpec("host", rate=0.3)], seed=10).injector()
    assert ([h[2] for h in _fires(c, 50)]
            != [h[2] for h in _fires(plan.injector(), 50)])
    inj = FaultPlan([FaultSpec("host", rate=1.0, max_fires=2)]).injector()
    assert [inj.fire("host") is not None for _ in range(4)] == \
        [True, True, False, False]
    with pytest.raises(ValueError, match="unknown fault stage"):
        FaultSpec("warp_core", rate=0.1)
    with pytest.raises(ValueError, match="rate"):
        FaultSpec("host", rate=1.5)
    with pytest.raises(ValueError, match="faults must be a FaultPlan"):
        EngineConfig(faults=[FaultSpec("host")])
    with pytest.raises(ValueError, match="watchdog_s"):
        EngineConfig(watchdog_s=0.0)


def test_poison_results_nan_and_hang():
    inj = FaultPlan([FaultSpec("nan", at=(0,)),
                     FaultSpec("hang", at=(0,))]).injector()
    preds = torch.zeros(4, dtype=torch.int64)
    orders = torch.ones(4, dtype=torch.int32)
    p, o, done = poison_results(inj, preds, orders, None)
    assert p.dtype == torch.float32 and p.isnan().all() and o.isnan().all()
    assert done is None
    p, o, done = poison_results(inj, preds, orders, None)   # hang event 0
    assert p is preds and not done.query()
    with pytest.raises(Exception, match="hung"):
        done.synchronize()
    assert poison_results(inj, preds, orders, None) == (preds, orders, None)


# ----------------------------------------- outcomes against the JAX engine
CASES = {
    "host": (dict(faults=[("host", dict(at=(1,)))]), {}),
    "device": (dict(faults=[("device", dict(at=(0,)))]), {}),
    "nan": (dict(faults=[("nan", dict(at=(0, 2)))]), {}),
    "hang_watchdog": (dict(faults=[("hang", dict(at=(1,)))]),
                      dict(watchdog_s=0.2)),
    "hang_no_watchdog": (dict(faults=[("hang", dict(at=(3,)))]), {}),
    "slow": (dict(faults=[("slow", dict(at=(2,), delay_s=0.01))]), {}),
    "random_mix": (dict(faults=[("host", dict(rate=0.2)),
                                ("nan", dict(rate=0.3))], seed=4), {}),
    "retry": (dict(faults=[("nan", dict(at=(1,))),
                           ("device", dict(at=(3,)))]),
              dict(retry_failed=True)),
}


@pytest.mark.parametrize("impl", ["segment", "fused"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_outcomes_match_jax_under_the_same_plan(setup, case, impl):
    s = setup
    plan, over = CASES[case]
    seed = plan.get("seed", 0)
    ours = _engine(s, impl, faults=FaultPlan(
        [FaultSpec(st, **kw) for st, kw in plan["faults"]], seed=seed),
        **over)
    theirs = _jengine(s, faults=JPlan(
        [JSpec(st, **kw) for st, kw in plan["faults"]], seed=seed), **over)
    a, b = _serve(ours, s["nodes"]), _serve(theirs, s["nodes"])
    assert [_outcome(r) for r in a] == [_outcome(r) for r in b]
    assert len(a) == len(s["nodes"])
    assert any(r.status == "failed" or r.retried for r in a) \
        or case == "slow"
    assert ours.fault_stats == theirs.fault_stats
    assert (ours.stats.failed, ours.stats.retried, ours.stats.served) == \
        (theirs.stats.failed, theirs.stats.retried, theirs.stats.served)
    pos = {int(n): i for i, n in enumerate(s["nodes"])}
    for ra, rb in zip(a, b):
        if ra.status == "completed" and not s["near"][pos[ra.node_id]]:
            assert (ra.prediction, ra.exit_order) == \
                (rb.prediction, rb.exit_order)
    assert not ours._inflight


# --------------------------------------------- isolation inside the port
def test_host_fault_fails_only_its_batch(setup):
    s = setup
    clean = {r.node_id: (r.prediction, r.exit_order)
             for r in _serve(_engine(s, "fused"), s["nodes"])}
    eng = _engine(s, "fused", faults=FaultPlan([FaultSpec("host",
                                                          at=(1,))]))
    done = _serve(eng, s["nodes"])
    failed = [r for r in done if r.status == "failed"]
    assert len(failed) == BS and eng.stats.failed == BS
    assert all("InjectedFault" in r.error and r.prediction == -1
               for r in failed)
    for r in done:
        if r.status == "completed":
            assert (r.prediction, r.exit_order) == clean[r.node_id]


def test_nan_guard_never_completes_a_poisoned_batch(setup):
    s = setup
    eng = _engine(s, "fused", faults=FaultPlan([FaultSpec("nan",
                                                          at=(0, 2))]))
    done = _serve(eng, s["nodes"])
    failed = [r for r in done if r.status == "failed"]
    assert len(failed) == 2 * BS
    assert all("NaNGuardError" in r.error for r in failed)
    for r in done:
        if r.status == "completed":
            assert 0 <= r.prediction < s["cfg"].num_classes
            assert 1 <= r.exit_order <= s["nai"].t_max


def test_poll_finalizes_results_that_are_already_on_the_host(setup):
    """Open loop: a batch whose results are host tensors with no event (a
    NaN-poisoned batch, or any batch on the CPU) is finalized by poll()
    while it sits below pipeline_depth."""
    s = setup
    eng = _engine(s, retry_failed=True,
                  faults=FaultPlan([FaultSpec("nan", at=(0,))]))
    eng.submit(s["nodes"][:BS])
    done = eng.poll()
    for _ in range(50):
        if done:
            break
        done += eng.poll()
    assert len(done) == BS
    assert all(r.status == "completed" and r.retried for r in done)
    assert not eng._inflight


def test_retry_completes_on_the_host_path(setup):
    s = setup
    host = NAIServingEngine(s["cfg"], s["nai"], s["heads"], s["g"],
                            device="cpu", mode="host", max_wait_s=10.0)
    want = {r.node_id: (r.prediction, r.exit_order)
            for r in _serve(host, s["nodes"])}
    eng = _engine(s, "fused", retry_failed=True,
                  faults=FaultPlan([FaultSpec("nan", at=(1,)),
                                    FaultSpec("device", at=(3,))]))
    done = _serve(eng, s["nodes"])
    assert all(r.status == "completed" for r in done)
    assert eng.stats.retried == 2 * BS and eng.stats.failed == 0
    for r in done:
        if r.retried:
            assert (r.prediction, r.exit_order) == want[r.node_id]


def test_watchdog_fails_hung_batch_and_rearms(setup):
    s = setup
    eng = _engine(s, "fused", watchdog_s=0.2,
                  faults=FaultPlan([FaultSpec("hang", at=(1,))]))
    done = _serve(eng, s["nodes"])
    failed = [r for r in done if r.status == "failed"]
    assert len(failed) == BS
    assert all("WatchdogTimeout" in r.error for r in failed)
    assert [r.status for r in done].count("completed") == 4 * BS
    assert not eng._inflight
    # open loop: poll never blocks, and the re-arm fails the hung batch
    # once its deadline has passed
    eng = _engine(s, "fused", watchdog_s=0.05,
                  faults=FaultPlan([FaultSpec("hang", at=(0,))]))
    eng.submit(s["nodes"][:BS])
    done = eng.poll()
    import time
    t_end = time.perf_counter() + 5.0
    while not done and time.perf_counter() < t_end:
        done += eng.poll()
    assert len(done) == BS and all("WatchdogTimeout" in r.error
                                   for r in done)


def test_fault_free_wiring_serves_as_no_plan(setup):
    s = setup
    nids = np.random.default_rng(3).choice(s["g"].test_idx, size=48,
                                           replace=False)
    plain = _engine(s, "fused")
    wired = _engine(s, "fused", faults=FaultPlan(), watchdog_s=5.0,
                    retry_failed=True, nan_guard=True)
    d0, d1 = _serve(plain, nids), _serve(wired, nids)
    assert [(r.prediction, r.exit_order) for r in d1] == \
        [(r.prediction, r.exit_order) for r in d0]
    assert wired.stats.failed == 0 and wired.stats.retried == 0
    assert all(r.status == "completed" for r in d1)
    assert wired.pack_stats == plain.pack_stats
    assert wired.fault_stats == {"host": {"events": 6, "fired": 0},
                                 "device": {"events": 6, "fired": 0},
                                 "nan": {"events": 6, "fired": 0},
                                 "hang": {"events": 6, "fired": 0},
                                 "slow": {"events": 6, "fired": 0}}
    assert plain.fault_stats is None


def test_submit_request_validates_and_keeps_the_stamp(setup):
    s = setup
    eng = _engine(s)
    with pytest.raises(ValueError, match="out of range"):
        eng.submit_request(Request(s["g"].n, 0.0))
    r = Request(int(s["nodes"][0]), 0.0, deadline_s=1e9, slo_class="gold")
    eng.submit_request(r)
    eng.step()
    eng.flush()
    assert r.status == "completed" and r.slo_class == "gold"
    assert r.within_deadline
    assert not Request(0, 0.0).within_deadline   # pending


# ------------------------------------------------------------ the store
def test_faulty_store_raises_typed_errors(setup):
    s = setup
    inj = FaultPlan([FaultSpec("store_read", at=(1,))], seed=2).injector()
    fs = FaultyStore(as_store(s["g"]), inj)
    nodes = np.arange(4)
    np.testing.assert_array_equal(fs.gather_features(nodes),
                                  as_store(s["g"]).gather_features(nodes))
    with pytest.raises(StoreIOError, match="injected read failure"):
        fs.gather_features(nodes)
    assert fs.n == s["g"].n


def test_store_faults_fail_batches_as_in_jax(setup):
    s = setup
    nids = np.random.default_rng(5).choice(s["g"].test_idx, size=64,
                                           replace=False)
    specs = [("store_read", dict(at=(1, 4))),
             ("store_latency", dict(at=(2,), delay_s=0.01))]
    fs = FaultyStore(as_store(s["g"]), FaultPlan(
        [FaultSpec(st, **kw) for st, kw in specs], seed=6).injector())
    jfs = JFaultyStore(j_as_store(s["jg"]), JPlan(
        [JSpec(st, **kw) for st, kw in specs], seed=6).injector())
    ec = EngineConfig(mode="compiled", spmm_impl="block_ell",
                      pipeline_depth=2)
    eng = NAIServingEngine(s["cfg"], s["nai"], s["heads"], fs,
                           device="cpu", config=ec)
    jeng = JEngine(s["jcfg"], s["jnai"], s["params"], jfs,
                   config=JEngineConfig(mode="compiled",
                                        spmm_impl="segment",
                                        pipeline_depth=2))
    a, b = _serve(eng, nids), _serve(jeng, nids)
    assert [_outcome(r) for r in a] == [_outcome(r) for r in b]
    failed = [r for r in a if r.status == "failed"]
    assert len(failed) == 2 * BS
    assert all("StoreIOError" in r.error for r in failed)
    assert eng.stats.failed == len(failed)
    assert fs.injector.summary() == jfs.injector.summary()
