"""The deadline-aware SLO front-end of the PyTorch port
(`repro_torch.serving.frontend`), against the JAX package: on one
virtual-clock bursty stream both front-ends route, batch and shed the
same requests, and every class's outcomes and counters are equal
(predictions and exit orders under the threshold-margin rule of
tests/torch_parity.py). Then the reference's scenarios inside the port:
front-end == direct per-class engines, pipelined == serial with no pack
allocation in the steady pass, backpressure, goodput accounting,
request conservation under overload, the breaker's state machine (the
same transitions as the JAX breaker's) and a breaker trip that demotes
gold and recovers."""
import dataclasses
import time
from collections import defaultdict

import jax
import numpy as np
import pytest
import torch

from repro.gnn import GNNConfig as JConfig
from repro.gnn import init_classifiers as j_init
from repro.gnn import load_dataset as j_load
from repro.gnn.nai import NAIConfig as JNAI
from repro.serving import BreakerConfig as JBreakerConfig
from repro.serving import CircuitBreaker as JBreaker
from repro.serving import ServingFrontend as JFrontend
from repro.serving import SLOClass as JSLOClass

from repro_torch.gnn import GNNConfig, NAIConfig, load_dataset
from repro_torch.gnn import params_from_numpy
from repro_torch.gnn.nai import decision_distances
from repro_torch.serving import (BreakerConfig, CircuitBreaker,
                                 EngineConfig, FaultPlan, FaultSpec,
                                 NAIServingEngine, ServingFrontend, SLOClass,
                                 default_slo_classes)

from torch_parity import D2_MARGIN, small_graph

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
    return dict(jg=jg, g=tg, jcfg=jcfg, cfg=tcfg, params=params,
                heads=heads, jnai=jnai, nai=nai)


def _classes(nai, make=SLOClass, queue_depth=64):
    return [
        make("gold", nai, deadline_s=10.0, max_wait_s=0.02,
             queue_depth=queue_depth),
        make("best_effort", dataclasses.replace(nai, t_max=nai.t_min),
             deadline_s=10.0, max_wait_s=0.01, queue_depth=queue_depth),
    ]


def _frontend(s, classes=None, **kw):
    return ServingFrontend(s["cfg"], s["heads"], s["g"],
                           classes or _classes(s["nai"]), device="cpu", **kw)


def _bursty_events(g, n_bursts=5, seed=0):
    """Virtual-time arrivals: bursts bigger than a batch (size closes)
    separated by lulls longer than max_wait (age closes)."""
    rng = np.random.default_rng(seed)
    events, t = [], 0.0
    for _ in range(n_bursts):
        size = int(rng.integers(3, 2 * BS + 1))
        for nid in rng.choice(g.test_idx, size=size, replace=True):
            cls = "gold" if rng.random() < 0.5 else "best_effort"
            events.append((t, cls, int(nid)))
            t += 1e-4
        t += 1.0
    return events


def _replay(fe, events, budget_s=None):
    reqs = []
    for t, cls, nid in events:
        reqs.append(fe.submit(nid, cls, now=t, budget_s=budget_s))
        fe.step(now=t)
    fe.step(now=events[-1][0] + 100.0)   # age out the stragglers
    fe.flush(now=events[-1][0] + 100.0)
    return reqs


def _near(s, reqs):
    """Per request: does its decision-step d² lie within the margin, in
    the batch (class, batch_id) it was served in?"""
    groups = defaultdict(list)
    for i, r in enumerate(reqs):
        if r is not None and r.status == "completed":
            groups[(r.slo_class, r.batch_id)].append(i)
    near = np.zeros(len(reqs), bool)
    ts2 = s["nai"].t_s ** 2
    for (cls, _), idx in groups.items():
        nai = (s["nai"] if cls == "gold"
               else dataclasses.replace(s["nai"], t_max=s["nai"].t_min))
        if nai.t_max == nai.t_min:
            continue                      # no decision step: no margin
        uniq, inv = np.unique([reqs[i].node_id for i in idx],
                              return_inverse=True)
        d = decision_distances(s["cfg"], nai, s["g"], uniq)
        close = (np.abs(d ** 2 - ts2) <= D2_MARGIN * ts2).any(axis=1)
        near[idx] = close[inv]
    return near


# ------------------------------------------------- against the JAX one
@pytest.mark.parametrize("impl,depth,queue_depth", [
    ("segment", 1, 64), ("fused", 2, 64), ("block_ell", 2, 5)])
def test_virtual_clock_replay_matches_jax(setup, impl, depth, queue_depth):
    """Same stream, same timestamps: the same requests are accepted or
    shed, served in the same batches, with equal per-class counters and
    equal outcomes."""
    s = setup
    events = _bursty_events(s["g"], n_bursts=6, seed=2)
    fe = _frontend(s, _classes(s["nai"], queue_depth=queue_depth),
                   mode="compiled", spmm_impl=impl, pipeline_depth=depth)
    jfe = JFrontend(s["jcfg"], s["params"], s["jg"],
                    _classes(s["jnai"], JSLOClass, queue_depth),
                    mode="compiled", spmm_impl="segment",
                    pipeline_depth=depth)
    a, b = _replay(fe, events, 50.0), _replay(jfe, events, 50.0)
    assert [r is None for r in a] == [r is None for r in b]
    near = _near(s, a)
    for i, (ra, rb) in enumerate(zip(a, b)):
        if ra is None:
            continue
        assert (ra.node_id, ra.slo_class, ra.status, ra.batch_id,
                ra.deadline_s, ra.done_s <= ra.deadline_s) == \
            (rb.node_id, rb.slo_class, rb.status, rb.batch_id,
             rb.deadline_s, rb.done_s <= rb.deadline_s)
        if not near[i]:
            assert (ra.prediction, ra.exit_order) == \
                (rb.prediction, rb.exit_order)
    assert near.mean() <= 0.05
    for name in ("gold", "best_effort"):
        assert fe.stats[name] == type(fe.stats[name])(
            **dataclasses.asdict(jfe.stats[name]))
        sa, sb = fe.summary()[name], jfe.summary()[name]
        for k in ("offered", "accepted", "rejected", "completed",
                  "deadline_hits", "goodput_frac", "batches"):
            assert sa[k] == sb[k], (name, k)
        if impl == "segment":   # the same operands grow the same pools
            assert sa["pack_allocs"] == sb["pack_allocs"], name
    if queue_depth < BS:
        assert sum(st.rejected for st in fe.stats.values()) > 0
    assert {r.exit_order for r in a if r is not None
            and r.slo_class == "best_effort"} == {1}


def test_breaker_transitions_match_jax():
    cfg = dict(window=8, trip_frac=0.5, min_events=4, cooldown_s=1.0,
               probes=2)
    ours, theirs = CircuitBreaker(BreakerConfig(**cfg)), \
        JBreaker(JBreakerConfig(**cfg))
    rng = np.random.default_rng(7)
    t = 0.0
    for _ in range(300):
        t += float(rng.exponential(0.05))
        assert ours.route(t) == theirs.route(t)
        bad, probe = bool(rng.random() < 0.6), bool(rng.random() < 0.3)
        ours.on_terminal(bad, probe, t)
        theirs.on_terminal(bad, probe, t)
        assert ours.state == theirs.state
    assert ours.transitions == theirs.transitions and ours.trips > 1


# ---------------------------------------------------- inside the port
def test_config_validation_and_default_tiers(setup):
    nai = setup["nai"]
    for bad in (dict(name=""), dict(deadline_s=0.0),
                dict(max_wait_s=-1.0), dict(queue_depth=0)):
        kw = {**dict(name="x", nai=nai, deadline_s=1.0, max_wait_s=0.01),
              **bad}
        with pytest.raises(ValueError):
            SLOClass(**kw)
    gold, be = default_slo_classes(nai)
    assert gold.nai.t_max == nai.t_max and be.nai.t_max == nai.t_min
    assert be.deadline_s < gold.deadline_s and gold.demote_to == be.name
    with pytest.raises(ValueError):
        BreakerConfig(min_events=0)
    s = setup
    with pytest.raises(ValueError):
        ServingFrontend(s["cfg"], s["heads"], s["g"], [], device="cpu",
                        mode="host")
    with pytest.raises(ValueError):
        _frontend(s, _classes(nai) + _classes(nai), mode="host")


def test_routing_backpressure_and_bad_ids(setup):
    s = setup
    g = s["g"]
    fe = _frontend(s, _classes(s["nai"], queue_depth=5), mode="host")
    for i in range(8):
        fe.submit(int(g.test_idx[i]), "gold", now=0.0)
    st = fe.stats["gold"]
    assert (st.offered, st.accepted, st.rejected) == (8, 5, 3)
    assert len(fe.engines["gold"].queue) == 5
    assert fe.stats["best_effort"].offered == 0
    with pytest.raises(KeyError):
        fe.submit(0, "platinum", now=0.0)
    with pytest.raises(ValueError, match="out of range"):
        fe.submit(g.n, "gold", now=0.0)
    assert fe.stats["gold"].offered == 8      # a caller error, not shed
    fe.flush()
    assert fe.submit(int(g.test_idx[0]), now=0.0).slo_class == "gold"
    assert fe.pending() == 1 and fe.pending_by_class()["gold"] == 1
    fe.flush()
    assert fe.pending() == 0


def test_pipelined_matches_serial_with_zero_steady_state(setup):
    s = setup
    events = _bursty_events(s["g"])
    results = {}
    for depth in (1, 2):
        fe = _frontend(s, mode="compiled", spmm_impl="fused",
                       pipeline_depth=depth)
        for _ in range(depth + 2):               # warm HWMs + pack pool
            _replay(fe, events)
        base = {n: e.pack_stats["allocs"] for n, e in fe.engines.items()}
        reqs = _replay(fe, events)
        assert all(r.prediction >= 0 for r in reqs)
        for name, eng in fe.engines.items():
            assert eng.pack_stats["allocs"] == base[name], name
        results[depth] = reqs
    for a, b in zip(results[1], results[2]):
        assert (a.node_id, a.slo_class, a.prediction, a.exit_order) == \
            (b.node_id, b.slo_class, b.prediction, b.exit_order)


def test_frontend_matches_direct_engines(setup):
    s = setup
    classes = _classes(s["nai"])
    fe = _frontend(s, classes, mode="compiled", spmm_impl="fused",
                   pipeline_depth=2)
    reqs = _replay(fe, _bursty_events(s["g"], seed=3))
    groups = defaultdict(list)
    for r in reqs:
        assert r.batch_id >= 0
        groups[(r.slo_class, r.batch_id)].append(r)
    for c in classes:
        eng = NAIServingEngine(s["cfg"], c.nai, s["heads"], s["g"],
                               device="cpu", max_wait_s=10.0,
                               mode="compiled", spmm_impl="fused")
        for key in sorted(k for k in groups if k[0] == c.name):
            orig = groups[key]
            eng.submit([r.node_id for r in orig])
            replay = eng.step()
            assert [(r.node_id, r.prediction, r.exit_order)
                    for r in replay] == \
                [(r.node_id, r.prediction, r.exit_order) for r in orig]


def test_goodput_accounting_and_reset(setup):
    s = setup
    g = s["g"]
    fe = _frontend(s, mode="host")
    hit = fe.submit(int(g.test_idx[0]), "gold", budget_s=1e6)
    miss = fe.submit(int(g.test_idx[1]), "gold", budget_s=0.0)
    fe.flush()
    assert hit.within_deadline and not miss.within_deadline
    st = fe.stats["gold"]
    assert (st.completed, st.deadline_hits, st.deadline_misses) == (2, 1, 1)
    summ = fe.summary()["gold"]
    assert summ["goodput_frac"] == pytest.approx(0.5)
    assert summ["batches"] >= 1
    fe.reset_stats()
    assert fe.stats["gold"].completed == 0
    assert fe.summary()["gold"]["batches"] == 0


@pytest.mark.parametrize("seed,n_bursts,queue_depth", [(0, 8, 4),
                                                       (5, 4, 1),
                                                       (11, 10, 12)])
def test_conservation_under_bursty_overload(setup, seed, n_bursts,
                                            queue_depth):
    s = setup
    fe = _frontend(s, _classes(s["nai"], queue_depth=queue_depth),
                   mode="compiled", spmm_impl="segment", pipeline_depth=2)
    events = _bursty_events(s["g"], n_bursts=n_bursts, seed=seed)
    accepted, terminal = [], []
    for t, cls, nid in events:
        r = fe.submit(nid, cls, now=t, budget_s=1e9)
        if r is not None:
            accepted.append(r)
        terminal += fe.step(now=t)
    terminal += fe.step(now=events[-1][0] + 100.0)
    terminal += fe.flush()
    ids = [id(r) for r in terminal]
    assert len(ids) == len(set(ids)), "a request terminated twice"
    assert set(ids) == set(id(r) for r in accepted)
    assert fe.pending() == 0
    for name, st in fe.stats.items():
        assert st.offered == st.accepted + st.rejected, name
        assert st.accepted == st.completed + st.failed, name
        assert st.failed == 0
    if queue_depth < BS:   # overload: backpressure must have shed
        assert sum(st.rejected for st in fe.stats.values()) > 0


def test_breaker_demotes_gold_and_recovers(setup):
    s = setup
    nai = s["nai"]
    classes = [
        SLOClass("gold", nai, deadline_s=10.0, max_wait_s=0.001,
                 queue_depth=64, demote_to="best_effort",
                 engine=EngineConfig(
                     mode="compiled", spmm_impl="fused",
                     faults=FaultPlan([FaultSpec("device", at=(0, 1, 2))],
                                      seed=3))),
        SLOClass("best_effort", dataclasses.replace(nai, t_max=nai.t_min),
                 deadline_s=10.0, max_wait_s=0.001, queue_depth=64),
    ]
    br = BreakerConfig(window=8, trip_frac=0.5, min_events=8,
                       cooldown_s=0.05, probes=1, count_misses=False)
    fe = _frontend(s, classes, breaker=br, mode="compiled",
                   spmm_impl="fused")
    rng = np.random.default_rng(11)
    t_end = time.perf_counter() + 10.0
    while time.perf_counter() < t_end:   # rounds of 8 on the wall clock
        for nid in rng.choice(s["g"].test_idx, size=8, replace=True):
            fe.submit(int(nid), "gold")
        guard = time.perf_counter() + 1.0
        while fe.pending() and time.perf_counter() < guard:
            fe.step()
        if fe.breakers["gold"].state == "closed" and \
                fe.stats["gold"].degraded:
            break
        time.sleep(0.01)                 # let the cooldown pass
    fe.flush()
    st, brk = fe.stats["gold"], fe.breakers["gold"]
    assert brk.trips >= 1 and st.degraded > 0 and brk.state == "closed"
    # the first batch of 8, then the two probes that re-opened it
    assert st.failed == 8 + 2
    assert st.offered == st.accepted + st.rejected
    assert st.accepted == st.completed + st.failed
    assert fe.pending() == 0
    assert fe.summary()["gold"]["breaker_trips"] == brk.trips
    fe.close()
