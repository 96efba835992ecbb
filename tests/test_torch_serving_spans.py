"""The serving engine's spans and per-batch stage record: under
`torch.profiler` a compiled-mode engine emits every `serve.*` range,
nested as the stages nest (the host stage's four parts inside
`serve.host`, `serve.dispatch` after it, the heads' `serve.heads` inside
`serve.dispatch`); `batch_timings` holds each
part's seconds, summing to no more than `host_s`; the placed collectives'
`exchange.*` ranges open only under a profiler too."""
import contextlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.gnn import GNNConfig, NAIConfig, init_classifiers
from repro_torch.gnn import load_dataset
from repro_torch.device import profiled
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.serving import NAIServingEngine
from repro_torch.sharding import placement

torch.set_num_threads(1)
BATCH = 16
HOST = ("serve.host.sample", "serve.host.gather", "serve.host.factors",
        "serve.host.pack")
HOST_KEYS = ("sample_s", "gather_s", "factors_s", "pack_s")
CASES = {"segment-2": dict(spmm_impl="segment", pipeline_depth=2),
         "block_ell-1": dict(spmm_impl="block_ell", pipeline_depth=1),
         "fused-2": dict(spmm_impl="fused", pipeline_depth=2),
         "sharded-2": dict(spmm_impl="block_ell", pipeline_depth=2,
                           mesh=2)}


@pytest.fixture(scope="module")
def setup():
    g = load_dataset("pubmed-like", scale=0.02, seed=4)
    cfg = GNNConfig("sgc", g.features.shape[1], g.num_classes, k=2)
    nai = NAIConfig(t_s=6.0, t_min=1, t_max=2, batch_size=BATCH)
    heads = init_classifiers(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    nodes = np.random.default_rng(0).choice(g.test_idx, size=2 * BATCH,
                                            replace=False)
    return dict(g=g, cfg=cfg, nai=nai, heads=heads, nodes=nodes)


def _engine(setup, case):
    kw = dict(CASES[case])
    if "mesh" in kw:
        kw["mesh"] = make_serving_mesh(kw["mesh"],
                                       devices=("cpu",) * kw["mesh"])
    return NAIServingEngine(setup["cfg"], setup["nai"], setup["heads"],
                            setup["g"], device="cpu", mode="compiled", **kw)


def _serve(eng, nodes):
    eng.submit(nodes)
    done = []
    while eng.queue:
        done += eng.step()
    return done + eng.flush()


def _inside(inner, outers):
    a, b = inner.time_range.start, inner.time_range.end
    return any(o.time_range.start <= a and b <= o.time_range.end
               for o in outers)


@pytest.mark.parametrize("case", sorted(CASES))
def test_spans_nest_as_the_stages(setup, case):
    eng = _engine(setup, case)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _serve(eng, setup["nodes"])
    spans = {}
    for e in prof.events():
        if e.name.startswith("serve."):
            spans.setdefault(e.name, []).append(e)
    assert sorted(spans) == sorted(("serve.host", "serve.dispatch",
                                    "serve.heads") + HOST)
    assert all(len(v) == 2 for v in spans.values()), \
        {k: len(v) for k, v in spans.items()}
    for name in HOST:
        assert all(_inside(e, spans["serve.host"]) for e in spans[name])
    assert not any(_inside(e, spans["serve.host"])
                   for e in spans["serve.dispatch"])
    assert all(_inside(e, spans["serve.dispatch"])
               for e in spans["serve.heads"])
    ends = sorted(e.time_range.end for e in spans["serve.host"])
    starts = sorted(e.time_range.start for e in spans["serve.dispatch"])
    assert all(a <= b for a, b in zip(ends, starts))


@pytest.mark.parametrize("case", sorted(CASES))
def test_batch_timings_record_the_stages(setup, case):
    eng = _engine(setup, case)
    done = _serve(eng, setup["nodes"])
    timings = list(eng.batch_timings)
    assert len(timings) == 2
    assert sum(rec["n"] for rec in timings) == len(done) == 2 * BATCH
    for rec in timings:
        assert all(isinstance(rec[k], float) and rec[k] >= 0.0
                   for k in HOST_KEYS)
        assert sum(rec[k] for k in HOST_KEYS) <= rec["host_s"]
        assert set(rec) == {"host_s", "dispatch_s", "sync_s", "n",
                            *HOST_KEYS}


def test_ranges_only_while_a_profiler_records():
    """Off the profiler a span opens no range (it would cost ~15 us a
    span); under it, one `record_function` range."""
    assert isinstance(profiled("serve.x"), contextlib.nullcontext)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        rng = profiled("serve.x")
        with rng:
            pass
    assert isinstance(rng, torch.profiler.record_function)
    assert [e.name for e in prof.events()].count("serve.x") == 1


def test_heads_range_only_while_a_profiler_records(setup, monkeypatch):
    """Without a profiler the engine opens no `serve.*` range, the heads'
    included: `profiled` hands back no `record_function`."""
    opened = []
    monkeypatch.setattr(torch.profiler, "record_function", opened.append)
    eng = _engine(setup, "segment-2")
    assert len(_serve(eng, setup["nodes"])) == 2 * BATCH
    assert opened == []


def test_exchange_ranges_only_while_a_profiler_records(monkeypatch):
    """A placed collective's `exchange.*` range goes through `profiled`:
    one range under a profiler, none opened without one."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with placement._exchange("all_gather"):
            pass
    assert [e.name for e in prof.events()].count("exchange.all_gather") == 1
    opened = []
    monkeypatch.setattr(torch.profiler, "record_function", opened.append)
    with placement._exchange("all_gather"):
        pass
    assert opened == []
