"""The serving engine's shape-key counter (`NAIServingEngine.jit_stats`,
`jit_cache_size()`, the front-end's `jit_compiles`) against the JAX
package's engine on the same request streams: the port counts the
distinct operand-shape keys (`PackedSupport.shape_key`) its runner was
dispatched with, the reference the programs its jit compiled, keyed by
the same tuple. The reference's own cases, ported: a repeated batch hits
the key of the first (`tests/test_engine_compiled.py`), a smaller
support reuses the high-water-mark shape, the pipelined steady state
adds no key (`tests/test_engine_pipelined.py`), and every sharded gather
mode holds the same invariants (`tests/test_sharded_serving.py`, the JAX
engine in a subprocess with 8 host devices). Equal counts, pass by
pass."""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.gnn import GNNConfig as JConfig
from repro.gnn import init_classifiers as j_init
from repro.gnn import load_dataset as j_load
from repro.gnn.nai import NAIConfig as JNAI
from repro.serving import NAIServingEngine as JEngine
from repro.serving import ServingFrontend as JFrontend
from repro.serving.frontend import SLOClass as JSLOClass

from repro_torch.gnn import GNNConfig, NAIConfig, load_dataset
from repro_torch.gnn import params_from_numpy
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.serving import NAIServingEngine, ServingFrontend
from repro_torch.serving.frontend import SLOClass

from torch_parity import small_graph

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
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
    rng = np.random.default_rng(0)
    stream = [rng.choice(tg.test_idx, size=s, replace=False)
              for s in (32, 30, 32, 28)]
    return dict(jg=jg, tg=tg, jcfg=jcfg, tcfg=tcfg, params=params,
                tree=tree, heads=params_from_numpy(tcfg, tree, device="cpu"),
                jnai=JNAI(t_s=6.0, t_min=1, t_max=2, batch_size=BATCH),
                tnai=NAIConfig(t_s=6.0, t_min=1, t_max=2, batch_size=BATCH),
                stream=stream)


def _pair(s, **kw):
    """The JAX package's engine and the port's, alike."""
    j = JEngine(s["jcfg"], s["jnai"], s["params"], s["jg"],
                max_wait_s=10.0, mode="compiled", **kw)
    t = NAIServingEngine(s["tcfg"], s["tnai"], s["heads"], s["tg"],
                         device="cpu", max_wait_s=10.0, mode="compiled",
                         **kw)
    return j, t


def _serve(engine, stream):
    done = []
    for nodes in stream:
        engine.submit(nodes)
        done += engine.step()
    done += engine.flush()
    return done


def _same_counts(j, t):
    assert t.jit_stats == j.jit_stats
    assert t.jit_cache_size() == j.jit_cache_size()


@pytest.mark.parametrize("impl", ["segment", "block_ell", "fused"])
def test_same_bucket_batch_hits_the_first_key(setup, impl):
    """One batch, then the same batch again: one key, then a hit."""
    j, t = _pair(setup, spmm_impl=impl)
    nodes = np.asarray(setup["tg"].test_idx[:32])
    for e in (j, t):
        _serve(e, [nodes])
    assert t.jit_stats == {"compiles": 1, "hits": 0}
    _same_counts(j, t)
    for e in (j, t):
        _serve(e, [nodes])
    assert t.jit_stats == {"compiles": 1, "hits": 1}
    _same_counts(j, t)


def test_high_water_mark_reuses_the_shape(setup):
    """Three batches of 32 with supports of other sizes land in the
    high-water-mark buckets: every batch is a key or a hit, at least one
    a hit, as in the reference."""
    j, t = _pair(setup, spmm_impl="segment")
    rng = np.random.default_rng(1)
    for _ in range(3):
        nodes = rng.choice(setup["tg"].test_idx, size=32, replace=False)
        for e in (j, t):
            _serve(e, [nodes])
        _same_counts(j, t)
    assert t.jit_stats["compiles"] + t.jit_stats["hits"] == 3
    assert t.jit_stats["hits"] >= 1


@pytest.mark.parametrize("impl", ["segment", "fused"])
def test_pipelined_steady_state_adds_no_key(setup, impl):
    """Three passes of a ragged stream at pipeline depth 2: equal counts
    after each pass, and the third (the steady state) adds no key and
    allocates no pack buffer."""
    j, t = _pair(setup, spmm_impl=impl, pipeline_depth=2)
    for p in range(3):
        if p == 2:
            c0, a0 = t.jit_stats["compiles"], t.pack_stats["allocs"]
        for e in (j, t):
            _serve(e, setup["stream"])
        _same_counts(j, t)
    assert t.jit_stats["compiles"] == c0
    assert t.jit_stats["hits"] >= len(setup["stream"])
    assert t.pack_stats["allocs"] == a0


def test_frontend_reports_jit_compiles(setup):
    """The front-end's `summary()` reports each class engine's compiles
    as `jit_compiles`, as the reference's does, with the same value."""
    nodes = np.asarray(setup["tg"].test_idx[:64])
    out = []
    for Front, Slo, cfg, nai, heads, g, kw in (
            (JFrontend, JSLOClass, setup["jcfg"], setup["jnai"],
             setup["params"], setup["jg"], {}),
            (ServingFrontend, SLOClass, setup["tcfg"], setup["tnai"],
             setup["heads"], setup["tg"], dict(device="cpu"))):
        fe = Front(cfg, heads, g, [Slo("gold", nai, deadline_s=1e9,
                                       max_wait_s=1e9)], **kw)
        for i, n in enumerate(nodes):
            fe.submit(int(n), "gold", now=1e-3 * i)
        fe.flush()
        out.append(fe.summary()["gold"])
    assert out[1]["jit_compiles"] == out[0]["jit_compiles"] >= 1
    assert out[1]["pack_allocs"] == out[0]["pack_allocs"]


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
out = []
for impl, D, gm in args["cases"]:
    eng = NAIServingEngine(cfg, nai, params, g, max_wait_s=10.0,
                           mode="compiled", spmm_impl=impl,
                           pipeline_depth=2, mesh=make_serving_mesh(D),
                           gather_mode=gm)
    passes = []
    for _ in range(3):
        for nodes in args["stream"]:
            eng.submit(np.asarray(nodes))
            eng.step()
        eng.flush()
        passes.append([dict(eng.jit_stats), eng.jit_cache_size(),
                       eng.pack_stats["allocs"]])
    out.append(passes)
print("JAX_COUNTS " + json.dumps(out))
"""


def test_sharded_counts_match_the_jax_sharded_engine(setup, tmp_path):
    """Sharded engines (D shards of the CPU; the JAX package's in a
    subprocess with 8 host devices) over three passes of the stream, per
    gather mode: the same counts after every pass, and the third adds no
    key and no pack allocation."""
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
            if ln.startswith("JAX_COUNTS ")]
    assert line, p.stdout + p.stderr
    jax_counts = json.loads(line[0][len("JAX_COUNTS "):])
    for (impl, D, gm), want in zip(cases, jax_counts):
        eng = NAIServingEngine(
            setup["tcfg"], setup["tnai"], setup["heads"], setup["tg"],
            max_wait_s=10.0, mode="compiled", spmm_impl=impl,
            pipeline_depth=2, gather_mode=gm,
            mesh=make_serving_mesh(D, devices=("cpu",) * D))
        got = []
        for _ in range(3):
            _serve(eng, setup["stream"])
            got.append([dict(eng.jit_stats), eng.jit_cache_size(),
                        eng.pack_stats["allocs"]])
        assert [g[:2] for g in got] == [w[:2] for w in want], (impl, D, gm)
        assert got[2][0]["compiles"] == got[1][0]["compiles"]
        assert got[2][2] == got[1][2]
