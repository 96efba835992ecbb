"""The `flickr-gamlp.seg500` cell's own pieces: the heads' readers
(`heads_ms`, `heads_mfu`) on a synthetic trace, GAMLP's head file, the
Flickr graph's published density, and a CPU dry run of the cell."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from bench import graphgen, harness, heads, trace
from bench.reference import nai as ref
from bench.tests.test_bench_trace import _Ev, _launch, _Prof

ROOT = Path(__file__).resolve().parents[2]
CELL = "flickr-gamlp.seg500"


# ------------------------------------------------------------ readers
def _summary(heads_range: bool):
    """Two batches: in `serve.dispatch` the loop's kernel, then (inside
    `serve.heads` where there is one) a gemm of 30 us and an argmax of 5
    us, then the results' copy back."""
    ev = [_Ev("bench.window", 0, 1000, id=1, is_user_annotation=True)]
    for b, t in enumerate((100, 500)):
        ev += [_Ev("serve.dispatch", t, t + 90, id=10 + b,
                   is_user_annotation=True)]
        if heads_range:
            ev += [_Ev("serve.heads", t + 40, t + 70, id=20 + b,
                       is_user_annotation=True)]
        for i, (op, t0, kernel, k0, k1) in enumerate((
                ("aten::index_add_", 10, "indexFuncLargeIndex", 100, 150),
                ("aten::addmm", 45, "sm90_gemm_f32", 150, 180),
                ("aten::argmax", 55, "reduce_kernel", 180, 185),
                ("aten::copy_", 80, "Memcpy DtoH (Device -> Pinned)", 185,
                 190))):
            call = 30 + 10 * b + i
            ev += _launch(1000 + call, call, op, t + t0, kernel, t + k0,
                          t + k1)
    return trace.summarize(_Prof(ev))


class _Ctx:
    def __init__(self, summ, n_batches=2, head_flops=3.8e9):
        self.trace = summ
        self.n_batches = n_batches
        self.needs = {"head_flops": head_flops}
        self.peak = {"f32_flops": 67e12, "hbm_bytes_per_s": 3.35e12}
        self.batch_timings = []
        self.window_s = 1e-3


def test_heads_readers_read_the_heads_range():
    summ = _summary(True)
    assert summ.span_device_s["serve.heads"] == pytest.approx(70e-6,
                                                             rel=1e-12)
    assert summ.loop_s == pytest.approx(100e-6, rel=1e-12)
    ms = harness.load_reader("heads_ms").read(_Ctx(summ))
    assert ms == pytest.approx(35e-3, rel=1e-12)
    mfu = harness.load_reader("heads_mfu").read(_Ctx(summ))
    assert mfu == pytest.approx(100.0 * 3.8e9 / (70e-6 * 67e12), rel=1e-12)


@pytest.mark.parametrize("metric", ["heads_ms", "heads_mfu"])
def test_heads_readers_read_nothing_without_the_range(metric):
    """A program without `serve.heads` (the parent), or a run without a
    trace, reads None and does not raise."""
    reader = harness.load_reader(metric)
    summ = _summary(False)
    assert "serve.heads" not in summ.span_device_s
    assert reader.read(_Ctx(summ)) is None
    assert reader.read(_Ctx(None)) is None
    assert reader.read(_Ctx(_summary(True), n_batches=0)) is None


# ------------------------------------------------------ the head file
GCFG = harness.load_cell(CELL)["config"]["gnn"]


def test_draws_are_published_widths_and_inits():
    arch = heads.load("jk_gamlp")
    f, h, c = GCFG["feat_dim"], GCFG["hidden"], GCFG["num_classes"]
    assert (f, h, c, GCFG["jk_layers"], GCFG["mlp_layers"]) == (
        500, 512, 7, 4, 4)
    entries = arch.draws(GCFG)
    by = {(l, k): (shape, init) for l, k, shape, init in entries}
    assert len(by) == len(entries)
    for l in (1, 2, 3):
        assert by[(l, "jk_w0")][0] == ((l + 1) * h, h)
        assert by[(l, f"hop{l}_w0")] == ((f, h), ("normal", f ** -0.5))
        assert by[(l, "att_u")][0] == (2 * h, 1)
        assert by[(l, "out_w3")][0] == (h, c)
        assert (l, "out_w4") not in by and (l, "jk_w4") not in by
        assert by[(l, "alpha")] == ((1,), ("const", 0.5))
        for key in ("prelu", "jk_prelu", "out_prelu", f"hop{l}_prelu"):
            assert by[(l, key)] == ((1,), ("const", 0.25))
        for key in ("att_c", "res_b", f"hop{l}_b0", f"hop{l}_b1"):
            assert by[(l, key)][1] == ("normal", 0.0)


def test_control_moves_the_heads_logits():
    """The control's TF32 products reach GAMLP's heads: on one batch at
    published widths its logits differ from the float64 reference's by
    far more than float32 rounding, and the reference's own logits are
    finite and spread."""
    g = harness.load_cell(CELL)["config"]["graph"]
    ga = graphgen.make_sbm(g["preset"], scale=0.02 * g["scale"],
                           seed=2**31 + 3, edges=g["edges"])
    eg = ref.EdgeGraph(ga.n, ga.src, ga.dst)
    tree = harness.make_heads(GCFG, 2**31 + 3, "cpu")
    logits = heads.load("jk_gamlp").logits
    kw = dict(logits=logits, r=0.5, t_min=1, t_max=2, t_s=1.0)
    batch = np.sort(ga.test_idx[:16])
    hi = ref.Reference(eg, ga.features, tree, **kw).batch(batch).logits
    lo = ref.Reference(eg, ga.features, tree, dtype=torch.float32,
                       tf32=True, **kw).batch(batch).logits
    span = np.ptp(hi, axis=2)
    assert np.isfinite(hi).all() and span.min() > 0
    rel = np.abs(lo - hi).max(axis=2) / span
    assert rel.max() > 1e-4


# ------------------------------------------------------------ the graph
@pytest.mark.parametrize("scale", [0.02, 1.0])
def test_flickr_graph_has_the_published_edge_count(scale):
    """Flickr's 899,756 adjacency entries are 449,878 undirected edges
    (mean degree 10.08); the draw comes within the 2 that the nearest
    whole ``edges`` misses by at the cell's scale."""
    conf = harness.load_cell(CELL)["config"]["graph"]
    n_full = graphgen.PRESETS[conf["preset"]][0]
    assert (conf["nodes"], conf["undirected_edges"]) == (89_250, 449_876)
    assert abs(2 * conf["undirected_edges"] - 899_756) <= 4
    ga = graphgen.make_sbm(conf["preset"], scale=scale * conf["scale"],
                           seed=2**31 + 13, edges=conf["edges"])
    want = (conf["edges"] * ga.n + n_full // 2) // n_full
    loop = ga.src == ga.dst
    assert loop.sum() == ga.n and (len(ga.src) - ga.n) // 2 == want
    u, v = ga.src[~loop].astype(np.int64), ga.dst[~loop].astype(np.int64)
    assert len(np.unique(np.minimum(u, v) * ga.n + np.maximum(u, v))) == want
    if scale == 1.0:
        assert (ga.n, want) == (conf["nodes"], conf["undirected_edges"])
        assert ga.features.shape == (conf["nodes"], conf["features"])
        assert round(2 * want / ga.n, 2) == 10.08


# ------------------------------------------------------------ dry run
DRY_RUN = """
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
import torch
torch.set_num_threads(1)
from bench import harness
cell = harness.load_cell({cell!r})
cell["config"]["graph"]["scale"] *= 0.02
cell["mix"]["batch"] = 32
out = harness.run_cell(cell, 2**31 + 7, 0.5, {trace}, device="cpu",
                       log=lambda s: None)
print(json.dumps(dict(correct=out["correct"], metrics=sorted(out["metrics"]),
                      compared=out["compared"],
                      modules=harness.forbidden_modules())))
"""


@pytest.mark.parametrize("trace_on", [False, True])
def test_cpu_dry_run_loads_no_jax(trace_on):
    code = DRY_RUN.format(root=str(ROOT), src=str(ROOT / "src"), cell=CELL,
                          trace=trace_on)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env)
    assert res.returncode == 0, res.stderr[-2000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] is True and out["compared"] > 0
    assert out["modules"] == []
    want = ({"host_ms", "nai_mfu"} if trace_on
            else {"nodes_per_s", "setup_s"})
    assert set(out["metrics"]) == want
