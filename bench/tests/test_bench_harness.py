"""Self-check of the benchmark: BENCHMARK.json against the contract's
character and shape rules, every cell resolving by name, what the
harness and the reference import, and a CPU dry run of the harness."""
import ast
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from bench import harness

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _line(s):
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    assert all(_line(w) for w in SPEC["command"])
    for p in SPEC["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p)
        assert (ROOT / p).is_dir()
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_names_and_units(section):
    entries = SPEC[section]
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") \
            else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for k in ("why", "layer"):
            if k in e:
                assert _line(e[k])
        if section == "workloads":
            assert NAME.match(e["config"]) and NAME.match(e["traffic"])
            assert e["chips"] in (1, 4) and _line(e["why"])
        if section == "configs":
            assert _line(e["source"])
            assert all(NAME.match(k) for k in e["reduced"])
            assert (ROOT / e["file"]).is_file()
            assert e["file"].startswith(tuple(SPEC["paths"]))
        if section == "end_to_end":
            assert e["source"] in ("host_clock", "device_trace")
            assert 0.01 <= e["bound"] <= 0.25
        if section == "per_layer":
            assert e["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
            assert _line(e["layer"])


def _cells_reporting(metric):
    return set(metric.get("workloads",
                          [w["name"] for w in SPEC["workloads"]]))


def test_every_cell_reports_setup_another_e2e_and_a_layer_metric():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for w in SPEC["workloads"]:
        mine = [m for m in SPEC["end_to_end"]
                if w["name"] in _cells_reporting(m)]
        assert len(mine) >= 2, w["name"]
        assert any(w["name"] in _cells_reporting(m)
                   for m in SPEC["per_layer"]), w["name"]


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_layer_metric_moves_a_metric_its_cells_report(metric):
    m = {x["name"]: x for x in SPEC["per_layer"]}[metric]
    moved = {x["name"]: x for x in SPEC["end_to_end"]}[m["moves"]]
    assert _cells_reporting(m) <= _cells_reporting(moved)
    reader = harness.load_reader(metric)
    assert (reader.UNIT, reader.LAYER, reader.MOVES, reader.SOURCE) == (
        m["unit"], m["layer"], m["moves"], m["source"])
    assert callable(reader.read)


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_resolves_by_name(cell):
    c = harness.load_cell(cell)
    assert c["config"]["name"] == cell.split(".")[0]
    assert c["mix"]["loop"] == "closed"
    assert set(c["limits"]) == {"order_gap", "logit_gap"}
    conf = {x["name"]: x for x in SPEC["configs"]}[c["config"]["name"]]
    assert c["config"]["reduced"] == conf["reduced"]


@pytest.mark.parametrize("scale", [0.02, 1.0])
def test_graph_has_the_published_edge_count(scale):
    """The configuration's graph holds its published count of distinct
    undirected edges (scaled with the nodes below 1.0), a self loop at
    every node, each edge both ways, and the draw's own labels,
    features and splits."""
    import numpy as np
    from bench import graphgen
    conf = harness.load_cell("arxiv-sgc.seg500")["config"]["graph"]
    assert (conf["nodes"], conf["edges"]) == (169_343, 1_166_243)
    ga = graphgen.make_sbm(conf["preset"], scale=scale, seed=2**31 + 11,
                           edges=conf["edges"])
    want = (conf["edges"] * ga.n + conf["nodes"] // 2) // conf["nodes"]
    loop = ga.src == ga.dst
    assert loop.sum() == ga.n and (len(ga.src) - ga.n) // 2 == want
    u, v = ga.src[~loop].astype(np.int64), ga.dst[~loop].astype(np.int64)
    fwd = np.unique(np.minimum(u, v) * ga.n + np.maximum(u, v))
    assert len(fwd) == want
    assert np.array_equal(np.sort(u * ga.n + v), np.sort(v * ga.n + u))
    if scale == 1.0:
        assert ga.n == conf["nodes"] and round(2 * want / ga.n, 2) == 13.77
    base = graphgen.make_sbm(conf["preset"], scale=scale, seed=2**31 + 11)
    assert (len(base.src) - base.n) // 2 < want
    for key in ("features", "labels", "test_idx"):
        assert np.array_equal(getattr(base, key), getattr(ga, key)), key


def _imports(path):
    tree = ast.parse(Path(path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_jax_or_jax_package_imports():
    files = sorted((ROOT / "bench").rglob("*.py"))
    assert files
    for f in files:
        bad = set(_imports(f)) & {"jax", "jaxlib", "flax", "repro",
                                  "benchmarks"}
        assert not bad, (f, bad)
    for f in sorted((ROOT / "bench" / "reference").rglob("*.py")):
        assert "repro_torch" not in set(_imports(f)), f


DRY_RUN = """
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
import torch
torch.set_num_threads(1)
from bench import harness
cell = harness.load_cell("arxiv-sgc.seg500")
cell["config"]["graph"]["scale"] = 0.02
cell["mix"]["batch"] = 32
out = harness.run_cell(cell, 2**31 + 7, 0.5, {trace}, device="cpu",
                       log=lambda s: None)
print(json.dumps(dict(correct=out["correct"], metrics=sorted(out["metrics"]),
                      modules=harness.forbidden_modules())))
"""


@pytest.mark.parametrize("trace", [False, True])
def test_cpu_dry_run_loads_no_jax(trace):
    code = DRY_RUN.format(root=str(ROOT), src=str(ROOT / "src"), trace=trace)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env)
    assert res.returncode == 0, res.stderr[-2000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] is True
    assert out["modules"] == []
    want = ({"host_ms", "nai_mfu"} if trace
            else {"nodes_per_s", "setup_s"})
    assert set(out["metrics"]) == want


def test_run_refuses_without_the_card(tmp_path):
    """Without CUDA, or in a copy holding only BENCHMARK.json and bench/,
    the command exits non-zero and prints no result."""
    import shutil
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    args = [sys.executable, "-m", "bench.run", "--workload",
            "arxiv-sgc.seg500", "--seed", "3", "--seconds", "1", "--trace",
            "0"]
    res = subprocess.run(args, cwd=ROOT, capture_output=True, text=True,
                         timeout=120, env=env)
    assert res.returncode != 0 and res.stdout.strip() == ""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = subprocess.run(args, cwd=tmp_path, capture_output=True, text=True,
                         timeout=120, env=env)
    assert res.returncode != 0 and res.stdout.strip() == ""


class _Ctx:
    """A context without a trace, its needs as counted."""
    batch_timings = [{"host_s": 0.4, "n": 500, "dispatch_s": 0.0,
                      "sync_s": 0.0}]
    trace = None
    window_s = 10.0
    needs = {"step_flops": 1e9, "step_bytes": 1e9, "step_roofline_s": 1e-3,
             "head_flops": 1e8}
    peak = {"f32_flops": 67e12, "hbm_bytes_per_s": 3.35e12}
    n_batches = 1


@pytest.mark.parametrize("path", sorted(
    p.name for p in (ROOT / "bench" / "metrics").glob("[!_]*.py")))
def test_every_reader_declares_itself_and_reads(path):
    """Each reader, listed or kept for a later cell: its declarations, and
    a number or nothing (never a share of 0) from a context without a
    trace."""
    reader = harness.load_reader(path[:-3])
    assert UNIT.match(reader.UNIT) and _line(reader.LAYER)
    assert reader.SOURCE in ("device_trace", "program_span",
                             "program_counter", "host_clock")
    v = reader.read(_Ctx())
    assert v is None or (isinstance(v, float) and v > 0)
