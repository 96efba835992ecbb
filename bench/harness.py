"""The benchmark harness: one cell, one seed, one run.

    python3 -m bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell of `BENCHMARK.json` names a configuration (`bench/configs/`, the
graph, the heads and the NAI rule) and a traffic mix (`bench/traffic/`,
the loop, the batch, the engine's serving options). A configuration's
head architecture (its weights' draw, the reference's logits, the counted
work) is `bench/heads/<base_model>.py`, per-layer metrics are readers in
`bench/metrics/<metric>.py`, and the limits of the comparison that
decides `correct` are in `bench/limits/<cell>.json`; all are found by
name, so a new cell, mix, head architecture or metric is a new file.

Set-up (`setup_s`, from process start to the first timed request): the
graph from the seed by the frozen generator, wrapped as the program's
`InMemoryStore`; the heads drawn from the seed on the device; T_s by the
configuration's rule; the engine; warm batches until its pinned pools
and shape buckets stop growing. The window drives `NAIServingEngine` through `submit`,
`step` / `poll` and `flush` only. Once it has closed the peak memory is
read, the engine is freed, and the reference works out every completed
batch again (`bench/correct.py`).
"""
from __future__ import annotations

import argparse
import functools
import gc
import itertools
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "bench"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_cell(name: str, spec: Optional[dict] = None) -> dict:
    """The cell `name` with its configuration, mix, limits and metrics."""
    spec = load_json(ROOT / "BENCHMARK.json") if spec is None else spec
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r} (one of {sorted(cells)})")
    w = cells[name]
    conf_file = {c["name"]: c["file"] for c in spec["configs"]}[w["config"]]

    def applies(m):
        return name in m.get("workloads", [name])
    return dict(
        name=name, chips=w["chips"],
        config=load_json(ROOT / conf_file),
        mix=load_json(BENCH / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(BENCH / "limits" / f"{name}.json"),
        end_to_end=[m for m in spec["end_to_end"] if applies(m)],
        per_layer=[m for m in spec["per_layer"] if applies(m)])


def load_reader(metric: str):
    """The module `bench/metrics/<metric>.py`: its `read(ctx)` and what it
    declares (UNIT, LAYER, MOVES, SOURCE)."""
    import importlib.util
    path = BENCH / "metrics" / f"{metric}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"bench.metrics.{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> List[str]:
    """Top-level names in `sys.modules` of JAX or the JAX package."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


# ------------------------------------------------------------ set-up
def make_heads(gcfg: dict, seed: int, device) -> Dict[int, Dict]:
    """The per-order heads' weights from the seed, as the head module's
    `draws` lists them: the normal entries from one `torch.randn` on
    `device`, the constants filled in. The numpy tree that
    `repro_torch.gnn.convert.params_from_numpy` and the reference both
    take."""
    import torch
    from bench import heads
    entries = heads.load(gcfg["base_model"]).draws(gcfg)
    total = sum(int(np.prod(shape)) for _, _, shape, (kind, _) in entries
                if kind == "normal")
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    flat = torch.randn(total, generator=gen, device=device,
                       dtype=torch.float32).cpu().numpy()
    tree: Dict[int, Dict] = {}
    off = 0
    for l, key, shape, (kind, value) in entries:
        if kind == "normal":
            n = int(np.prod(shape))
            w = flat[off:off + n].reshape(shape) * np.float32(value)
            off += n
        elif kind == "const":
            w = np.full(shape, value, np.float32)
        else:
            raise ValueError(f"{key}: init {kind!r}, not normal or const")
        tree.setdefault(l, {})[key] = w
    return tree


def build(cell: dict, seed: int, device: str, log=lambda s: None):
    """Graph, heads, T_s and engine of a cell (no warm-up)."""
    import torch
    from bench import graphgen
    from bench.reference import nai as ref
    from repro_torch.gnn.convert import params_from_numpy
    from repro_torch.gnn.graph import Graph
    from repro_torch.gnn.models import GNNConfig
    from repro_torch.gnn.nai import NAIConfig
    from repro_torch.gnn.store import InMemoryStore
    from repro_torch.serving.engine import NAIServingEngine
    conf, mix = cell["config"], cell["mix"]
    gspec = conf["graph"]
    t = time.perf_counter()
    ga = graphgen.make_sbm(gspec["preset"], scale=gspec["scale"], seed=seed,
                           edges=gspec.get("edges"))
    graph = Graph(n=ga.n, src=ga.src, dst=ga.dst, features=ga.features,
                  labels=ga.labels, num_classes=ga.num_classes,
                  train_idx=ga.train_idx, unlabeled_idx=ga.unlabeled_idx,
                  test_idx=ga.test_idx, name=ga.name)
    store = InMemoryStore(graph)
    eg = ref.EdgeGraph(ga.n, ga.src, ga.dst, device=device)
    log(f"graph {ga.name}: {ga.n} nodes, {(len(ga.src) - ga.n) // 2} "
        f"undirected edges "
        f"({time.perf_counter() - t:.2f} s)")
    gcfg = conf["gnn"]
    tree = make_heads(gcfg, seed, device)
    cfg = GNNConfig(**gcfg)
    heads = params_from_numpy(cfg, tree, device=device)
    t = time.perf_counter()
    rule = conf["nai"]["t_s_rule"]
    t_s = ref.first_step_distance_quantile(eg, ga.features, cfg.r,
                                           q=rule["quantile"])
    log(f"T_s {t_s!r} ({time.perf_counter() - t:.2f} s)")
    nai = NAIConfig(t_s=t_s, t_min=conf["nai"]["t_min"],
                    t_max=conf["nai"]["t_max"], batch_size=mix["batch"])
    eng = NAIServingEngine(cfg, nai, heads, store, device=device,
                           mode="compiled", **mix["engine"])
    if device != "cpu":
        torch.cuda.synchronize()
    return dict(graph=ga, eg=eg, gcfg=gcfg, tree=tree, cfg=cfg, nai=nai,
                engine=eng, t_s=t_s)


def _taken(engine, k: int) -> list:
    """The last `k` requests of the engine's queue (just submitted)."""
    q = engine.queue
    return list(itertools.islice(q, len(q) - k, len(q)))


def warm(engine, batches, max_batches: int, min_passes: int = 2,
         first=()) -> int:
    """Serve `first`, then warm batches until passes of pool-rotation
    length add no pinned buffer set and no shape key `min_passes` times in
    a row. Returns batches served."""
    per_pass = engine.pipeline_depth + 1
    served = 0
    for ids in first:
        engine.submit(ids)
        engine.step()
        served += 1
    quiet = 0
    while served < max_batches and quiet < min_passes:
        before = (engine.pack_stats["allocs"], engine.jit_stats["compiles"])
        for _ in range(per_pass):
            engine.submit(next(batches))
            engine.step()
            served += 1
        engine.flush()
        after = (engine.pack_stats["allocs"], engine.jit_stats["compiles"])
        quiet = quiet + 1 if after == before else 0
    return served


def largest_first(eg, plan, hops: int, k: int) -> list:
    """The `k` batches of `plan` with the largest `hops`-hop supports,
    largest first: the window's own shapes, so that the engine's buffers
    reach its high-water marks before the window opens."""
    sizes = [int(eg.expand(eg.mask(b), hops).sum()) for b in plan]
    return [plan[i] for i in np.argsort(sizes)[::-1][:k]]


# ------------------------------------------------------------ windows
def closed_window(engine, batches, seconds: float, span) -> dict:
    reqs = []
    t0 = time.perf_counter()
    with span("bench.window"):
        while time.perf_counter() - t0 < seconds:
            ids = next(batches)
            with span("bench.step"):
                engine.submit(ids, now=time.perf_counter())
                reqs += _taken(engine, len(ids))
                engine.step()
        with span("bench.flush"):
            engine.flush()
    done = [r.done_s for r in reqs if r.status == "completed"]
    t1 = max(done) if done else time.perf_counter()
    return dict(requests=reqs, t0=t0, t1=t1)


# ------------------------------------------------------------ the check
def batches_of(reqs) -> Dict[int, list]:
    out: Dict[int, list] = {}
    for r in reqs:
        if r.status == "completed":
            out.setdefault(r.batch_id, []).append(r)
    return out


def answers(rs: list):
    """Distinct nodes of one batch's requests and the program's exit order
    and class for each."""
    nodes = np.array([r.node_id for r in rs], np.int64)
    uniq, first = np.unique(nodes, return_index=True)
    return (uniq, np.array([rs[i].exit_order for i in first]),
            np.array([rs[i].prediction for i in first]))


def reference(built: dict, **kw):
    from bench import heads
    from bench.reference import nai as ref
    gcfg, nai = built["gcfg"], built["nai"]
    return ref.Reference(built["eg"], built["graph"].features, built["tree"],
                         logits=heads.load(gcfg["base_model"]).logits,
                         r=gcfg["r"], t_min=nai.t_min, t_max=nai.t_max,
                         t_s=built["t_s"], **kw)


def check(built: dict, batches: Dict[int, list], stand_ins=None) -> dict:
    """Widest gaps over every completed batch of the window, each worked
    out again by the reference. `stand_ins` (name -> function of the
    batch's nodes and the reference's answer, giving exit orders and
    classes) are read the same way in the program's place."""
    from bench import correct
    nai = built["nai"]
    kw = dict(t_min=nai.t_min, t_max=nai.t_max, t_s=built["t_s"])
    ref = reference(built)
    zero = {"order_gap": 0.0, "logit_gap": 0.0}
    nums = dict(zero)
    others = {name: dict(zero) for name in (stand_ins or {})}
    compared = 0
    for b in sorted(batches):
        uniq, orders, preds = answers(batches[b])
        out = ref.batch(uniq)
        nums = correct.merge(nums, correct.gaps(
            out.orders, out.dist, out.logits, orders, preds, **kw))
        for name, fn in (stand_ins or {}).items():
            o, p = fn(uniq, out)
            others[name] = correct.merge(others[name], correct.gaps(
                out.orders, out.dist, out.logits, o, p, **kw))
        compared += len(uniq)
    return dict(numbers=nums, stand_ins=others, compared=compared,
                batches=len(batches))


# ------------------------------------------------------------ metrics
class Context:
    """What a per-layer metric's reader may read: the window's batch
    timings (the engine's own spans), the trace summary, the window's
    length, the chip's peaks, and the counted needs of the window's
    batches (worked out on first use)."""

    def __init__(self, timings, trace, window_s, peak, built, batches):
        self.batch_timings = timings
        self.trace = trace
        self.window_s = window_s
        self.peak = peak
        self.n_batches = len(batches)
        self._count = (built, batches)

    @functools.cached_property
    def needs(self) -> dict:
        return count_needs(*self._count)


def count_needs(built: dict, batches: Dict[int, list]) -> dict:
    """Summed needs of every batch of the window (bench.metrics._counting),
    at the program's exit orders, from the configuration's own sizes."""
    from bench import heads
    from bench.metrics import _counting as cnt
    gcfg, nai, peak = built["gcfg"], built["nai"], built["peak"]
    arch = heads.load(gcfg["base_model"])
    flops = bytes_ = step_time = head = 0.0
    for rs in batches.values():
        uniq, orders, _ = answers(rs)
        head += cnt.head_flops(arch, gcfg, orders)
        for s in cnt.step_needs(built["eg"], uniq, orders, gcfg["feat_dim"],
                                nai.t_min, nai.t_max):
            flops += s.flops
            bytes_ += s.bytes
            step_time += cnt.roofline_s(s.flops, s.bytes, peak["f32_flops"],
                                        peak["hbm_bytes_per_s"])
    return dict(step_flops=flops, step_bytes=bytes_, step_roofline_s=step_time,
                head_flops=head)


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else None
    except (OSError, subprocess.SubprocessError):
        return None


# ------------------------------------------------------------ a run
def run_cell(cell: dict, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", t_process: Optional[float] = None,
             log=None, stand_ins=None) -> dict:
    """One run of `cell`; returns the result's fields. `device="cpu"` is
    the dry run the tests make: the same path with the program on the
    CPU, no profiler."""
    import torch
    from bench import correct, generator
    from bench.peaks import peaks
    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    t_process = time.perf_counter() if t_process is None else t_process
    mix = cell["mix"]
    if mix["loop"] != "closed":
        raise SystemExit(f"mix loop {mix['loop']!r}: the harness drives "
                         "closed loops only")
    built = build(cell, seed, device, log)
    eng = built["engine"]
    dev_name = (torch.cuda.get_device_name(0) if device != "cpu" else "cpu")
    built["peak"] = peaks(dev_name)
    rng_warm, rng_window = generator.rngs(seed)
    pool = built["graph"].test_idx
    warm_cfg = mix.get("warm", {})
    # the window's batches drawn now; it takes more from the same stream
    # if it outruns them
    window_batches = generator.closed_batches(rng_window, pool, mix["batch"])
    plan = [next(window_batches) for _ in range(mix["planned_batches"])]
    served = warm(eng, generator.closed_batches(rng_warm, pool, mix["batch"]),
                  warm_cfg.get("max_batches", 24),
                  warm_cfg.get("min_passes", 2),
                  first=largest_first(built["eg"], plan, built["nai"].t_max,
                                      warm_cfg.get("largest", 0)))
    eng.reset_stats()
    allocs0 = dict(eng.pack_stats)
    keys0 = dict(eng.jit_stats)
    log(f"warm: {served} batches, pack {allocs0}, shape keys {keys0}")

    prof = None
    if trace and device != "cpu":
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.__enter__()
    span = (torch.profiler.record_function if prof is not None
            else (lambda name: _Null()))
    if device != "cpu":
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_process
    win = closed_window(eng, itertools.chain(plan, window_batches), seconds,
                        span)
    if device != "cpu":
        torch.cuda.synchronize()
    if prof is not None:
        prof.__exit__(None, None, None)
    found = forbidden_modules()
    mem_peak = (torch.cuda.max_memory_allocated() if device != "cpu" else 0)
    reqs = win["requests"]
    timings = list(eng.batch_timings)
    if timings:
        q = np.percentile([b["host_s"] for b in timings], [10, 50, 90])
        log(f"host_s p10/p50/p90 {q[0]:.4f} {q[1]:.4f} {q[2]:.4f}, "
            f"dispatch {np.mean([b['dispatch_s'] for b in timings]):.4f}, "
            f"sync {np.mean([b['sync_s'] for b in timings]):.4f}")
    log(f"window: {len(reqs)} requests, {len(timings)} batches, pack "
        f"{eng.pack_stats} (window allocs "
        f"{eng.pack_stats['allocs'] - allocs0['allocs']}), shape keys "
        f"{eng.jit_stats}, exit histogram {dict(sorted(eng.stats.exit_hist.items()))}")
    eng.close()
    del eng, built["engine"]
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()

    attempted = len(reqs)
    failed = sum(r.status != "completed" for r in reqs)
    batches = batches_of(reqs)
    t_chk = time.perf_counter()
    chk = check(built, batches,
                stand_ins(built) if callable(stand_ins) else stand_ins)
    log(f"check: {chk['compared']} nodes of {chk['batches']} batches "
        f"({time.perf_counter() - t_chk:.2f} s)")
    limits = {k: v["limit"] for k, v in cell["limits"].items()}
    checks = {k: [chk["numbers"][k], limits[k]] for k in limits}
    checks["missing"] = [failed, 0]
    ok = (failed == 0 and chk["compared"] > 0
          and correct.judge(chk["numbers"], limits))

    window_s = win["t1"] - win["t0"]
    metrics: Dict[str, dict] = {}
    out = dict(correct=bool(ok), attempted=attempted, failed=failed,
               forbidden=found, checks=checks, stand_ins=chk["stand_ins"],
               compared=chk["compared"])
    if not trace:
        values = {"setup_s": setup_s,
                  "nodes_per_s": (attempted - failed) / max(window_s, 1e-9)}
        for m in cell["end_to_end"]:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        summ = None
        if prof is not None:
            from bench.trace import summarize
            summ = summarize(prof)
            log(f"device s by launching span: {summ.span_device_s}")
            out["device_extra"] = dict(busy_s=summ.busy_s,
                                       window_s=summ.window_s)
            out["breakdown"] = dict(
                device_ops=[[k, v] for k, v in summ.device_ops],
                idle_gaps=[[k, v] for k, v in summ.idle_gaps])
        ctx = Context(timings, summ, window_s, built["peak"], built, batches)
        for m in cell["per_layer"]:
            v = load_reader(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    out["metrics"] = metrics
    out["device"] = dict(
        platform="gpu" if device != "cpu" else "cpu", kind=dev_name,
        count=cell["chips"], memory_peak_bytes=int(mem_peak))
    out["device"].update(out.pop("device_extra", {}))
    return out


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def main(argv=None, t_process: Optional[float] = None) -> int:
    t_process = time.perf_counter() if t_process is None else t_process
    ap = argparse.ArgumentParser(prog="bench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell["chips"]:
        print(f"{cell['name']} needs {cell['chips']} cards, found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 3
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   t_process=t_process)
    found = out.pop("forbidden") or forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package loaded: {found}",
              file=sys.stderr)
        return 4
    pl = power_limit()
    if pl:
        out["device"]["power_limit"] = pl
    checks = out.pop("checks")
    line = {k: out[k] for k in ("correct", "attempted", "failed", "metrics",
                                "device")}
    if "breakdown" in out:
        line["breakdown"] = out["breakdown"]
    out.pop("stand_ins")
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in checks.items()}
    for k, (v, lim) in checks.items():
        print(f"check {k}: {v!r} (limit {lim!r})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0

