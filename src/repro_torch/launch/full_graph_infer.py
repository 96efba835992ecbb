"""Checkpointed, preemption-tolerant full-graph offline NAI inference on
one device or over the shards of a mesh (the port of
`repro.launch.full_graph_infer`).

The serving stack answers per-batch queries; the paper's other product
surface is the batch job — classify EVERY node of a `GraphStore` graph, at
scales where one pass is a long-running job that must survive
preemption. This module is that surface:

* the whole graph is viewed as its own support and packed with the
  serving packer (`repro_torch.gnn.distributed.pack_graph`), with the real
  Eq. 7 stationary state so that Eq. 8 adaptive exits run;
* propagation runs as **supersteps** — one NAP step per dispatch
  (`repro_torch.gnn.backends.make_superstep`, the arithmetic of the
  serving loop's body) through the backend's kernels (B1 + B3 for
  ``block_ell``, B2 for ``fused``);
* after every superstep the state (padded features + exit orders) is
  copied to the host and committed to a CRC32-checksummed, atomically
  updated checkpoint (`repro_torch.launch.checkpoint.CheckpointManager`,
  the JAX package's format);
* a killed or preempted run resumes from the last complete superstep and
  produces the final predictions and exit orders of an uninterrupted run;
* classification runs on the device in ``cls_chunk``-row chunks.

Failure model:

* **crash / preemption at any instant** — the atomic manifest commit
  means the directory always names a complete superstep prefix; resume
  replays from the highest complete superstep k.
* **corrupt checkpoint** — CRC verification at load raises typed
  `CheckpointCorruption`; the job falls back one superstep at a time
  until a verifiable chain 0..k loads (0 = cold start), counting the
  fallbacks in `stats`.
* **checkpoint write failure** — recorded and tolerated: the run goes on
  (the in-memory state is good); a later crash resumes from an earlier
  superstep.
* **hang / straggler** — a per-superstep watchdog
  (`OfflineConfig.watchdog_s`) polls a CUDA event recorded after the
  superstep's launches until its deadline and retries the superstep (same
  inputs, same result); supersteps slower than `straggler_factor` x the
  median of the previous ones are recorded as stragglers. The
  ``superstep_hang`` fault stage simulates a hung dispatch through the
  same retry path.

Interrupted equals uninterrupted exactly on ``block_ell`` and ``fused``
(their kernels add in a fixed order), and on ``segment`` on the CPU. On
CUDA ``segment`` adds with atomics (``index_add_``), so its resumed run
equals an uninterrupted one only outside a margin around the threshold.

Sharded (``mesh=``, a mesh with a ``data`` axis of D > 1 devices): the
graph is packed with ``n_shards=D`` (and the halo frame unless
``gather_mode`` is ``dense``), each shard's operands and state live on its
device, and every superstep exchanges the frontier between shards
(`repro_torch.gnn.backends`). The checkpoint holds the state in packed
(shard-major) order, as the JAX package's does, with the shard count and
gather mode in its fingerprint; predictions and exit orders are
un-permuted to node order at the end, equal to the single-device run's.
At D = 1 every gather mode is the dense one.

CLI::

    PYTHONPATH=src python -m repro_torch.launch.full_graph_infer \\
        --store STORE_DIR --ckpt CKPT_DIR [--impl segment] [--t-max 3] \\
        [--t-s 6.0 | --t-s-quantile 0.5] [--crash-after K] [--device cuda] \\
        [--shards D --gather alltoall]

``--shards D`` takes the first D GPUs (`make_serving_mesh`, which raises
when fewer exist); with ``--device cpu`` the D shards share the CPU.

Exit code 17 = simulated preemption (``--crash-after``): the run stopped
on purpose after committing superstep K; rerun the same command to resume.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.gnn.backends import (GATHER_MODES, make_superstep,
                                      mesh_devices, normalize_mesh,
                                      pack_operands, shard_operands,
                                      split_rows)
from repro_torch.gnn.distributed import graph_as_support, pack_graph
from repro_torch.gnn.nai import classify_by_order, support_stationary_factors
from repro_torch.gnn.packing import shard_batch_perm, step_active_blocks
from repro_torch.gnn.store import as_store
from repro_torch.launch.checkpoint import (CheckpointCorruption,
                                           CheckpointError,
                                           CheckpointManager)
from repro_torch.serving.faults import InjectedFault, WatchdogTimeout

EXIT_PREEMPTED = 17


class PreemptionSimulated(RuntimeError):
    """Raised by ``crash_after``: the run stopped itself right after
    committing that superstep's checkpoint — the deterministic stand-in
    for a SIGKILL."""


@dataclasses.dataclass(frozen=True)
class OfflineConfig:
    """Job knobs (the NAI and model configs come separately)."""
    ckpt_dir: str
    spmm_impl: str = "segment"
    gather_mode: str = "alltoall"    # the dense one at one device
    device: str = "cuda"
    resume: bool = True
    watchdog_s: float = 0.0          # 0 = no per-superstep watchdog
    superstep_retries: int = 2
    straggler_factor: float = 4.0
    crash_after: Optional[int] = None
    cls_chunk: int = 8192            # classification rows per dispatch

    def __post_init__(self):
        if not self.ckpt_dir:
            raise ValueError("ckpt_dir is required: the checkpointed "
                             "job has no checkpoint-free mode")
        if self.gather_mode not in GATHER_MODES:
            raise ValueError(f"unknown gather_mode {self.gather_mode!r} "
                             f"(one of {GATHER_MODES})")
        if self.watchdog_s < 0:
            raise ValueError(f"watchdog_s must be >= 0, "
                             f"got {self.watchdog_s}")
        if self.superstep_retries < 0:
            raise ValueError(f"superstep_retries must be >= 0, "
                             f"got {self.superstep_retries}")
        if self.straggler_factor <= 1.0:
            raise ValueError(f"straggler_factor must be > 1, "
                             f"got {self.straggler_factor}")
        if self.cls_chunk < 1:
            raise ValueError(f"cls_chunk must be >= 1, "
                             f"got {self.cls_chunk}")
        if self.crash_after is not None and self.crash_after < 0:
            raise ValueError(f"crash_after must be >= 0, "
                             f"got {self.crash_after}")


@dataclasses.dataclass
class OfflineResult:
    predictions: np.ndarray   # (n,) int32 argmax class ids
    exit_orders: np.ndarray   # (n,) int32 in [t_min, t_max]
    stats: Dict


def first_step_distance_quantile(store, r: float, q: float = 0.5
                                 ) -> float:
    """A data-driven exit threshold: the `q` quantile of the Eq. 8
    distance ||X^(1) - X^inf|| over all nodes, in f32 on the CPU (an
    ordered sum). Deterministic for a given store, so a resumed CLI run
    recomputes the same T_s."""
    store = as_store(store)
    sup = graph_as_support(store, r)
    x0 = np.asarray(store.features, np.float32)
    c64, s64 = support_stationary_factors(store, sup, x0, r)
    x_inf = (c64[:, None] * s64[None, :]).astype(np.float32)
    contrib = torch.from_numpy(sup.coef[:, None] * x0[sup.src])
    x1 = torch.zeros((store.n, x0.shape[1]), dtype=torch.float32)
    x1.index_add_(0, torch.from_numpy(sup.dst).long(), contrib)
    d = np.linalg.norm(x1.numpy() - x_inf, axis=1)
    return float(np.quantile(d, q))


def _resume_chain(mgr: CheckpointManager, stats: Dict):
    """Load the longest verifiable checkpoint chain 0..k (descending from
    the newest committed superstep, falling back one superstep per
    corrupt or unreadable checkpoint). Returns (k, {step: payload}) or
    (None, {}) for a cold start."""
    loaded: Dict[int, Dict[str, np.ndarray]] = {}
    committed = set(mgr.steps())
    bad: set = set()
    for k in sorted(committed, reverse=True):
        if any(b <= k for b in bad):
            continue        # a corrupt ancestor poisons everything above
        ok = True
        for j in range(k + 1):
            if j in loaded:
                continue
            if j not in committed:
                ok = False  # gap in the chain: series not reconstructible
                break
            try:
                loaded[j] = mgr.load_step(j)
            except (CheckpointCorruption, CheckpointError) as e:
                stats["corrupt_steps"] += 1
                stats["fallbacks"].append(
                    {"step": j, "error": f"{type(e).__name__}: {e}"})
                bad.add(j)
                ok = False
                break
        if ok:
            return k, loaded
    return None, {}


def _save(mgr: CheckpointManager, step: int, x, eo, stats: Dict) -> None:
    """Commit superstep `step`'s state; a failed write is tolerated (the
    in-memory state is still good) and recorded."""
    t0 = time.perf_counter()
    try:
        mgr.save_step(step, {"x": x, "exit_order": eo})
    except (InjectedFault, CheckpointError, OSError) as e:
        stats["ckpt_write_failures"] += 1
        stats["fallbacks"].append(
            {"step": step, "error": f"write: {type(e).__name__}: {e}"})
    stats["ckpt_s"] += time.perf_counter() - t0


def _wait(ev, watchdog_s: float) -> bool:
    """Poll the CUDA event `ev` until it fires or `watchdog_s` passes;
    True if it fired. Never blocks on the event itself."""
    deadline = time.monotonic() + watchdog_s
    while not ev.query():
        if time.monotonic() > deadline:
            return False
        time.sleep(1e-4)
    return True


def run_full_graph_infer(store, cfg, classifiers, nai, ocfg: OfflineConfig,
                         *, mesh=None, fault_plan=None) -> OfflineResult:
    """Classify every node of `store` with NAI on ``ocfg.device``, or
    over the shards of `mesh` (whose first device must be
    ``ocfg.device``), checkpointing at superstep granularity. `cfg` /
    `classifiers` are the model config and its trained per-order heads
    (`repro_torch.gnn.models`), `nai` the `NAIConfig`, `ocfg` the job's
    knobs. Returns predictions and exit orders of the n real nodes in
    store order, plus run stats (resume point, fallbacks, straggler and
    watchdog counters, checkpoint overhead)."""
    t_start = time.perf_counter()
    dev = resolve_device(ocfg.device)
    devs = mesh_devices(mesh, dev)
    mesh = normalize_mesh(mesh)
    D = len(devs)
    gather_mode = ocfg.gather_mode if D > 1 else "dense"
    store = as_store(store)
    tmax = nai.t_max
    injector = (fault_plan.injector()
                if fault_plan is not None and not fault_plan.empty
                else None)

    t0 = time.perf_counter()
    be, packed = pack_graph(store, D, cfg.r, ocfg.spmm_impl,
                            halo=gather_mode != "dense", stationary=True)
    sa = (step_active_blocks(packed.hop_rb, tmax)
          if be.uses_tiles else None)
    ops_np = pack_operands(be, packed, sa)
    if be.uses_dense_x_inf:
        ops_np["x_inf"] = packed.x_inf
    pack_s = time.perf_counter() - t0
    nb_pad, n_pad = packed.n_batch, packed.n_pad

    fingerprint = {
        "store": store.name, "n": int(store.n),
        "num_edges": int(store.num_edges),
        "mutation_clock": int(store.mutation_clock),
        "feat_dim": int(store.feat_dim), "shards": D,
        "impl": ocfg.spmm_impl, "gather_mode": gather_mode,
        "r": float(cfg.r), "t_s": float(nai.t_s),
        "t_min": int(nai.t_min), "t_max": int(tmax),
        "nb_pad": int(nb_pad), "n_pad": int(n_pad),
        "f_pad": int(packed.x0.shape[1]),
    }
    mgr = CheckpointManager(ocfg.ckpt_dir, fingerprint=fingerprint,
                            injector=injector)

    stats: Dict = {
        "n": int(store.n), "shards": D, "impl": ocfg.spmm_impl,
        "gather_mode": gather_mode, "t_max": tmax, "device": str(dev),
        "mesh": None if mesh is None else str(mesh),
        "nb_pad": int(nb_pad), "n_pad": int(n_pad),
        "resumed_from": None, "supersteps_run": 0, "corrupt_steps": 0,
        "fallbacks": [], "ckpt_write_failures": 0,
        "watchdog_retries": 0, "stragglers": [],
        "pack_s": pack_s, "compute_s": 0.0, "to_host_s": 0.0,
        "ckpt_s": 0.0, "classify_s": 0.0,
    }

    # ---------------------------------------------------------- resume
    snaps: Dict[int, np.ndarray] = {}   # step -> batch-row state X^(l)
    start = None
    if ocfg.resume:
        start, loaded = _resume_chain(mgr, stats)
        if start is not None:
            for j in range(start + 1):
                snaps[j] = loaded[j]["x"][:nb_pad]
            x_host = loaded[start]["x"]
            eo_host = loaded[start]["exit_order"]
    if start is None:
        x_host = packed.x0
        eo_host = np.zeros(nb_pad, np.int32)
        snaps[0] = x_host[:nb_pad]
        _save(mgr, 0, x_host, eo_host, stats)
        start = 0
    stats["resumed_from"] = int(start)

    # ------------------------------------------------- superstep loop
    step_fn = make_superstep(be, nai, n_batch=nb_pad, n_rows=n_pad,
                             device=dev, mesh=mesh, gather_mode=gather_mode)
    # the operands are placed once (sharded: each shard's on its device)
    # and the state stays on the device(s) between supersteps
    if mesh is None:
        shards = [{k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                   for k, v in ops_np.items()}]
        x_dev = torch.from_numpy(np.ascontiguousarray(x_host)).to(dev)
        eo_dev = torch.from_numpy(np.ascontiguousarray(eo_host)).to(dev)
    else:
        shards = shard_operands(ops_np, devs)
        x_dev = split_rows(np.ascontiguousarray(x_host), devs)
        eo_dev = split_rows(np.ascontiguousarray(eo_host), devs)
    for o in shards:
        for k in ("src", "dst"):
            if k in o:
                o[k] = o[k].long()
    ops_dev = shards[0] if mesh is None else shards
    durations: List[float] = []
    if ocfg.crash_after is not None and ocfg.crash_after <= start:
        raise PreemptionSimulated(
            f"simulated preemption after superstep {start} "
            f"(crash_after={ocfg.crash_after} already committed)")

    for l in range(start + 1, tmax + 1):
        t0 = time.perf_counter()
        for attempt in range(ocfg.superstep_retries + 1):
            last = attempt == ocfg.superstep_retries
            if injector is not None \
                    and injector.fire("superstep_hang") is not None:
                # simulated hung dispatch: the watchdog path declares the
                # attempt dead and retries deterministically
                stats["watchdog_retries"] += 1
                if last:
                    raise WatchdogTimeout(
                        f"superstep {l} hung on every attempt "
                        f"({ocfg.superstep_retries + 1})")
                continue
            x_new, eo_new = step_fn(ops_dev, x_dev, eo_dev, l)
            if dev.type == "cuda":
                evs = []
                for d in dict.fromkeys(devs):
                    ev = torch.cuda.Event()
                    ev.record(torch.cuda.current_stream(d))
                    evs.append(ev)
                if ocfg.watchdog_s > 0 and not all(
                        _wait(ev, ocfg.watchdog_s) for ev in evs):
                    stats["watchdog_retries"] += 1
                    if last:
                        raise WatchdogTimeout(
                            f"superstep {l} exceeded the "
                            f"{ocfg.watchdog_s}s watchdog on every "
                            f"attempt")
                    continue
                for ev in evs:
                    ev.synchronize()
            break
        dur = time.perf_counter() - t0
        if len(durations) >= 2:
            med = statistics.median(durations)
            if dur > ocfg.straggler_factor * med:
                stats["stragglers"].append(
                    {"step": l, "s": round(dur, 6),
                     "median_s": round(med, 6)})
        durations.append(dur)
        stats["compute_s"] += dur
        stats["supersteps_run"] += 1
        x_dev, eo_dev = x_new, eo_new
        t0 = time.perf_counter()
        if mesh is None:
            x_host = x_dev.cpu().numpy()
            eo_host = eo_dev.cpu().numpy()
        else:
            x_host = torch.cat([t.cpu() for t in x_dev]).numpy()
            eo_host = torch.cat([t.cpu() for t in eo_dev]).numpy()
        stats["to_host_s"] += time.perf_counter() - t0
        snaps[l] = x_host[:nb_pad]
        _save(mgr, l, x_host, eo_host, stats)
        if ocfg.crash_after is not None and l >= ocfg.crash_after:
            raise PreemptionSimulated(
                f"simulated preemption after superstep {l}")
    del x_dev, eo_dev, ops_dev

    # -------------------------------------------------- classification
    t0 = time.perf_counter()
    eo_final = np.where(eo_host == 0, tmax, eo_host).astype(np.int32)
    chunk = min(ocfg.cls_chunk, nb_pad)
    preds = np.empty(nb_pad, np.int32)
    with torch.inference_mode():
        for lo in range(0, nb_pad, chunk):
            hi = min(lo + chunk, nb_pad)
            series = torch.from_numpy(
                np.stack([snaps[j][lo:hi] for j in range(tmax + 1)])).to(dev)
            order = torch.from_numpy(eo_final[lo:hi]).to(dev)
            out = classify_by_order(cfg, tmax, classifiers, order, series)
            preds[lo:hi] = out.cpu().numpy()
    if D > 1:
        unperm = shard_batch_perm(nb_pad, D)
        preds = preds[unperm]
        eo_final = eo_final[unperm]
    n = store.n
    predictions = np.ascontiguousarray(preds[:n])
    exit_orders = np.ascontiguousarray(eo_final[:n])
    stats["classify_s"] = time.perf_counter() - t0

    stats["exit_histogram"] = np.bincount(
        exit_orders, minlength=tmax + 1).tolist()
    stats["ckpt_bytes"] = mgr.total_bytes()
    busy = stats["compute_s"] + stats["ckpt_s"]
    stats["ckpt_overhead_frac"] = (stats["ckpt_s"] / busy
                                   if busy > 0 else 0.0)
    stats["node_steps_per_s"] = (n * stats["supersteps_run"]
                                 / stats["compute_s"]
                                 if stats["compute_s"] > 0 else 0.0)
    end_to_end = busy + stats["classify_s"]
    stats["nodes_per_s"] = n / end_to_end if end_to_end > 0 else 0.0
    stats["total_s"] = time.perf_counter() - t_start
    mgr.save_result({"predictions": predictions,
                     "exit_orders": exit_orders})
    if injector is not None:
        stats["injected"] = injector.summary()
    return OfflineResult(predictions=predictions,
                         exit_orders=exit_orders, stats=stats)


# ----------------------------------------------------------------- CLI
def _main(argv=None) -> int:
    import argparse

    from repro_torch.gnn.models import GNNConfig, init_classifiers
    from repro_torch.gnn.nai import NAIConfig
    from repro_torch.gnn.store import MmapStore

    from repro_torch.launch.mesh import make_serving_mesh

    ap = argparse.ArgumentParser(
        description="Offline checkpointed full-graph NAI inference over an "
                    "on-disk GraphStore, on one device or D shards. Rerun "
                    "the same command after a crash or preemption to "
                    "resume from the last complete superstep.")
    ap.add_argument("--store", required=True, help="MmapStore directory")
    ap.add_argument("--ckpt", required=True, help="checkpoint directory")
    ap.add_argument("--shards", type=int, default=1,
                    help="row shards: the first D GPUs, or D shards on "
                         "the CPU with --device cpu")
    ap.add_argument("--gather", default="alltoall", choices=GATHER_MODES,
                    help="frontier exchange between shards")
    ap.add_argument("--impl", default="segment",
                    choices=("segment", "block_ell", "fused"))
    ap.add_argument("--t-max", type=int, default=3)
    ap.add_argument("--t-min", type=int, default=1)
    ap.add_argument("--t-s", type=float, default=None)
    ap.add_argument("--t-s-quantile", type=float, default=None,
                    help="derive T_s from this quantile of the first-step "
                         "exit distance (deterministic, so resumed runs "
                         "agree)")
    ap.add_argument("--r", type=float, default=0.5)
    ap.add_argument("--hidden", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0,
                    help="classifier init seed (resume recomputes the "
                         "same heads)")
    ap.add_argument("--crash-after", type=int, default=None,
                    help=f"simulate preemption right after committing "
                         f"this superstep (exit code {EXIT_PREEMPTED})")
    ap.add_argument("--no-resume", action="store_true",
                    help="ignore existing checkpoints (fresh run)")
    ap.add_argument("--watchdog-s", type=float, default=0.0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; pass cpu to run on "
                         "the CPU)")
    ap.add_argument("--out-json", default="",
                    help="also write the run summary JSON here")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    store = MmapStore(args.store)
    if args.t_s is None:
        q = 0.5 if args.t_s_quantile is None else args.t_s_quantile
        t_s = first_step_distance_quantile(store, args.r, q)
    else:
        t_s = args.t_s
    cfg = GNNConfig("sgc", store.feat_dim, store.num_classes,
                    k=args.t_max, r=args.r, hidden=args.hidden,
                    mlp_layers=2)
    classifiers = init_classifiers(
        cfg, torch.Generator().manual_seed(args.seed), device=dev)
    nai = NAIConfig(t_s=t_s, t_min=args.t_min, t_max=args.t_max)
    mesh = None
    if args.shards > 1:
        mesh = (make_serving_mesh(args.shards, devices=[dev] * args.shards)
                if dev.type == "cpu" else make_serving_mesh(args.shards))
        dev = mesh.devices[0]
    ocfg = OfflineConfig(ckpt_dir=args.ckpt, spmm_impl=args.impl,
                         gather_mode=args.gather, device=str(dev),
                         resume=not args.no_resume,
                         watchdog_s=args.watchdog_s,
                         crash_after=args.crash_after)
    try:
        res = run_full_graph_infer(store, cfg, classifiers, nai, ocfg,
                                   mesh=mesh)
    except PreemptionSimulated as e:
        print(f"PREEMPTED: {e}", flush=True)
        return EXIT_PREEMPTED
    finally:
        store.close()
    summary = {"t_s": t_s, **res.stats}
    line = json.dumps(summary, sort_keys=True)
    print(f"OFFLINE_SUMMARY {line}", flush=True)
    if args.out_json:
        with open(args.out_json, "w") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(_main())
