"""Batched NAI serving engine (the port of `repro.serving.engine`).

Requests (node ids) arrive on a queue; the batch former (`form_batch`)
closes a batch on size OR age — a full `batch_size` immediately, a partial
batch once its oldest request has waited `max_wait_s` — and each batch
runs Algorithm 1. `step()` is the closed-loop path (serve whatever is
queued now), `poll(now)` the open-loop path (respects the former's
triggers and advances the pipeline without blocking). Latency percentiles
and the exit-order histogram are tracked per engine.

Two serving modes:

* ``mode="host"`` — the numpy path (`infer_batch_host`), real frontier
  shrinking; only the classifier heads run on the device.
* ``mode="compiled"`` — the device path, an explicit two-stage pipeline:

  - **host stage** (`_host_stage`): support sampling -> bucket-padded
    block-ELL packing into a rotating pool of buffer sets
    (`pack_support(out=...)`), so the steady state allocates no fresh
    bucket-sized arrays (`pack_stats`). On CUDA every pooled buffer is
    page-locked (pinned) once, when the set is allocated; packing then
    writes straight into pinned memory. A CUDA engine without the cache
    and without a mesh samples on the card (`DeviceSampler`, on its own
    stream, array-equal to the numpy sampler); with the cache (which
    probes each hop on the host), on a mesh, or on the CPU it samples with
    the numpy `sample_support`. `sample_stats` counts the batches each
    path sampled (``device`` / ``host``). With the device sampler, a
    backend that reads the edge list and no tiles (``segment``) and the
    store's feature tables on the card (`DeviceSampler.feature_tables`:
    they fit), the support never leaves the card: the operands are built
    there (`pack_support_device`, the host packer's bucket rules) into a
    pool of ``pipeline_depth + 1`` device sets per batch bucket, on the
    compute stream, so a set is refilled only after the batch that read
    it; `_device_stage` takes them as they are. `pack_place` counts the
    batches whose operands were built on the card and on the host
    (``device`` / ``host``).
  - **device stage** (`_device_stage`): asynchronous host-to-device copies
    of the operands from the pinned buffers on a copy stream of each
    device (one `torch.cuda.Stream` a distinct device), which the compute
    stream waits on through an event recorded after them, so that batch
    N+1's copies run beside batch N's kernels (the reference's
    `jax.device_put` returns at once and the runtime moves the bytes
    beside the running program); each device tensor made there is
    recorded on the compute stream (`record_stream`), so that the
    caching allocator does not hand its block out again under a running
    kernel. Then the kernels of the masked NAP loop plus per-order
    classification (`make_compiled_infer`), and an asynchronous copy of
    the (nb,) predictions and exit orders back into pinned host memory on
    the compute stream, followed by a CUDA event. Nothing in it waits
    for the card. The one operand that packing does not write into the
    pool (`step_active`, the tile backends' per-step row-block
    predicate) is staged through a pinned buffer of the slot, so no copy
    reads pageable memory.

  With ``pipeline_depth=1`` the stages run back to back per batch. With
  ``pipeline_depth=2`` one batch stays in flight: batch N+1's sampling and
  packing overlap batch N's device work, and N's results are read (its
  event waited on) only once N+1 has been submitted. Completion stays
  FIFO, so predictions and exit orders equal serial serving's. The pool
  rotates ``pipeline_depth + 1`` buffer sets per batch bucket, and before
  a set is refilled the host waits on the event recorded after its last
  copies, so packing never overwrites bytes still being copied.

Spans: a compiled-mode batch's host stage is ``serve.host`` and its
device stage ``serve.dispatch``, `torch.profiler` ranges while a profiler
records (`profiled`), so they share its clock with the device events.
The host stage's parts ``serve.host.sample``, ``.gather``, ``.factors``
and ``.pack`` (`_span`) also put their seconds into the batch's
`batch_timings` entry (``sample_s``, ``gather_s``, ``factors_s``,
``pack_s``) beside ``host_s``, ``dispatch_s`` and ``sync_s``.

Compiled-mode `spmm_impl` names a registered `PropagationBackend`
(`repro_torch.gnn.backends`): ``segment``, ``block_ell`` or ``fused``.

`jit_stats` (``{"compiles", "hits"}``) and `jit_cache_size()` keep the
reference's names: they count the distinct operand-shape keys
(`PackedSupport.shape_key`) that the runner was dispatched with, the
programs that a compiler or a CUDA-graph capture would key on (the eager
port compiles nothing: a "compile" is a key seen for the first time).
With the bucket high-water marks the steady state adds none.

``cache_nodes > 0`` turns on the propagated-feature cache
(`repro_torch.gnn.propcache`): the sampler probes it, the packer drops
the edges into hit rows and packs their stored series as seed operands
(pooled and pinned like the rest), and the NAP loop writes them over the
hit rows after every step. The batch rows' series is copied back with the
results, and once the batch has passed its guard the cache is filled from
it (``cache_fill``). Cached and cold serving give equal predictions and
exit orders outside the threshold margin (a seeded value was summed in
its fill batch's order), also across mutations of the store.

Failure-domain isolation (`repro_torch.serving.faults`; all off by
default): a failure in a batch's host stage, device dispatch or sync, or
a guard trip on its results, fails that batch only. ``faults=`` is a
seeded `FaultPlan` consulted once per batch at the ``slow``/``host``
(host stage), ``device`` (dispatch), ``nan`` and ``hang`` (after
dispatch, `poison_results`) points; ``watchdog_s`` bounds each batch's
sync: the engine polls the batch's CUDA event with ``query()`` until
``watchdog_s`` after its dispatch and then declares it hung
(`WatchdogTimeout`) without blocking on it; ``retry_failed`` gives a
failed batch one attempt on the host path (`infer_batch_host`). Requests
carry an absolute deadline and an SLO class tag, stamped by the
front-end (`repro_torch.serving.frontend`); the engine itself is
deadline-agnostic.

Sharded serving (``mesh=``, a mesh with a ``data`` axis of D > 1 devices,
`repro_torch.launch.mesh.make_serving_mesh`; compiled mode only): the
packer lays each batch out in D shard-major row blocks
(``pack_support(n_shards=D)``, with the halo frame unless ``gather_mode``
is ``dense``), the pool pins the whole buffer set, and `_device_stage`
copies each shard's slice to its device (`shard_operands`). Every shard
runs the kernels on its own tiles and the frontier it gathers each step
(``gather_mode``: ``dense``, ``halo`` or ``alltoall``, see
`repro_torch.gnn.backends`), classifies its own batch rows, and the
results are gathered and un-permuted on the mesh's first device, so
predictions and exit orders equal single-device serving's. One process
drives every shard. `halo_stats` records the exchange's footprint; the
cache is partitioned by shard (`PropCache(n_shards=D)`). A one-device
mesh serves the plain path.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import profiled
from repro_torch.gnn.backends import (BACKENDS, GATHER_MODES,
                                      exchange_bytes_per_step, get_backend,
                                      mesh_devices, normalize_mesh,
                                      pack_operands, shard_operands)
from repro_torch.gnn.device_packing import pack_support_device
from repro_torch.gnn.device_sampler import DeviceSampler
from repro_torch.gnn.models import Classifiers, GNNConfig
from repro_torch.gnn.nai import (NAIConfig, infer_batch_host,
                                 make_compiled_infer,
                                 support_stationary_factors)
from repro_torch.gnn.packing import (CB, PackedSupport, batch_bucket,
                                     pack_support, step_active_blocks)
from repro_torch.gnn.propcache import PropCache
from repro_torch.gnn.sampler import sample_support
from repro_torch.gnn.store import as_store
from repro_torch.serving.faults import (InjectedFault, NaNGuardError,
                                        WatchdogTimeout, poison_results)


@contextlib.contextmanager
def _span(name: str, rec: Dict, key: str):
    """One named part of the host stage of the batch being served: a
    profiler range (`profiled`) and its seconds, added to the batch's
    record `rec` under `key`."""
    t0 = time.perf_counter()
    with profiled(name):
        yield
    rec[key] = rec.get(key, 0.0) + time.perf_counter() - t0


def _tensors(tree):
    """The tensors of nested dicts, lists and tuples."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Validated serving-engine configuration."""
    mode: str = "host"               # "host" (numpy) | "compiled"
    spmm_impl: str = "block_ell"     # registered PropagationBackend name
    gather_mode: str = "halo"        # sharded frontier exchange
    pipeline_depth: int = 1          # 1 = serial, 2 = one batch in flight
    max_wait_s: float = 0.01         # batch former age bound
    latency_window: int = 4096       # LatencyRing capacity
    nan_guard: bool = True           # finite/range check on synced results
    mesh: object = None              # DeviceMesh with a "data" axis, or None
    # --- propagated-feature cache (repro_torch.gnn.propcache; 0 = off) ---
    cache_nodes: int = 0             # LRU capacity in cached nodes
    cache_fill: bool = True          # insert batch-row series after serving
    # --- failure-domain isolation (all default off / no-op) ---
    faults: object = None            # FaultPlan schedule, or None
    watchdog_s: Optional[float] = None   # device-sync deadline, None = off
    retry_failed: bool = False       # retry a failed batch once (host path)

    def __post_init__(self):
        if self.mode not in ("host", "compiled"):
            raise ValueError(f"unknown mode {self.mode!r}")
        if self.spmm_impl not in BACKENDS:
            raise ValueError(f"unknown spmm_impl {self.spmm_impl!r} "
                             f"(one of {sorted(BACKENDS)})")
        if self.gather_mode not in GATHER_MODES:
            raise ValueError(f"unknown gather_mode {self.gather_mode!r} "
                             f"(one of {GATHER_MODES})")
        if self.pipeline_depth < 1:
            raise ValueError(f"pipeline_depth must be >= 1, got "
                             f"{self.pipeline_depth}")
        if self.pipeline_depth > 1 and self.mode != "compiled":
            raise ValueError("pipelining overlaps host pack with device "
                             "compute; mode='host' has no device stage")
        if self.mesh is not None and self.mode != "compiled":
            raise ValueError("sharded serving (mesh=) requires "
                             "mode='compiled'")
        if self.cache_nodes < 0:
            raise ValueError(f"cache_nodes must be >= 0, got "
                             f"{self.cache_nodes}")
        if self.cache_nodes and self.mode != "compiled":
            raise ValueError("the propagated-feature cache fills from the "
                             "compiled runner's series output; mode='host' "
                             "has none")
        if self.max_wait_s < 0:
            raise ValueError(f"max_wait_s must be >= 0, got "
                             f"{self.max_wait_s}")
        if self.latency_window < 1:
            raise ValueError(f"latency_window must be >= 1, got "
                             f"{self.latency_window}")
        if self.watchdog_s is not None and self.watchdog_s <= 0:
            raise ValueError(f"watchdog_s must be > 0 (or None to "
                             f"disable), got {self.watchdog_s}")
        if self.faults is not None and not callable(
                getattr(self.faults, "injector", None)):
            raise ValueError("faults must be a FaultPlan "
                             "(repro_torch.serving.faults) or None")


@dataclasses.dataclass
class Request:
    node_id: int
    arrival_s: float
    deadline_s: float = float("inf")   # ABSOLUTE completion deadline
    slo_class: str = ""                # routing tier (serving front-end)
    done_s: float = -1.0
    prediction: int = -1
    exit_order: int = -1
    batch_id: int = -1                 # engine batch this completed in
    # terminal lifecycle: every accepted request ends EXACTLY once as
    # "completed" or "failed" (shedding happens before acceptance, at the
    # front-end)
    status: str = "pending"            # "pending" | "completed" | "failed"
    error: str = ""                    # typed failure cause when failed
    retried: bool = False              # recovered on the host path
    degraded: bool = False             # demoted by an open circuit breaker
    probe: bool = False                # half-open breaker probe request

    @property
    def within_deadline(self) -> bool:
        """Completed in time (the goodput numerator); False while the
        request is pending."""
        return 0.0 <= self.done_s <= self.deadline_s


class LatencyRing:
    """Fixed-capacity ring of the most recent request latencies: bounded
    memory for long-running engines, exact percentiles for runs shorter
    than `capacity`."""

    def __init__(self, capacity: int = 4096):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._buf = np.zeros(capacity, np.float64)
        self.total_appended = 0

    def append(self, value: float) -> None:
        self._buf[self.total_appended % self.capacity] = value
        self.total_appended += 1

    def __len__(self) -> int:
        return min(self.total_appended, self.capacity)

    def values(self) -> np.ndarray:
        return self._buf[:len(self)].copy()


@dataclasses.dataclass
class EngineStats:
    served: int = 0
    batches: int = 0
    failed: int = 0        # requests that ended status="failed"
    retried: int = 0       # requests recovered on the host path
    latencies: LatencyRing = dataclasses.field(default_factory=LatencyRing)
    exit_hist: Dict[int, int] = dataclasses.field(default_factory=dict)

    def percentile(self, q: float) -> float:
        vals = self.latencies.values()
        return float(np.percentile(vals, q)) if len(vals) else 0.0

    def summary(self) -> Dict[str, float]:
        return {
            "served": self.served,
            "batches": self.batches,
            "failed": self.failed,
            "retried": self.retried,
            "p50_ms": 1e3 * self.percentile(50),
            "p95_ms": 1e3 * self.percentile(95),
            "p99_ms": 1e3 * self.percentile(99),
            "mean_exit_order": (
                sum(k * v for k, v in self.exit_hist.items())
                / max(self.served, 1)),
        }


@dataclasses.dataclass
class _Inflight:
    """One submitted batch whose results have not been read."""
    requests: List[Request]
    inv: np.ndarray          # dedupe inverse map (batch -> unique row)
    nb_real: int             # unique node count (real rows of the result)
    preds: torch.Tensor      # host tensors, filled when `done` fires
    orders: torch.Tensor
    done: object             # CUDA event; None: results already on the host
    host_s: float            # sample + pack wall time
    dispatch_s: float        # copy + launch wall time
    t_submit: float = 0.0    # wall clock at dispatch (watchdog anchor)
    series: Optional[torch.Tensor] = None   # (T_max, nb, f) steps 1..T_max
    fill: object = None      # cache fill record (nodes, deps, gv) or None
    stages: Dict = dataclasses.field(default_factory=dict)  # _span seconds


# PackedSupport fields that travel to the device
_UPLOADED = ("tiles", "tile_col", "valid", "src", "dst", "coef", "c_inf",
             "s_inf", "x0", "x_inf", "seed_rows", "seed_vals",
             "halo_src_shard", "halo_src_block", "halo_send_block",
             "halo_frame_src")


class NAIServingEngine:
    def __init__(self, cfg: GNNConfig, nai: NAIConfig,
                 classifiers: Classifiers, graph, *, device=None,
                 config: Optional[EngineConfig] = None, **kwargs):
        """`graph` is a `GraphStore` (or a raw `Graph`, wrapped via
        `as_store`); `classifiers` the per-order heads, moved to `device`
        (default ``"cuda"``; with a mesh, the mesh's first device, where
        results are gathered). Engine options come either as one
        ``config=EngineConfig(...)`` or as keyword arguments (``mode=``,
        ``spmm_impl=``, ...), never both."""
        if config is not None and kwargs:
            raise ValueError(
                f"pass either config=EngineConfig(...) or engine kwargs, "
                f"not both (got kwargs {sorted(kwargs)})")
        ec = config if config is not None else EngineConfig(**kwargs)
        # a one-device mesh serves the plain path
        self.mesh = normalize_mesh(ec.mesh)
        self.devices = mesh_devices(ec.mesh, device)
        self.device = self.devices[0]
        self.n_shards = len(self.devices)
        # the frontier exchange only exists across shards
        self.gather_mode = ec.gather_mode if self.n_shards > 1 else "dense"
        # per-step exchange footprint of the widest batch seen (sharded
        # engines): rows each shard's step reads, true halo rows, padded
        # support rows, their ratio, and the f32 bytes that cross between
        # shards per step
        self.halo_stats: Dict[str, float] = {
            "gather_rows_per_step": 0, "halo_rows": 0, "s_pad": 0,
            "halo_frac": 0.0, "exchange_bytes_per_step": 0}
        if self.device.type == "cuda":
            # the classifier matmuls run on the card: keep them IEEE f32
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.config = ec
        self.cfg = cfg
        self.nai = nai
        self.classifiers = classifiers.to(self.device).eval()
        self.store = as_store(graph)
        self.max_wait_s = ec.max_wait_s
        self.mode = ec.mode
        self.spmm_impl = ec.spmm_impl
        self.pipeline_depth = ec.pipeline_depth
        # failure-domain isolation knobs (EngineConfig, all off by default)
        self.nan_guard = ec.nan_guard
        self.watchdog_s = ec.watchdog_s
        self.retry_failed = ec.retry_failed
        self._faults = (ec.faults.injector()
                        if ec.faults is not None else None)
        self.queue: Deque[Request] = deque()
        self.stats = EngineStats(latencies=LatencyRing(ec.latency_window))
        # sharded: partitioned so each shard's cache holds rows its shard
        # owns (see PropCache.n_shards)
        self.cache: Optional[PropCache] = (
            PropCache(ec.cache_nodes, nai.t_max, n_shards=self.n_shards)
            if ec.cache_nodes else None)
        self.cache_fill = ec.cache_fill
        # support rows sampled vs rows propagated (the cache's saving)
        self.row_stats: Dict[str, int] = {"rows_support": 0,
                                          "rows_packed": 0}
        # batches sampled on the card (DeviceSampler) and on the host
        self.sample_stats: Dict[str, int] = {"device": 0, "host": 0}
        # batches whose operands were built on the card and on the host
        self.pack_place: Dict[str, int] = {"device": 0, "host": 0}
        self.pack_stats: Dict[str, int] = {"allocs": 0, "reuses": 0}
        # distinct operand-shape keys dispatched (the reference's jit
        # cache): a new key counts as a compile, a seen one as a hit
        self.jit_stats: Dict[str, int] = {"compiles": 0, "hits": 0}
        self._seen_keys: set = set()
        # per-batch stage breakdown (host/dispatch/sync seconds and the
        # host stage's parts, `_span`), bounded
        self.batch_timings: Deque[Dict[str, float]] = deque(maxlen=1024)
        # bucket high-water marks keyed by padded batch size
        # -> (s_bucket, tb_bucket, e_bucket, h_bucket, hb_bucket, k_bucket)
        self._bucket_hwm: Dict[int, Tuple[int, ...]] = {}
        self._inflight: Deque[_Inflight] = deque()
        # rotating pack-buffer pool: bucket -> pipeline_depth + 1 slots,
        # with the pinned host tensors behind each slot's arrays and the
        # events (one per device) recorded after the slot's last
        # host-to-device copies
        self._pack_pool: Dict[int, List[Optional[PackedSupport]]] = {}
        self._pool_idx: Dict[int, int] = {}
        self._pinned: Dict[Tuple[int, int], Dict[str, torch.Tensor]] = {}
        self._copied: Dict[Tuple[int, int], List[torch.cuda.Event]] = {}
        # pinned staging of the operands packing does not pool, per slot
        self._staged: Dict[Tuple[Tuple[int, int], str], torch.Tensor] = {}
        # device-built operand sets: bucket -> pipeline_depth + 1 sets,
        # oldest first
        self._device_pool: Dict[int, Deque[Optional[PackedSupport]]] = {}
        # the host-to-device copies' stream, one per distinct device
        self._copy_streams = ({d: torch.cuda.Stream(d)
                               for d in dict.fromkeys(self.devices)}
                              if self.device.type == "cuda" else {})
        self._backend = None
        self._runner = None
        # the cache probes each hop on the host and a mesh packs shard by
        # shard: both keep the numpy sampler
        self._device_sampler = (
            DeviceSampler(self.store, cfg.r, self.device)
            if (ec.mode == "compiled" and self.device.type == "cuda"
                and self.cache is None and self.mesh is None) else None)
        if ec.mode == "compiled":
            self._backend = get_backend(ec.spmm_impl)
            self._runner = make_compiled_infer(
                cfg, nai, spmm_impl=ec.spmm_impl, device=self.device,
                mesh=self.mesh, gather_mode=self.gather_mode,
                return_series=self.cache is not None)

    def jit_cache_size(self) -> int:
        """Distinct operand-shape keys the compiled runner was dispatched
        with (0 in host mode)."""
        return len(self._seen_keys)

    @property
    def fault_stats(self) -> Optional[Dict]:
        """Per-stage injected-fault tallies (None without a FaultPlan)."""
        return self._faults.summary() if self._faults is not None else None

    @property
    def cache_stats(self) -> Dict[str, float]:
        """The cache's counters (hits/misses/stale/fills/evictions/
        hit_rate) with the row accounting; with the cache off only the
        row counters (and rows_packed == rows_support)."""
        d: Dict[str, float] = dict(self.row_stats)
        if self.cache is not None:
            d.update(self.cache.stats())
        return d

    def reset_stats(self) -> None:
        """Zero the request counters, timings, row, sampler and pack-place
        accounting and the cache's counters; serving state (cache
        contents, pools, high-water marks, pack and shape-key counters)
        survives."""
        self.stats = EngineStats(
            latencies=LatencyRing(self.config.latency_window))
        self.batch_timings.clear()
        self.row_stats = {"rows_support": 0, "rows_packed": 0}
        self.sample_stats = {"device": 0, "host": 0}
        self.pack_place = {"device": 0, "host": 0}
        if self.cache is not None:
            self.cache.reset_stats()

    def close(self) -> None:
        """Complete in-flight work, then release the store's OS resources
        (the file descriptor and maps of an `MmapStore`). Idempotent."""
        self.flush()
        self.store.close()

    # ------------------------------------------------------- host stage
    def _pin(self, packed: PackedSupport) -> Dict[str, torch.Tensor]:
        """Move a freshly allocated buffer set into page-locked memory:
        each uploaded array is replaced by a numpy view of a pinned
        tensor, so later in-place refills land in pinned memory too."""
        pinned = {}
        for name in _UPLOADED:
            arr = getattr(packed, name)
            if arr is None or arr.size == 0:
                continue
            t = torch.from_numpy(arr).pin_memory()
            setattr(packed, name, t.numpy())
            pinned[name] = t
        return pinned

    def _host_stage(self, nodes: np.ndarray, rec: Dict):
        """Sample the support and pack it into a pooled buffer set, plus
        the static per-step row-block predicate for the tile backends.
        `nodes` must be duplicate-free; `rec` takes the seconds of the
        stage's parts (`_span`). Returns (packed, step_active, slot,
        fill): `fill` is the cache's fill record (batch nodes, support
        nodes, mutation clock at sample time), or None. With the device
        sampler, a backend that reads the edge list and no tiles, and the
        store's feature tables on the device, the support stays there and
        the operands are built there (`pack_support_device`; slot None)."""
        store, cfg, nai = self.store, self.cfg, self.nai
        be = self._backend
        sampler = self._device_sampler
        with _span("serve.host.sample", rec, "sample_s"):
            tables = (sampler.feature_tables()
                      if sampler is not None and be.uses_edges
                      and not be.uses_tiles else None)
            if tables is not None:
                sup = sampler.sample_device(nodes, nai.t_max)
            elif sampler is not None:
                sup = sampler.sample(nodes, nai.t_max)
            else:
                sup = sample_support(store, nodes, nai.t_max, cfg.r,
                                     cache=self.cache)
            self.sample_stats["host" if sampler is None else "device"] += 1
        self.row_stats["rows_support"] += len(sup)
        if tables is not None:
            self.row_stats["rows_packed"] += len(sup)
            nb_bucket = batch_bucket(sup.n_batch)
            hwm = self._bucket_hwm.get(nb_bucket, (0,) * 6)
            ring = self._device_pool.setdefault(
                nb_bucket, deque([None] * (self.pipeline_depth + 1)))
            packed = pack_support_device(
                sup, tables, nb_bucket=nb_bucket, s_bucket=hwm[0],
                e_bucket=hwm[2], out=ring.popleft(),
                part=lambda k: _span(f"serve.host.{k}", rec, f"{k}_s"))
            ring.append(packed)
            with _span("serve.host.pack", rec, "pack_s"):
                self._note_pack(packed, nb_bucket, hwm)
            self.pack_place["device"] += 1
            return packed, None, None, None
        nb = sup.n_batch
        n_hit = int(sup.hit.sum()) if sup.hit is not None else 0
        self.row_stats["rows_packed"] += len(sup) - n_hit
        with _span("serve.host.gather", rec, "gather_s"):
            x0 = store.gather_features(sup.nodes).astype(np.float32,
                                                         copy=False)
        # the dense x_inf is built from the f32 factors, so the fused
        # kernel (which multiplies the factors in f32) sees the same
        # stationary state bit for bit; the fused path never builds it
        with _span("serve.host.factors", rec, "factors_s"):
            c_inf, s_inf = support_stationary_factors(store, sup, x0, cfg.r)
            c_inf = c_inf.astype(np.float32)
            s_inf = s_inf.astype(np.float32)
            if be.uses_dense_x_inf:
                x_inf = c_inf[:, None] * s_inf[None, :]
            else:
                x_inf = np.zeros((nb, 0), np.float32)

        nb_bucket = batch_bucket(nb, self.n_shards)
        hwm = self._bucket_hwm.get(nb_bucket, (0,) * 6)
        slots = self._pack_pool.setdefault(
            nb_bucket, [None] * (self.pipeline_depth + 1))
        idx = self._pool_idx.get(nb_bucket, 0)
        slot = (nb_bucket, idx)
        for ev in self._copied.pop(slot, ()):
            ev.synchronize()   # the slot's last copies have finished
        with _span("serve.host.pack", rec, "pack_s"):
            packed = pack_support(sup, x0, x_inf, nb_bucket=nb_bucket,
                                  s_bucket=hwm[0], tb_bucket=hwm[1],
                                  e_bucket=hwm[2],
                                  build_tiles=be.uses_tiles,
                                  build_edges=be.uses_edges,
                                  x_inf_factors=(c_inf, s_inf)
                                  if be.uses_factors else None,
                                  out=slots[idx], n_shards=self.n_shards,
                                  halo=self.gather_mode != "dense",
                                  h_bucket=hwm[3], hb_bucket=hwm[4],
                                  seeds=(sup.hit, sup.seed_vals)
                                  if self.cache is not None else None,
                                  k_bucket=hwm[5])
            slots[idx] = packed
            self._pool_idx[nb_bucket] = (idx + 1) % len(slots)
            if self.device.type == "cuda" and not packed.reused:
                self._pinned[slot] = self._pin(packed)
            self._note_pack(packed, nb_bucket, hwm)
            if self.mesh is not None:
                self._record_halo(packed)
            step_active = (step_active_blocks(packed.hop_rb, nai.t_max)
                           if be.uses_tiles else None)
        fill = None
        if self.cache is not None and self.cache_fill:
            # the whole support is the conservative dependency cone of
            # every batch row's series (see PropCache.fill)
            fill = (nodes, sup.nodes, sup.graph_version)
        self.pack_place["host"] += 1
        return packed, step_active, slot, fill

    def _note_pack(self, packed: PackedSupport, nb_bucket: int,
                   hwm: Tuple[int, ...]) -> None:
        """Count a pack (a pooled set allocated or reused, its shape key
        new or seen) and raise the bucket's high-water marks to it."""
        self.pack_stats["reuses" if packed.reused else "allocs"] += 1
        self._bucket_hwm[nb_bucket] = (
            max(hwm[0], packed.n_pad),
            max(hwm[1], packed.tiles.shape[1]),
            max(hwm[2], packed.src.shape[-1]),
            max(hwm[3], packed.n_halo_pad),
            max(hwm[4], packed.halo_send_pad),
            max(hwm[5], packed.seed_pad))
        key = packed.shape_key(self.spmm_impl)
        if key in self._seen_keys:
            self.jit_stats["hits"] += 1
        else:
            self._seen_keys.add(key)
            self.jit_stats["compiles"] += 1

    def _record_halo(self, packed: PackedSupport) -> None:
        """Fold one sharded pack into `halo_stats` (structural: the rows
        each shard's step reads against the true boundary and the dense
        S_pad, and the bytes the mode moves between shards per step)."""
        halo_on = packed.halo_src_shard is not None
        hs = self.halo_stats
        for k, v in (
                ("gather_rows_per_step",
                 packed.n_halo_pad * CB if halo_on else packed.n_pad),
                ("halo_rows", packed.halo_rows if halo_on else packed.n_pad),
                ("s_pad", packed.n_pad),
                ("halo_frac", packed.halo_frac if halo_on else 1.0),
                ("exchange_bytes_per_step", exchange_bytes_per_step(
                    self.gather_mode, self.n_shards, packed.n_pad,
                    packed.x0.shape[1], packed.halo_send_pad))):
            hs[k] = max(hs[k], v)

    # ----------------------------------------------------- device stage
    def _device_stage(self, packed: PackedSupport,
                      step_active: Optional[np.ndarray], slot):
        """Copy the operands to the device (sharded: each shard's slice to
        its device), launch the masked NAP loop and the classifiers, and
        start copying the results back. Returns (preds, orders, series,
        done) without waiting for the card: host tensors valid once the
        CUDA event `done` has fired (None on the CPU, where they are ready
        on return); `series` is the batch rows' steps 1..T_max with the
        cache on, else None. Operands built on the device (slot None) are
        taken as they are."""
        dev = self.device
        if slot is None:
            on_dev = pack_operands(self._backend, packed, step_active)
            x0, x_inf = packed.x0, packed.x_inf
        else:
            on_dev, x0, x_inf = self._upload(packed, step_active, slot)
        out = self._runner(self.classifiers, on_dev, x0, x_inf)
        if self.cache is not None:
            out = (*out[:2], out[2][1:])
        else:
            out = (*out, None)
        if dev.type != "cuda":
            return (*out, None)
        host = []
        for t in out:
            if t is not None:
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                t = h
            host.append(t)
        done = torch.cuda.Event()
        done.record()
        return (*host, done)

    def _upload(self, packed: PackedSupport,
                step_active: Optional[np.ndarray], slot):
        """The host-built operands on the device (sharded: each shard's
        slice on its device), copied on the copy streams, which the
        compute streams wait on. Returns (operands, x0, x_inf)."""
        dev = self.device
        arrays = pack_operands(self._backend, packed, step_active)
        arrays.update(x0=packed.x0, x_inf=packed.x_inf)
        pinned = self._pinned.get(slot, {})
        host = {name: pinned[name] if name in pinned
                else self._stage(slot, name, arr)
                for name, arr in arrays.items()}
        with contextlib.ExitStack() as copying:
            for s in self._copy_streams.values():
                copying.enter_context(torch.cuda.stream(s))
            if self.mesh is None:
                on_dev = {name: t.to(dev, non_blocking=True)
                          for name, t in host.items()}
                x0, x_inf = on_dev.pop("x0"), on_dev.pop("x_inf")
            else:
                on_dev = shard_operands(host, self.devices,
                                        non_blocking=True)
                x0 = [o.pop("x0") for o in on_dev]
                x_inf = [o.pop("x_inf") for o in on_dev]
        if dev.type == "cuda":
            # one event per device, recorded on its copy stream after the
            # copies: the compute stream waits on it, and the next pack
            # into this slot waits for every copy out of its buffers
            copied = []
            for d, s in self._copy_streams.items():
                ev = torch.cuda.Event()
                ev.record(s)
                torch.cuda.current_stream(d).wait_event(ev)
                copied.append(ev)
            self._copied[slot] = copied
            for t in _tensors((on_dev, x0, x_inf)):
                t.record_stream(torch.cuda.current_stream(t.device))
        return on_dev, x0, x_inf

    def _stage(self, slot, name: str, arr: np.ndarray) -> torch.Tensor:
        """An operand that packing does not write into the pool, as a
        tensor: on the card copied into the slot's pinned staging buffer
        for `name` (made once per slot and shape; the slot's copies have
        finished before it is refilled), so that its copy to the device
        does not read pageable memory; on the CPU `arr` itself."""
        t = torch.from_numpy(arr)
        if self.device.type != "cuda" or t.numel() == 0:
            return t
        buf = self._staged.get((slot, name))
        if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._staged[(slot, name)] = buf
        buf.copy_(t)
        return buf

    def _watchdog_sync(self, fl: _Inflight) -> None:
        """Bound the device sync: poll the batch's CUDA event with
        ``query()`` until it has fired or `watchdog_s` has passed since
        dispatch, then raise `WatchdogTimeout` — the batch is declared hung
        and failed, and the pipeline moves on (its pool slot stays guarded
        by the event recorded after its copies). Never waits on the event
        itself. With the watchdog off (None), or with no event (the CPU:
        results are ready), it returns at once."""
        wd, ev = self.watchdog_s, fl.done
        if wd is None or ev is None:
            return
        deadline = fl.t_submit + wd
        while not ev.query():
            if time.perf_counter() >= deadline:
                raise WatchdogTimeout(
                    f"device sync not ready {wd * 1e3:.0f} ms after "
                    f"dispatch; batch of {len(fl.requests)} declared hung")
            time.sleep(1e-4)

    def _guard_results(self, preds: np.ndarray, orders: np.ndarray,
                       nb_real: int) -> None:
        """Fail the batch if the device returned garbage: non-finite values
        (a float result holding NaN or Inf, as a poisoned batch's) or
        out-of-range class ids or exit orders. Guards values only — a
        passing batch's results are untouched."""
        if not self.nan_guard:
            return
        p, o = preds[:nb_real], orders[:nb_real]
        for what, a in (("predictions", p), ("exit orders", o)):
            if a.dtype.kind == "f" and not np.all(np.isfinite(a)):
                raise NaNGuardError(
                    f"non-finite {what} from the device stage")
        if p.size:
            lo, hi = int(p.min()), int(p.max())
            if lo < 0 or hi >= self.cfg.num_classes:
                raise NaNGuardError(
                    f"prediction ids [{lo}, {hi}] outside "
                    f"[0, {self.cfg.num_classes})")
            olo, ohi = int(o.min()), int(o.max())
            if olo < 1 or ohi > self.nai.t_max:
                raise NaNGuardError(
                    f"exit orders [{olo}, {ohi}] outside "
                    f"[1, {self.nai.t_max}]")

    def _fail_batch(self, batch: List[Request], err: Exception
                    ) -> List[Request]:
        """Terminal handling for a batch whose stage raised: only THIS
        batch fails; the queue and other in-flight batches are untouched.
        With `retry_failed` the batch gets one attempt on the host path
        (`infer_batch_host`, which needs no device stage) before it is
        declared failed."""
        if self.retry_failed and not any(r.retried for r in batch):
            for r in batch:
                r.retried = True
            try:
                nodes = np.asarray([r.node_id for r in batch])
                uniq, inv = np.unique(nodes, return_inverse=True)
                p_u, o_u, _, _, _ = infer_batch_host(
                    self.cfg, self.nai, self.classifiers, self.store, uniq)
            except Exception as retry_err:   # noqa: BLE001 — isolation
                err = retry_err
            else:
                self.stats.retried += len(batch)
                self._complete(batch, p_u[inv], o_u[inv],
                               time.perf_counter())
                return batch
        msg = f"{type(err).__name__}: {err}"
        for r in batch:
            r.status = "failed"
            r.error = msg
            r.done_s = time.perf_counter()
        self.stats.failed += len(batch)
        return batch

    def _finalize_oldest(self) -> List[Request]:
        """Wait for the oldest in-flight batch's results (bounded by the
        watchdog when armed) and complete its requests (FIFO, whatever the
        pipeline depth). A sync failure, watchdog trip or guard trip fails
        ONLY this batch."""
        fl = self._inflight.popleft()
        t0 = time.perf_counter()
        try:
            self._watchdog_sync(fl)
            if fl.done is not None:
                fl.done.synchronize()
            preds_a = fl.preds.numpy()
            orders_a = fl.orders.numpy()
            self._guard_results(preds_a, orders_a, fl.nb_real)
        except Exception as e:   # noqa: BLE001 — batch-level isolation
            return self._fail_batch(fl.requests, e)
        if fl.fill is not None:
            # only after the guard: a poisoned batch must not seed later
            # ones. Steps 1..T_max of a batch row are exact global values.
            batch_nodes, dep_nodes, gv = fl.fill
            self.cache.fill(
                self.store, batch_nodes,
                fl.series.numpy()[:, :fl.nb_real].transpose(1, 0, 2),
                dep_nodes, gv)
        preds = preds_a[:fl.nb_real][fl.inv]
        orders = orders_a[:fl.nb_real][fl.inv]
        done = time.perf_counter()
        self.batch_timings.append({
            "host_s": fl.host_s, "dispatch_s": fl.dispatch_s,
            "sync_s": done - t0, "n": len(fl.requests), **fl.stages})
        self._complete(fl.requests, preds, orders, done)
        return fl.requests

    def _complete(self, batch: List[Request], preds, orders,
                  done: float) -> None:
        bid = self.stats.batches
        for r, p, o in zip(batch, preds, orders):
            r.done_s = done
            r.prediction = int(p)
            r.exit_order = int(o)
            r.batch_id = bid
            r.status = "completed"
            self.stats.latencies.append(done - r.arrival_s)
            self.stats.exit_hist[int(o)] = \
                self.stats.exit_hist.get(int(o), 0) + 1
        self.stats.served += len(batch)
        self.stats.batches += 1

    def _validate_node_id(self, node_id) -> int:
        nid = int(node_id)
        if not 0 <= nid < self.store.n:
            raise ValueError(
                f"node id {nid} out of range for store "
                f"{self.store.name!r} with n={self.store.n} nodes "
                f"(valid ids are 0..{self.store.n - 1})")
        return nid

    def submit(self, node_ids, now: Optional[float] = None) -> None:
        now = time.perf_counter() if now is None else now
        # validate the whole call before enqueuing any of it
        nids = [self._validate_node_id(nid)
                for nid in np.atleast_1d(node_ids)]
        for nid in nids:
            self.queue.append(Request(nid, now))

    def submit_request(self, req: Request) -> None:
        """Enqueue a pre-built request (the front-end's path: deadline and
        SLO class already stamped)."""
        self._validate_node_id(req.node_id)
        self.queue.append(req)

    def form_batch(self, now: Optional[float] = None, *,
                   force: bool = False) -> List[Request]:
        """Close a batch on size OR age, whichever comes first: a full
        `batch_size` closes immediately; a partial batch once its oldest
        request has waited `max_wait_s`. Returns [] while neither trigger
        has fired. `now` may be a virtual clock; `force=True` closes
        whatever is queued."""
        if not self.queue:
            return []
        if not force:
            now = time.perf_counter() if now is None else now
            aged = now - self.queue[0].arrival_s >= self.max_wait_s
            if len(self.queue) < self.nai.batch_size and not aged:
                return []
        batch: List[Request] = []
        while self.queue and len(batch) < self.nai.batch_size:
            batch.append(self.queue.popleft())
        return batch

    def _advance(self, opportunistic: bool = False) -> List[Request]:
        """Finalize only batches past the pipeline depth (an empty queue
        must not drain the pipeline); `opportunistic=True` also finalizes
        in-flight batches whose results have already arrived."""
        done: List[Request] = []
        while len(self._inflight) >= self.pipeline_depth:
            done += self._finalize_oldest()
        if opportunistic:
            while self._inflight:
                ev = self._inflight[0].done
                if ev is not None and not ev.query():
                    break
                done += self._finalize_oldest()
        # watchdog re-arm: a hung head batch must not wedge open-loop
        # serving (poll never blocks, so a never-firing event would park
        # below pipeline_depth forever); its deadline has passed, so
        # _watchdog_sync declares it failed at once
        if self.watchdog_s is not None:
            while (self._inflight
                   and time.perf_counter() - self._inflight[0].t_submit
                   >= self.watchdog_s):
                done += self._finalize_oldest()
        return done

    def _inject_host_faults(self) -> None:
        """Host-stage injection point (`slow` then `host`), called once per
        served batch so a plan's event counters align with batch indices.
        No-op without a FaultPlan."""
        if self._faults is None:
            return
        spec = self._faults.fire("slow")
        if spec is not None and spec.delay_s > 0.0:
            time.sleep(spec.delay_s)
        if self._faults.fire("host") is not None:
            raise InjectedFault("injected host-stage failure")

    def _serve_batch(self, batch: List[Request]) -> List[Request]:
        nodes = np.asarray([r.node_id for r in batch])
        # dedupe per batch: duplicated rows would double-count in the
        # stationary state and skew every exit distance
        uniq, inv = np.unique(nodes, return_inverse=True)
        if self.mode == "host":
            try:
                self._inject_host_faults()
                p_u, o_u, _, _, _ = infer_batch_host(
                    self.cfg, self.nai, self.classifiers, self.store, uniq)
            except Exception as e:   # noqa: BLE001 — batch isolation
                return self._fail_batch(batch, e)
            self._complete(batch, p_u[inv], o_u[inv], time.perf_counter())
            return batch
        rec: Dict = {}
        t0 = time.perf_counter()
        try:
            with profiled("serve.host"):
                self._inject_host_faults()
                packed, step_active, slot, fill = self._host_stage(uniq, rec)
            t1 = time.perf_counter()
            with profiled("serve.dispatch"):
                if (self._faults is not None
                        and self._faults.fire("device") is not None):
                    raise InjectedFault("injected device-stage failure")
                preds, orders, series, ev = self._device_stage(
                    packed, step_active, slot)
                preds, orders, ev = poison_results(self._faults, preds,
                                                   orders, ev)
        except Exception as e:   # noqa: BLE001 — batch-level isolation:
            # a stage failure takes down THIS batch only; in-flight batches
            # and the queue are untouched, and _advance keeps the pipeline
            # moving
            return self._fail_batch(batch, e) + self._advance()
        t2 = time.perf_counter()
        self._inflight.append(
            _Inflight(batch, inv, packed.nb_real, preds, orders, ev,
                      host_s=t1 - t0, dispatch_s=t2 - t1, t_submit=t2,
                      series=series, fill=fill, stages=rec))
        done: List[Request] = []
        while len(self._inflight) >= self.pipeline_depth:
            done += self._finalize_oldest()
        return done

    def step(self) -> List[Request]:
        """Closed-loop step: serve whatever is queued now (up to
        batch_size). With pipeline_depth > 1 the returned requests belong
        to an EARLIER batch; call `flush()` after the last step."""
        batch = self.form_batch(force=True)
        if not batch:
            return self._advance()
        return self._serve_batch(batch)

    def poll(self, now: Optional[float] = None) -> List[Request]:
        """Open-loop step: dispatch a batch only if size or age has
        closed one, otherwise advance the pipeline without blocking on
        unfinished device work."""
        batch = self.form_batch(now)
        if not batch:
            return self._advance(opportunistic=True)
        return self._serve_batch(batch)

    def flush(self) -> List[Request]:
        """Complete every in-flight batch."""
        done: List[Request] = []
        while self._inflight:
            done += self._finalize_oldest()
        return done

    def run_until_drained(self) -> EngineStats:
        while self.queue:
            self.step()
        self.flush()
        return self.stats
