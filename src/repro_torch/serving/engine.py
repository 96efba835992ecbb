"""Batched NAI serving engine (the port of `repro.serving.engine`,
single device).

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
    writes straight into pinned memory.
  - **device stage** (`_device_stage`): asynchronous host-to-device copies
    of the operands from the pinned buffers, the kernels of the masked NAP
    loop plus per-order classification (`make_compiled_infer`), and an
    asynchronous copy of the (nb,) predictions and exit orders back into
    pinned host memory, followed by a CUDA event. Nothing in it waits for
    the card.

  With ``pipeline_depth=1`` the stages run back to back per batch. With
  ``pipeline_depth=2`` one batch stays in flight: batch N+1's sampling and
  packing overlap batch N's device work, and N's results are read (its
  event waited on) only once N+1 has been submitted. Completion stays
  FIFO, so predictions and exit orders equal serial serving's. The pool
  rotates ``pipeline_depth + 1`` buffer sets per batch bucket, and before
  a set is refilled the host waits on the event recorded after its last
  copies, so packing never overwrites bytes still being copied.

Compiled-mode `spmm_impl` names a registered `PropagationBackend`
(`repro_torch.gnn.backends`): ``segment``, ``block_ell`` or ``fused``.
The mesh, propagated-feature cache, fault injection, watchdog and retry
of the JAX engine are not ported yet.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.gnn.backends import BACKENDS, get_backend, pack_operands
from repro_torch.gnn.models import Classifiers, GNNConfig
from repro_torch.gnn.nai import (NAIConfig, infer_batch_host,
                                 make_compiled_infer,
                                 support_stationary_factors)
from repro_torch.gnn.packing import (PackedSupport, batch_bucket,
                                     pack_support, step_active_blocks)
from repro_torch.gnn.sampler import sample_support
from repro_torch.gnn.store import as_store


class NaNGuardError(RuntimeError):
    """Device results failed the finite/range guard — the batch is
    failed rather than letting garbage reach a completed Request."""


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Validated serving-engine configuration."""
    mode: str = "host"               # "host" (numpy) | "compiled"
    spmm_impl: str = "block_ell"     # registered PropagationBackend name
    pipeline_depth: int = 1          # 1 = serial, 2 = one batch in flight
    max_wait_s: float = 0.01         # batch former age bound
    latency_window: int = 4096       # LatencyRing capacity
    nan_guard: bool = True           # finite/range check on synced results

    def __post_init__(self):
        if self.mode not in ("host", "compiled"):
            raise ValueError(f"unknown mode {self.mode!r}")
        if self.spmm_impl not in BACKENDS:
            raise ValueError(f"unknown spmm_impl {self.spmm_impl!r} "
                             f"(one of {sorted(BACKENDS)})")
        if self.pipeline_depth < 1:
            raise ValueError(f"pipeline_depth must be >= 1, got "
                             f"{self.pipeline_depth}")
        if self.pipeline_depth > 1 and self.mode != "compiled":
            raise ValueError("pipelining overlaps host pack with device "
                             "compute; mode='host' has no device stage")
        if self.max_wait_s < 0:
            raise ValueError(f"max_wait_s must be >= 0, got "
                             f"{self.max_wait_s}")
        if self.latency_window < 1:
            raise ValueError(f"latency_window must be >= 1, got "
                             f"{self.latency_window}")


@dataclasses.dataclass
class Request:
    node_id: int
    arrival_s: float
    done_s: float = -1.0
    prediction: int = -1
    exit_order: int = -1
    batch_id: int = -1                 # engine batch this completed in
    # terminal lifecycle: every accepted request ends EXACTLY once as
    # "completed" or "failed"
    status: str = "pending"            # "pending" | "completed" | "failed"
    error: str = ""                    # failure cause when failed


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
    done: Optional[torch.cuda.Event]   # None: results already on the host
    host_s: float            # sample + pack wall time
    dispatch_s: float        # copy + launch wall time


# PackedSupport fields that travel to the device
_UPLOADED = ("tiles", "tile_col", "valid", "src", "dst", "coef", "c_inf",
             "s_inf", "x0", "x_inf")


class NAIServingEngine:
    def __init__(self, cfg: GNNConfig, nai: NAIConfig,
                 classifiers: Classifiers, graph, *, device="cuda",
                 config: Optional[EngineConfig] = None, **kwargs):
        """`graph` is a `GraphStore` (or a raw `Graph`, wrapped via
        `as_store`); `classifiers` the per-order heads, moved to `device`.
        Engine options come either as one ``config=EngineConfig(...)`` or
        as keyword arguments (``mode=``, ``spmm_impl=``, ...), never
        both."""
        if config is not None and kwargs:
            raise ValueError(
                f"pass either config=EngineConfig(...) or engine kwargs, "
                f"not both (got kwargs {sorted(kwargs)})")
        ec = config if config is not None else EngineConfig(**kwargs)
        self.device = resolve_device(device)
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
        self.nan_guard = ec.nan_guard
        self.queue: Deque[Request] = deque()
        self.stats = EngineStats(latencies=LatencyRing(ec.latency_window))
        self.pack_stats: Dict[str, int] = {"allocs": 0, "reuses": 0}
        # per-batch stage breakdown (host/dispatch/sync seconds), bounded
        self.batch_timings: Deque[Dict[str, float]] = deque(maxlen=1024)
        # bucket high-water marks keyed by padded batch size
        # -> (s_bucket, tb_bucket, e_bucket)
        self._bucket_hwm: Dict[int, Tuple[int, int, int]] = {}
        self._inflight: Deque[_Inflight] = deque()
        # rotating pack-buffer pool: bucket -> pipeline_depth + 1 slots,
        # with the pinned host tensors behind each slot's arrays and the
        # event recorded after the slot's last host-to-device copies
        self._pack_pool: Dict[int, List[Optional[PackedSupport]]] = {}
        self._pool_idx: Dict[int, int] = {}
        self._pinned: Dict[Tuple[int, int], Dict[str, torch.Tensor]] = {}
        self._copied: Dict[Tuple[int, int], torch.cuda.Event] = {}
        self._backend = None
        self._runner = None
        if ec.mode == "compiled":
            self._backend = get_backend(ec.spmm_impl)
            self._runner = make_compiled_infer(cfg, nai,
                                               spmm_impl=ec.spmm_impl,
                                               device=self.device)

    def reset_stats(self) -> None:
        """Zero the request counters and timings; serving state (pools,
        high-water marks, pack counters) survives."""
        self.stats = EngineStats(
            latencies=LatencyRing(self.config.latency_window))
        self.batch_timings.clear()

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

    def _host_stage(self, nodes: np.ndarray):
        """Sample the support and pack it into a pooled buffer set, plus
        the static per-step row-block predicate for the tile backends.
        `nodes` must be duplicate-free. Returns (packed, step_active,
        slot)."""
        store, cfg, nai = self.store, self.cfg, self.nai
        be = self._backend
        sup = sample_support(store, nodes, nai.t_max, cfg.r)
        nb = sup.n_batch
        x0 = store.gather_features(sup.nodes).astype(np.float32)
        # the dense x_inf is built from the f32 factors, so the fused
        # kernel (which multiplies the factors in f32) sees the same
        # stationary state bit for bit; the fused path never builds it
        c_inf, s_inf = support_stationary_factors(store, sup, x0, cfg.r)
        c_inf = c_inf.astype(np.float32)
        s_inf = s_inf.astype(np.float32)
        if be.uses_dense_x_inf:
            x_inf = c_inf[:, None] * s_inf[None, :]
        else:
            x_inf = np.zeros((nb, 0), np.float32)

        nb_bucket = batch_bucket(nb)
        hwm = self._bucket_hwm.get(nb_bucket, (0, 0, 0))
        slots = self._pack_pool.setdefault(
            nb_bucket, [None] * (self.pipeline_depth + 1))
        idx = self._pool_idx.get(nb_bucket, 0)
        slot = (nb_bucket, idx)
        copied = self._copied.pop(slot, None)
        if copied is not None:
            copied.synchronize()   # the slot's last copies have finished
        packed = pack_support(sup, x0, x_inf, nb_bucket=nb_bucket,
                              s_bucket=hwm[0], tb_bucket=hwm[1],
                              e_bucket=hwm[2],
                              build_tiles=be.uses_tiles,
                              build_edges=be.uses_edges,
                              x_inf_factors=(c_inf, s_inf)
                              if be.uses_factors else None,
                              out=slots[idx])
        slots[idx] = packed
        self._pool_idx[nb_bucket] = (idx + 1) % len(slots)
        self.pack_stats["reuses" if packed.reused else "allocs"] += 1
        if self.device.type == "cuda" and not packed.reused:
            self._pinned[slot] = self._pin(packed)
        self._bucket_hwm[nb_bucket] = (
            max(hwm[0], packed.n_pad), max(hwm[1], packed.tiles.shape[1]),
            max(hwm[2], packed.src.shape[-1]))
        step_active = (step_active_blocks(packed.hop_rb, nai.t_max)
                       if be.uses_tiles else None)
        return packed, step_active, slot

    # ----------------------------------------------------- device stage
    def _device_stage(self, packed: PackedSupport,
                      step_active: Optional[np.ndarray], slot):
        """Copy the operands to the device, launch the masked NAP loop and
        the classifiers, and start copying the results back. Returns
        (preds, orders, done) without waiting for the card: `preds` and
        `orders` are host tensors valid once the CUDA event `done` has
        fired (None on the CPU, where they are ready on return)."""
        dev = self.device
        arrays = pack_operands(self._backend, packed, step_active)
        arrays.update(x0=packed.x0, x_inf=packed.x_inf)
        pinned = self._pinned.get(slot, {})
        on_dev = {}
        for name, arr in arrays.items():
            host = pinned.get(name)
            if host is None:
                host = torch.from_numpy(arr)
            on_dev[name] = host.to(dev, non_blocking=True)
        if dev.type == "cuda":
            copied = torch.cuda.Event()
            copied.record()
            self._copied[slot] = copied
        x0, x_inf = on_dev.pop("x0"), on_dev.pop("x_inf")
        preds, orders = self._runner(self.classifiers, on_dev, x0, x_inf)
        if dev.type != "cuda":
            return preds, orders, None
        preds_h = torch.empty(preds.shape, dtype=preds.dtype,
                              pin_memory=True)
        orders_h = torch.empty(orders.shape, dtype=orders.dtype,
                               pin_memory=True)
        preds_h.copy_(preds, non_blocking=True)
        orders_h.copy_(orders, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return preds_h, orders_h, done

    def _guard_results(self, preds: np.ndarray, orders: np.ndarray,
                       nb_real: int) -> None:
        """Fail the batch if the device returned garbage: out-of-range
        class ids or exit orders. Guards values only — a passing batch's
        results are untouched."""
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
        batch fails; the queue and other in-flight batches are
        untouched."""
        msg = f"{type(err).__name__}: {err}"
        for r in batch:
            r.status = "failed"
            r.error = msg
            r.done_s = time.perf_counter()
        self.stats.failed += len(batch)
        return batch

    def _finalize_oldest(self) -> List[Request]:
        """Wait for the oldest in-flight batch's results and complete its
        requests (FIFO, whatever the pipeline depth). A sync failure or a
        guard trip fails ONLY this batch."""
        fl = self._inflight.popleft()
        t0 = time.perf_counter()
        try:
            if fl.done is not None:
                fl.done.synchronize()
            preds_a = fl.preds.numpy()
            orders_a = fl.orders.numpy()
            self._guard_results(preds_a, orders_a, fl.nb_real)
        except Exception as e:   # noqa: BLE001 — batch-level isolation
            return self._fail_batch(fl.requests, e)
        preds = preds_a[:fl.nb_real][fl.inv]
        orders = orders_a[:fl.nb_real][fl.inv]
        done = time.perf_counter()
        self.batch_timings.append({
            "host_s": fl.host_s, "dispatch_s": fl.dispatch_s,
            "sync_s": done - t0, "n": len(fl.requests)})
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
        return done

    def _serve_batch(self, batch: List[Request]) -> List[Request]:
        nodes = np.asarray([r.node_id for r in batch])
        # dedupe per batch: duplicated rows would double-count in the
        # stationary state and skew every exit distance
        uniq, inv = np.unique(nodes, return_inverse=True)
        if self.mode == "host":
            try:
                p_u, o_u, _, _, _ = infer_batch_host(
                    self.cfg, self.nai, self.classifiers, self.store, uniq)
            except Exception as e:   # noqa: BLE001 — batch isolation
                return self._fail_batch(batch, e)
            self._complete(batch, p_u[inv], o_u[inv], time.perf_counter())
            return batch
        t0 = time.perf_counter()
        try:
            packed, step_active, slot = self._host_stage(uniq)
            t1 = time.perf_counter()
            preds, orders, ev = self._device_stage(packed, step_active,
                                                   slot)
        except Exception as e:   # noqa: BLE001 — batch-level isolation
            return self._fail_batch(batch, e) + self._advance()
        t2 = time.perf_counter()
        self._inflight.append(
            _Inflight(batch, inv, packed.nb_real, preds, orders, ev,
                      host_s=t1 - t0, dispatch_s=t2 - t1))
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
