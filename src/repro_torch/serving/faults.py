"""Deterministic fault injection for the serving stack (the port of
`repro.serving.faults`).

The serving path is four failure domains deep — `MmapStore` reads, the
host sample/pack stage, the pipelined device NAP stage, and the SLO
front-end. This module is the chaos side of the failure story: a seeded,
replayable schedule of faults (`FaultPlan`) that the engine and a
`FaultyStore` wrapper consult at fixed injection points, so that the
isolation machinery (typed store errors, per-batch failure, NaN guard,
watchdog, circuit breaker) can be exercised and gated.

Design rules (those of the JAX package):

* **Deterministic.** A `FaultPlan` is pure data; `plan.injector()` makes a
  fresh `FaultInjector` whose draws come from
  ``np.random.default_rng([seed, stage_index])`` and whose positional
  triggers (``at=``) count events per stage from the injector's birth. The
  same plan through the same request stream fires the same faults, in
  this package and in the JAX one.
* **Injection points, not monkeypatches.** The engine asks
  ``injector.fire(stage)`` at each stage boundary; the store wrapper does
  the same around ``gather_features``. A fault-free plan (or no plan)
  serves exactly as the engine without the layer.
* **Typed errors.** Injected failures raise `InjectedFault`; the engine's
  guards raise `NaNGuardError` / `WatchdogTimeout`. A failed request's
  ``error`` carries the type name.

Stages (event counter = one tick per served batch, or per gather call for
the store stages):

    ``store_read``     gather raises StoreIOError (transient read fail)
    ``store_latency``  gather sleeps ``delay_s`` first (slow disk)
    ``host``           host sample/pack stage raises
    ``device``         device dispatch raises
    ``nan``            the batch's host results are NaN (bad logits)
    ``hang``           the batch's results never become ready (hung sync)
    ``slow``           host stage sleeps ``delay_s`` (straggler batch)

Offline full-graph inference stages (`repro_torch.launch.full_graph_infer`;
one tick per checkpoint write / checkpoint read / dispatched superstep
attempt):

    ``ckpt_write``     checkpoint payload written but the manifest commit
                       raises (crash mid-checkpoint)
    ``ckpt_read``      a committed checkpoint reads back corrupt
    ``superstep_hang`` a dispatched superstep is declared hung; the
                       offline job's per-superstep watchdog retries it

New stages are appended to `STAGES`: rng streams are seeded by stage index
(``[seed, i]``), so inserting one in the middle would re-deal every plan's
random draws.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.gnn.store import GraphStore, StoreIOError

STAGES = ("store_read", "store_latency", "host", "device", "nan",
          "hang", "slow", "ckpt_write", "ckpt_read", "superstep_hang")


class InjectedFault(RuntimeError):
    """An artificial failure raised at a FaultPlan injection point."""


class NaNGuardError(RuntimeError):
    """Device results failed the finite/range guard — the batch is
    failed rather than letting garbage reach a completed Request."""


class WatchdogTimeout(RuntimeError):
    """A device sync exceeded the engine watchdog deadline — the batch
    is declared hung and failed so the pipeline can re-arm."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One fault rule: fire at `stage` either randomly (`rate` per event)
    or positionally (`at` = event indices), at most `max_fires` times.
    `delay_s` parameterizes the latency stages."""
    stage: str
    rate: float = 0.0
    at: Tuple[int, ...] = ()
    delay_s: float = 0.0
    max_fires: int = -1          # -1 = unbounded

    def __post_init__(self):
        if self.stage not in STAGES:
            raise ValueError(f"unknown fault stage {self.stage!r} "
                             f"(expected one of {STAGES})")
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError(f"rate must be in [0, 1], got {self.rate}")
        if self.delay_s < 0.0:
            raise ValueError(f"delay_s must be >= 0, got {self.delay_s}")
        if any(i < 0 for i in self.at):
            raise ValueError(f"at indices must be >= 0, got {self.at}")
        object.__setattr__(self, "at", tuple(int(i) for i in self.at))


class FaultPlan:
    """An immutable schedule of `FaultSpec`s plus the seed that makes it
    deterministic. Per-run mutable state lives in the `FaultInjector`
    made by `injector()`."""

    def __init__(self, specs: Sequence[FaultSpec] = (), seed: int = 0):
        self.specs = tuple(specs)
        self.seed = int(seed)

    @property
    def empty(self) -> bool:
        return not self.specs

    def injector(self) -> "FaultInjector":
        return FaultInjector(self)

    def describe(self) -> List[Dict]:
        """JSON-able summary."""
        return [dataclasses.asdict(s) for s in self.specs]

    def __repr__(self) -> str:
        return f"FaultPlan(seed={self.seed}, specs={list(self.specs)!r})"


class FaultInjector:
    """Per-run state of a `FaultPlan`: one event counter and one seeded
    rng stream per stage, plus `fired` tallies.

    `fire(stage)` advances that stage's event counter by exactly one and
    draws exactly one uniform per rate-spec on that stage whether or not
    anything fires, so firing at event k never depends on what happened
    at events < k, and two injectors of one plan agree event for event."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._by_stage: Dict[str, List[FaultSpec]] = {s: [] for s in STAGES}
        for spec in plan.specs:
            self._by_stage[spec.stage].append(spec)
        self._rng = {s: np.random.default_rng([plan.seed, i])
                     for i, s in enumerate(STAGES)}
        self._events = {s: 0 for s in STAGES}
        self._spec_fires: Dict[int, int] = {}
        self.fired: Dict[str, int] = {s: 0 for s in STAGES}

    def events(self, stage: str) -> int:
        return self._events[stage]

    def fire(self, stage: str) -> Optional[FaultSpec]:
        """Advance `stage`'s event counter; return the first spec that
        fires at this event (None if none does)."""
        i = self._events[stage]
        self._events[stage] = i + 1
        hit: Optional[FaultSpec] = None
        rng = self._rng[stage]
        for si, spec in enumerate(self._by_stage[stage]):
            fires = i in spec.at
            if spec.rate > 0.0:
                # always draw, even after a positional hit: keeps the
                # stream aligned across plans that differ only in `at`
                fires = (rng.random() < spec.rate) or fires
            if not fires or hit is not None:
                continue
            key = id(spec) ^ si
            count = self._spec_fires.get(key, 0)
            if spec.max_fires >= 0 and count >= spec.max_fires:
                continue
            self._spec_fires[key] = count + 1
            self.fired[stage] += 1
            hit = spec
        return hit

    def summary(self) -> Dict[str, Dict[str, int]]:
        return {s: {"events": self._events[s], "fired": self.fired[s]}
                for s in STAGES if self._events[s] or self.fired[s]}


class _HungEvent:
    """Stand-in for the CUDA event of a batch whose results never become
    ready. The engine's watchdog polls `query()`; without a watchdog the
    eventual `synchronize()` raises instead of blocking the process
    forever (the injection must never deadlock the harness itself)."""

    def query(self) -> bool:
        return False

    def synchronize(self) -> None:
        raise InjectedFault(
            "sync of a hung device batch (arm EngineConfig.watchdog_s "
            "to detect hangs without blocking)")


def poison_results(injector: Optional[FaultInjector], preds, orders, done):
    """Post-dispatch injection point: replace a batch's host results with
    NaN (``nan`` stage — non-finite logits out of the backend; float
    tensors, so the engine's guard sees them, ready at once: ``done`` is
    None) or its completion event with one that never fires (``hang``
    stage). Returns ``(preds, orders, done)``. The engine calls it on every
    dispatched batch so the event counters stay aligned with batches."""
    if injector is None:
        return preds, orders, done
    if injector.fire("nan") is not None:
        def nan_like(t):
            return torch.full(tuple(t.shape) or (1,), float("nan"),
                              dtype=torch.float32)
        return nan_like(preds), nan_like(orders), None
    if injector.fire("hang") is not None:
        return preds, orders, _HungEvent()
    return preds, orders, done


class FaultyStore(GraphStore):
    """Delegating `GraphStore` wrapper that injects storage faults in front
    of an inner store: ``store_read`` raises a typed `StoreIOError` (as an
    exhausted-retry read would), ``store_latency`` sleeps `delay_s` before
    the real gather (slow disk). Everything else delegates, so a plan with
    no store specs is the inner store."""

    def __init__(self, inner: GraphStore, injector: FaultInjector):
        self.inner = inner
        self.injector = injector
        self.name = inner.name
        self.n = inner.n
        self.feat_dim = inner.feat_dim
        self.num_classes = inner.num_classes
        self.num_edges = inner.num_edges
        self.num_self_loops = inner.num_self_loops

    @property
    def row_ptr(self) -> np.ndarray:
        return self.inner.row_ptr

    @property
    def col_idx(self) -> np.ndarray:
        return self.inner.col_idx

    @property
    def features(self) -> np.ndarray:
        return self.inner.features

    @property
    def degrees(self) -> np.ndarray:
        return self.inner.degrees

    @property
    def labels(self):
        return self.inner.labels

    def gather_features(self, nodes: np.ndarray) -> np.ndarray:
        spec = self.injector.fire("store_latency")
        if spec is not None and spec.delay_s > 0.0:
            time.sleep(spec.delay_s)
        if self.injector.fire("store_read") is not None:
            raise StoreIOError(
                f"injected read failure on {self.name} "
                f"(gather event {self.injector.events('store_read') - 1})")
        return self.inner.gather_features(nodes)

    def drop_resident(self) -> int:
        return self.inner.drop_resident()

    def close(self) -> None:
        self.inner.close()
