"""Deadline-aware serving front-end with SLO classes (the port of
`repro.serving.frontend`).

Production traffic is a stream of single requests with heterogeneous
deadlines, not the pre-formed batches of the engine's closed-loop path.
The front-end turns the former into the latter:

* **Request lanes with backpressure** — each SLO class owns a bounded
  lane (`queue_depth`); a submit beyond the bound is rejected (shed) at
  once instead of queued into a certain deadline miss, which keeps the
  queueing delay of every accepted request bounded.
* **Deadline-aware batch former** — dispatch rides the engine's
  `form_batch`: a batch closes on size OR age (the class's `max_wait_s`).
  `step(now)` polls every lane; quiet ticks advance the engine pipelines
  without blocking, so ``pipeline_depth=2`` engines keep their host/device
  overlap under bursty arrivals.
* **SLO classes** — T_max and T_min are the paper's knobs of the
  accuracy/latency trade-off; each class (``gold`` / ``best_effort``)
  routes to its own `NAIServingEngine` at the class's `NAIConfig`, all on
  one device (or mesh) and sharing one set of per-order heads (`Classifiers`): gold
  at a high T_max, best-effort at T_max = T_min.
* **Circuit breaker** — with a `BreakerConfig`, a class whose terminal
  outcomes go bad (failures, and deadline misses if counted) opens its
  breaker and demotes its traffic to its `demote_to` class, then probes
  and closes again after a cooldown.

**Goodput** — answers delivered within their deadline — is the
front-end's currency: `ClassStats` counts offered / accepted / rejected /
completed / deadline hits and misses per class, and `summary()` merges
them with each engine's latency percentiles.

Every method takes an optional ``now``, so the whole front-end can run on
a virtual clock: batch formation then depends only on the submitted
timestamps, and runs are deterministic (front-end == direct engines,
pipelined == serial).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.gnn.nai import NAIConfig
from repro_torch.serving.engine import EngineConfig, NAIServingEngine, Request


@dataclasses.dataclass(frozen=True)
class SLOClass:
    """One latency tier: a name, the NAI config its engine serves at (the
    T_max knob), its default per-request latency budget, the batch
    former's age bound, and the backpressure depth of its lane.

    ``engine`` optionally pins a full per-class `EngineConfig`; classes
    that leave it None inherit the front-end's base config. Either way the
    class's ``max_wait_s`` overrides the config's age bound."""
    name: str
    nai: NAIConfig
    deadline_s: float            # default latency budget per request
    max_wait_s: float            # close a partial batch at this age
    queue_depth: int = 256       # reject (shed) submits beyond this
    engine: Optional[EngineConfig] = None   # per-class engine override
    demote_to: Optional[str] = None   # breaker-open fallback class

    def __post_init__(self):
        if not self.name:
            raise ValueError("SLO class needs a non-empty name")
        if self.deadline_s <= 0:
            raise ValueError(f"{self.name}: deadline_s must be > 0, "
                             f"got {self.deadline_s}")
        if self.max_wait_s < 0:
            raise ValueError(f"{self.name}: max_wait_s must be >= 0, "
                             f"got {self.max_wait_s}")
        if self.queue_depth < 1:
            raise ValueError(f"{self.name}: queue_depth must be >= 1, "
                             f"got {self.queue_depth}")


def default_slo_classes(base: NAIConfig, *, gold_deadline_s: float = 0.5,
                        best_effort_deadline_s: float = 0.2,
                        gold_max_wait_s: float = 0.05,
                        best_effort_max_wait_s: float = 0.02,
                        queue_depth: Optional[int] = None
                        ) -> Sequence[SLOClass]:
    """The two-tier default: ``gold`` serves at the base config's T_max
    (accuracy tier) and demotes to ``best_effort``, which serves at T_max =
    T_min (the cheapest loop, the fastest answer). Both keep the base
    batch size."""
    qd = queue_depth if queue_depth is not None else 4 * base.batch_size
    return (
        SLOClass("gold", base, deadline_s=gold_deadline_s,
                 max_wait_s=gold_max_wait_s, queue_depth=qd,
                 demote_to="best_effort"),
        SLOClass("best_effort",
                 dataclasses.replace(base, t_max=base.t_min),
                 deadline_s=best_effort_deadline_s,
                 max_wait_s=best_effort_max_wait_s, queue_depth=qd),
    )


@dataclasses.dataclass(frozen=True)
class BreakerConfig:
    """Per-class circuit-breaker policy (shared by every class of a
    front-end that installs one). The breaker watches terminal outcomes —
    failures, plus deadline misses when `count_misses` — over a sliding
    window and trips when the bad fraction is sustained."""
    window: int = 32             # sliding window of terminal outcomes
    trip_frac: float = 0.5       # bad fraction that opens the breaker
    min_events: int = 16         # don't trip on a near-empty window
    cooldown_s: float = 1.0      # open -> half_open after this long
    probes: int = 3              # half_open: successes needed to close
    open_depth_frac: float = 0.5     # lane-depth scale while not closed
    count_misses: bool = True    # deadline misses count as bad outcomes

    def __post_init__(self):
        if self.window < 1:
            raise ValueError(f"window must be >= 1, got {self.window}")
        if not 0.0 < self.trip_frac <= 1.0:
            raise ValueError(f"trip_frac must be in (0, 1], got "
                             f"{self.trip_frac}")
        if not 1 <= self.min_events <= self.window:
            raise ValueError(f"min_events must be in [1, window], got "
                             f"{self.min_events}")
        if self.cooldown_s <= 0:
            raise ValueError(f"cooldown_s must be > 0, got "
                             f"{self.cooldown_s}")
        if self.probes < 1:
            raise ValueError(f"probes must be >= 1, got {self.probes}")
        if not 0.0 < self.open_depth_frac <= 1.0:
            raise ValueError(f"open_depth_frac must be in (0, 1], got "
                             f"{self.open_depth_frac}")


class CircuitBreaker:
    """closed -> open -> half_open -> closed, driven by the terminal
    request outcomes of one SLO class.

    *closed*: all traffic routes natively; a sustained bad fraction
    (`trip_frac` of the last `window` outcomes, at least `min_events` of
    them) opens the breaker.
    *open*: no native traffic — the front-end demotes to the class's
    `demote_to` engine or sheds, and sheds earlier either way
    (`open_depth_frac` lane bound). After `cooldown_s` the next routing
    decision moves to half_open.
    *half_open*: up to `probes` requests route natively as probes; a
    failing probe re-opens (fresh cooldown), `probes` successes close.

    Transitions are recorded as ``(t, from, to)``."""

    def __init__(self, cfg: BreakerConfig):
        self.cfg = cfg
        self.state = "closed"
        self.trips = 0
        self.transitions: List[Tuple[float, str, str]] = []
        self._events = deque(maxlen=cfg.window)
        self._opened_at = 0.0
        self._probes_out = 0
        self._probe_ok = 0

    def _to(self, state: str, now: float) -> None:
        self.transitions.append((now, self.state, state))
        self.state = state
        if state == "open":
            self.trips += 1
            self._opened_at = now
            self._probes_out = 0
            self._probe_ok = 0
            self._events.clear()
        elif state == "closed":
            self._events.clear()

    def route(self, now: float) -> str:
        """Routing decision for one submit: ``"native"`` | ``"probe"`` |
        ``"reroute"``. Also where open ages into half_open."""
        if (self.state == "open"
                and now - self._opened_at >= self.cfg.cooldown_s):
            self._to("half_open", now)
        if self.state == "closed":
            return "native"
        if (self.state == "half_open"
                and self._probes_out < self.cfg.probes):
            self._probes_out += 1
            return "probe"
        return "reroute"

    def on_terminal(self, bad: bool, probe: bool, now: float) -> None:
        """Feed one terminal outcome back into the state machine."""
        if probe:
            if self.state != "half_open":
                return            # stale probe from before a transition
            if bad:
                self._to("open", now)
                return
            self._probe_ok += 1
            if self._probe_ok >= self.cfg.probes:
                self._to("closed", now)
            return
        if self.state != "closed":
            return                # outcomes of pre-trip traffic draining
        self._events.append(bool(bad))
        if (len(self._events) >= self.cfg.min_events
                and sum(self._events)
                >= self.cfg.trip_frac * len(self._events)):
            self._to("open", now)


@dataclasses.dataclass
class ClassStats:
    offered: int = 0          # every submit attempt
    accepted: int = 0         # made it past backpressure
    rejected: int = 0         # shed at submit (lane full / breaker open)
    completed: int = 0
    deadline_hits: int = 0    # completed within budget (goodput)
    deadline_misses: int = 0
    failed: int = 0           # terminal status="failed" (batch fault)
    retried: int = 0          # completed on the engine's host path
    degraded: int = 0         # accepted onto the demote_to engine

    def summary(self) -> Dict[str, float]:
        return {
            "offered": self.offered, "accepted": self.accepted,
            "rejected": self.rejected, "completed": self.completed,
            "deadline_hits": self.deadline_hits,
            "deadline_misses": self.deadline_misses,
            "failed": self.failed, "retried": self.retried,
            "degraded": self.degraded,
            "goodput_frac": self.deadline_hits / max(self.offered, 1),
        }


class ServingFrontend:
    """Routes single requests into per-SLO-class `NAIServingEngine`s on
    one device, or on one mesh of shards (``mesh=``).

    ``classes`` is an ordered sequence of `SLOClass`; the first is the
    default routing target. ``classifiers`` is the trained per-order heads
    (`Classifiers`), shared by every class engine: a class at T_max = l
    classifies with heads 1..l. The base engine configuration comes either
    as one ``engine=EngineConfig(...)`` or as keyword arguments
    (``mode=``, ``spmm_impl=``, ``mesh=``, ...), not both. Each class engine gets the
    base config (or the class's own ``engine``) with the class's
    `NAIConfig` and `max_wait_s` put in, on ``device`` (default
    ``"cuda"``; with a mesh, the mesh's first device)."""

    def __init__(self, cfg, classifiers, graph,
                 classes: Sequence[SLOClass], *,
                 engine: Optional[EngineConfig] = None,
                 breaker: Optional[BreakerConfig] = None,
                 device=None, mode: str = "compiled",
                 pipeline_depth: int = 1, latency_window: int = 4096,
                 **engine_kwargs):
        if not classes:
            raise ValueError("need at least one SLO class")
        names = [c.name for c in classes]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO class names: {names}")
        for c in classes:
            if c.demote_to is not None and (c.demote_to not in names
                                            or c.demote_to == c.name):
                raise ValueError(
                    f"{c.name}: demote_to={c.demote_to!r} must name a "
                    f"DIFFERENT class of this front-end ({names})")
        if engine is not None and engine_kwargs:
            raise ValueError(
                f"pass either engine=EngineConfig(...) or engine kwargs, "
                f"not both (got kwargs {sorted(engine_kwargs)})")
        base = engine if engine is not None else EngineConfig(
            mode=mode, pipeline_depth=pipeline_depth,
            latency_window=latency_window, **engine_kwargs)
        self.classes: Dict[str, SLOClass] = {c.name: c for c in classes}
        self.default_class = classes[0].name
        self.engine_config = base
        self.pipeline_depth = base.pipeline_depth
        self.engines: Dict[str, NAIServingEngine] = {
            c.name: NAIServingEngine(
                cfg, c.nai, classifiers, graph, device=device,
                config=dataclasses.replace(
                    c.engine if c.engine is not None else base,
                    max_wait_s=c.max_wait_s))
            for c in classes}
        self.stats: Dict[str, ClassStats] = {
            c.name: ClassStats() for c in classes}
        # one breaker per class when a policy is installed (None keeps the
        # routing breaker-free: no state, no draws)
        self.breaker_config = breaker
        self.breakers: Dict[str, CircuitBreaker] = (
            {c.name: CircuitBreaker(breaker) for c in classes}
            if breaker is not None else {})

    # ---------------------------------------------------------- ingress
    def submit(self, node_id: int, slo_class: Optional[str] = None,
               now: Optional[float] = None,
               budget_s: Optional[float] = None) -> Optional[Request]:
        """Route one request into its class lane. Returns the `Request` if
        accepted, None if shed (lane at its depth, or breaker open with
        nowhere to demote). ``budget_s`` overrides the class's default
        latency budget; the absolute deadline ``arrival + budget`` is
        stamped on the request."""
        name = self.default_class if slo_class is None else slo_class
        if name not in self.classes:
            raise KeyError(f"unknown SLO class {name!r} "
                           f"(one of {sorted(self.classes)})")
        c, eng, st = self.classes[name], self.engines[name], self.stats[name]
        # validate before any accounting: a malformed id is the caller's
        # error (raised), not an offered-and-shed request
        nid = eng._validate_node_id(node_id)
        now = time.perf_counter() if now is None else now
        st.offered += 1
        probe = degraded = False
        depth = c.queue_depth
        br = self.breakers.get(name)
        if br is not None:
            route = br.route(now)
            if route == "probe":
                probe = True
            elif route == "reroute":
                if c.demote_to is None:
                    st.rejected += 1    # nowhere to degrade to: shed
                    return None
                # demote onto the fallback engine, with an earlier shed
                # bound so a tripped class can't flood its fallback
                eng = self.engines[c.demote_to]
                depth = max(1, int(self.classes[c.demote_to].queue_depth
                                   * br.cfg.open_depth_frac))
                degraded = True
        if len(eng.queue) >= depth:
            st.rejected += 1
            return None
        budget = c.deadline_s if budget_s is None else budget_s
        req = Request(nid, now, deadline_s=now + budget,
                      slo_class=name, probe=probe, degraded=degraded)
        eng.submit_request(req)
        st.accepted += 1
        if degraded:
            st.degraded += 1
        return req

    # ----------------------------------------------------------- egress
    def _account(self, terminal: List[Request],
                 now: Optional[float] = None) -> List[Request]:
        """Score terminal requests into their ORIGIN class's stats
        (demoted requests keep their class tag) and feed the outcomes to
        that class's breaker."""
        if terminal and now is None:
            now = time.perf_counter()
        for r in terminal:
            st = self.stats[r.slo_class]
            if r.status == "failed":
                st.failed += 1
                bad = True
            else:
                st.completed += 1
                if r.retried:
                    st.retried += 1
                if r.within_deadline:
                    st.deadline_hits += 1
                    bad = False
                else:
                    st.deadline_misses += 1
                    bad = (self.breaker_config.count_misses
                           if self.breaker_config is not None else False)
            br = self.breakers.get(r.slo_class)
            if br is not None:
                br.on_terminal(bad, r.probe, now)
        return terminal

    def step(self, now: Optional[float] = None) -> List[Request]:
        """Poll every class lane once: dispatch the batches the former has
        closed (size or age), advance pipelines without blocking
        otherwise. Returns the newly terminal requests of every class."""
        done: List[Request] = []
        for eng in self.engines.values():
            done += self._account(eng.poll(now), now)
        return done

    def flush(self, now: Optional[float] = None) -> List[Request]:
        """Drain: force-close every partial batch still queued, then sync
        every in-flight batch (the end-of-stream path)."""
        done: List[Request] = []
        for eng in self.engines.values():
            while eng.queue:
                done += self._account(eng.step(), now)
            done += self._account(eng.flush(), now)
        return done

    # ------------------------------------------------------------ stats
    def pending(self) -> int:
        """Requests accepted but not yet terminal (queued + in flight)."""
        return sum(len(eng.queue)
                   + sum(len(fl.requests) for fl in eng._inflight)
                   for eng in self.engines.values())

    def pending_by_class(self) -> Dict[str, int]:
        """Pending counts keyed by ORIGIN class (demoted requests sit in
        their fallback engine but count against the class that accepted
        them: offered == rejected + completed + failed + pending)."""
        out = {name: 0 for name in self.classes}
        for eng in self.engines.values():
            for r in eng.queue:
                out[r.slo_class] += 1
            for fl in eng._inflight:
                for r in fl.requests:
                    out[r.slo_class] += 1
        return out

    def close(self) -> None:
        """Drain every engine and release the (shared) store's OS
        resources. Idempotent."""
        for eng in self.engines.values():
            eng.close()

    def reset_stats(self) -> None:
        """Zero the per-class counters and each engine's serving stats
        (`NAIServingEngine.reset_stats`); pools, high-water marks and cache
        contents are kept — steady state is the point of resetting."""
        for name, eng in self.engines.items():
            eng.reset_stats()
            self.stats[name] = ClassStats()

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Per-class goodput counters merged with the class engine's
        latency percentiles and pack-pool counter."""
        out: Dict[str, Dict[str, float]] = {}
        for name, eng in self.engines.items():
            s = self.stats[name].summary()
            es = eng.stats.summary()
            s.update(p50_ms=es["p50_ms"], p95_ms=es["p95_ms"],
                     p99_ms=es["p99_ms"], batches=es["batches"],
                     jit_compiles=eng.jit_stats["compiles"],
                     pack_allocs=eng.pack_stats["allocs"])
            br = self.breakers.get(name)
            if br is not None:
                s.update(breaker_state=br.state, breaker_trips=br.trips)
            out[name] = s
        return out
