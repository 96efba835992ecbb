"""Counted cost of a step: the port's counterpart of
`repro.launch.hlo_analysis`.

The reference compiles a step for the production mesh and reads the
optimized, post-SPMD HLO text, multiplying each while body by its trip
count. The port has no HLO: `analyze` runs the step itself, on `meta`
tensors (shapes and dtypes, no memory, no arithmetic), under a
`TorchDispatchMode` that sees every op the step dispatches, the backward
pass's included, and counts from the ops:

* `dot_flops`: the matmuls' flops by `torch.utils.flop_counter`'s
  formulas (mm, addmm, bmm, baddbmm: what `einsum` and `matmul` dispatch
  to), plus each kernel's `cost()` flops, which B4 and B5 hand over on
  `meta` inputs (`kernel_flops`);
* `traffic_bytes`: the reference's HBM proxy. Each op that writes memory
  writes its result once and reads it once: 2x the bytes of each new
  result, or of each argument it updates in place (as the reference
  counts a dynamic-update-slice by its update); a view writes nothing. A
  kernel call counts as one op (its output), a collective as one op (its
  received blocks), and the arguments of the step count once;
* `collective_bytes`, by the reference's kinds: the bytes of each
  collective's result block that a position receives, the HLO's result
  shape per device, recorded by `placement`'s collectives (`collective`;
  `sync_grads` counts as an all-reduce). This is not what the single
  controller copies, which `MeshScope.exchange` keeps counting;
* `peak_bytes`: the high-water mark of the bytes of storage made during
  the step and still held (the counterpart of the compiled program's
  `temp_size_in_bytes`);
* `param_bytes`: the arguments' bytes.

Every count is per position, as the reference's post-SPMD counts are per
device: the one process runs every position's blocks, so each sum is
divided by the mesh's size. The peak is the whole run's divided so too.

Loop awareness: the reference multiplies a scan body by its trip count.
The port's layers are a Python loop that leaves no body to read, so
`launch.dryrun` counts a model of a few repeats of the layer pattern and
one more, and `extrapolate`s linearly to the config's depth.

Not ported, as they read HLO text, which the port does not have:
`parse_hlo`, `_trip_count`, `computation_multiplicities`, `_find_entry`,
`_shape_bytes`, `_shape_elems` (and `Op`, `Computation`).
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import weakref
from typing import Dict, Iterable, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
# the reference's kind of each of `placement`'s collectives
KINDS = {"all_reduce_sum": "all-reduce", "grad_sync": "all-reduce",
         "reduce_scatter": "reduce-scatter", "all_gather": "all-gather",
         "gather": "all-gather", "all_to_all": "all-to-all",
         "columns_to_pairs": "all-to-all", "pairs_to_columns": "all-to-all"}


@dataclasses.dataclass
class CostStats:
    """Counts per position (`HloStats`' fields, and the peak). `mults`
    gives each counted model's weight in an extrapolated count (the
    reference's computation multiplicities); `loopless_flops` are the
    flops of the fewest repeats counted, as a count blind to the loop
    would give them."""
    dot_flops: float
    traffic_bytes: float
    collective_bytes: Dict[str, float]
    param_bytes: float
    peak_bytes: float = 0.0
    mults: Dict[str, float] = dataclasses.field(default_factory=dict)
    loopless_flops: float = 0.0

    @property
    def collective_total(self) -> float:
        return sum(self.collective_bytes.values())


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(x) -> Iterable[torch.Tensor]:
    """The tensors of an op's argument or result (a tensor, or a list or
    tuple of them)."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            if isinstance(v, torch.Tensor):
                yield v


class _Counter(TorchDispatchMode):
    """The counts of the ops dispatched while it is entered."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.traffic = 0.0
        self.coll = dict.fromkeys(COLLECTIVES, 0.0)
        self.live = self.peak = 0
        self.quiet = 0          # > 0: inside one op (a collective's body)
        self._held = weakref.WeakKeyDictionary()

    def _free(self, n: int) -> None:
        self.live -= n

    def _hold(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        n = st.nbytes()
        if n == 0 or st in self._held:
            return
        self._held[st] = n
        weakref.finalize(st, self._free, n)
        self.live += n
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        schema = func._schema
        rets = schema.returns
        written = 0
        for r, o in (zip(rets, out) if len(rets) > 1 else ((rets[0], out),)
                     if rets else ()):
            if r.alias_info is None:               # new storage
                for t in _tensors(o):
                    self._hold(t)
                    written += _nbytes(t)
        for a, v in zip(schema.arguments, args):
            if a.alias_info is not None and a.alias_info.is_write:
                written += sum(_nbytes(t) for t in _tensors(v))
        for name, v in kwargs.items():             # out= arguments
            if any(a.name == name and a.alias_info is not None
                   and a.alias_info.is_write for a in schema.arguments):
                written += sum(_nbytes(t) for t in _tensors(v))
        if not self.quiet:
            self.traffic += 2.0 * written
            packet = func._overloadpacket
            if packet in flop_registry:
                self.flops += flop_registry[packet](*args, **kwargs,
                                                    out_val=out)
        return out


_ACTIVE: contextvars.ContextVar[Optional[_Counter]] = contextvars.ContextVar(
    "repro_torch_cost_counter", default=None)


def kernel_flops(flops: float) -> None:
    """A kernel's `cost()` flops, from its wrapper on `meta` inputs,
    added to the counter of the running `analyze` (if any)."""
    c = _ACTIVE.get()
    if c is not None:
        c.flops += float(flops)


@contextlib.contextmanager
def one_op():
    """The ops run inside are not counted one by one (a collective's
    copies and sums): the collective counts as one op (`collective`).
    Their storage is still held and counted in the peak."""
    c = _ACTIVE.get()
    if c is not None:
        c.quiet += 1
    try:
        yield
    finally:
        if c is not None:
            c.quiet -= 1


def collective(op: str, received: int) -> None:
    """A collective of `placement` (`op` one of `KINDS`) whose result
    blocks hold `received` bytes, summed over the positions that
    received them: counted under the reference's kind, and as one op of
    traffic."""
    c = _ACTIVE.get()
    if c is not None:
        c.coll[KINDS[op]] += received
        c.traffic += 2.0 * received


def _arg_bytes(x) -> int:
    """The bytes of the tensors in an argument tree (dicts, lists,
    tuples; a placed tensor's blocks)."""
    from repro_torch.sharding.placement import is_sharded
    if isinstance(x, dict):
        return sum(_arg_bytes(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return sum(_arg_bytes(v) for v in x)
    if is_sharded(x):
        return sum(_nbytes(b) for b in x.locals)
    return _nbytes(x) if isinstance(x, torch.Tensor) else 0


def analyze(fn, *args, positions: int = 1) -> CostStats:
    """Run fn(*args) (on `meta` tensors, for a step at production size)
    and count what it dispatches (the module's docstring), each count
    divided by `positions`, the mesh's size. fn's result is dropped."""
    counter = _Counter()
    token = _ACTIVE.set(counter)
    try:
        with counter:
            fn(*args)
    finally:
        _ACTIVE.reset(token)
    params = float(_arg_bytes(args))
    n = float(positions)
    return CostStats(
        dot_flops=counter.flops / n,
        traffic_bytes=(counter.traffic + params) / n,
        collective_bytes={k: v / n for k, v in counter.coll.items()},
        param_bytes=params / n, peak_bytes=counter.peak / n,
        loopless_flops=counter.flops / n)


def extrapolate(weighted: Sequence[Tuple[str, float, CostStats]]
                ) -> CostStats:
    """Σ weight x counts over (label, weight, CostStats): the counts of a
    deeper model from models of fewer repeats, each count linear in the
    repeats (`launch.dryrun`). `loopless_flops` are the first's."""
    def total(get):
        return sum(w * get(s) for _, w, s in weighted)
    return CostStats(
        dot_flops=total(lambda s: s.dot_flops),
        traffic_bytes=total(lambda s: s.traffic_bytes),
        collective_bytes={k: total(lambda s: s.collective_bytes[k])
                          for k in COLLECTIVES},
        param_bytes=total(lambda s: s.param_bytes),
        peak_bytes=total(lambda s: s.peak_bytes),
        mults={label: w for label, w, _ in weighted},
        loopless_flops=weighted[0][2].dot_flops)
