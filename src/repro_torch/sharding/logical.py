"""Logical axis system (`repro.sharding.logical`).

Every parameter / activation dimension gets a *logical* name; a rules table
maps logical names onto mesh axes. Meshes with or without a 'pod' axis reuse
the same rules — missing mesh axes are silently dropped, so a config fits
unchanged on (16, 16) and (2, 16, 16).

A mesh here is the port's `DeviceMesh` (`repro_torch.launch.mesh`) or a
plain ``{axis: size}`` mapping, so that the production shapes can be
reasoned about without devices. `P` is the counterpart of JAX's
`PartitionSpec`: a tuple whose entries are None, an axis name or a tuple
of axis names. `named` gives the counterpart of `NamedSharding`, which
says what block of a global shape each mesh position holds.

`use_mesh(mesh)` plays the role of the reference's ambient ``with mesh:``;
`constrain` re-lays a placed tensor out inside it
(`repro_torch.sharding.placement`) and does nothing outside a mesh or on
a mesh of one position.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import itertools
import math
from typing import Dict, Iterator, Mapping, Optional, Sequence, Tuple

# logical name -> preferred mesh axes (in order). A logical name mapping to a
# multi-axis tuple shards that dim over the product of those axes.
DEFAULT_RULES: dict[str, Tuple[str, ...]] = {
    "batch":    ("pod", "data"),
    "seq":      (),               # no sequence parallelism in v1
    "embed":    (),
    "vocab":    ("model",),
    "mlp":      ("model",),
    "heads":    ("model",),
    "kv_heads": ("model",),
    "head_dim": (),
    "fsdp":     ("data",),        # parameter sharding over the data axis
    "expert":   (),               # experts replicated
    # stacked-scan leading dim: __frozen__ is a sentinel consumed by
    # fit_spec — the dim must NEVER be sharded (nor host fallback axes)
    "layers":   ("__frozen__",),
    "rnn":      ("model",),
    "cache_seq": (),
    "qseq":     ("model",),       # context-parallel attention
    "rep":      (),               # EXPLICIT replication in constrain()
    "embed_tp": ("model",),       # d_model sharded over TP post-downproj
    "cache_hd": ("model",),       # KV-cache head_dim TP when kv_heads don't divide
    "exit":     (),
    # GNN side
    "nodes":    ("pod", "data"),
    "feature":  ("model",),
    "classes":  (),
    # packed serving operands: support/batch rows partitioned by CB
    # superblock over the data axis
    "row_shard": ("data",),
    # halo-exchange metadata: leading axis is the OWNING shard
    "halo_shard": ("data",),
}


class P(tuple):
    """A partition spec: one entry per dim, each None (replicated), an
    axis name, or a tuple of axis names (the dim split over their
    product, the first axis major)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def axis_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size of a `DeviceMesh` or an ``{axis: size}`` mapping,
    in the mesh's axis order."""
    if isinstance(mesh, Mapping):
        return {str(a): int(n) for a, n in mesh.items()}
    return dict(zip(mesh.axis_names, mesh.dims))


def mesh_size(mesh) -> int:
    """Number of positions of a mesh."""
    return math.prod(axis_sizes(mesh).values())


def entry_axes(entry) -> Tuple[str, ...]:
    """The axes of one spec entry (None -> ())."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def spec(*logical: Optional[str], mesh=None,
         rules: Optional[dict] = None) -> P:
    """Build a spec from logical dim names. `None` -> replicated."""
    rules = rules or DEFAULT_RULES
    mesh_axes = set(axis_sizes(mesh)) if mesh is not None else None
    out = []
    used: set[str] = set()
    for name in logical:
        if name is None:
            out.append(None)
            continue
        axes = tuple(a for a in rules.get(name, ())
                     if (mesh_axes is None or a in mesh_axes) and a not in used)
        used.update(axes)
        if len(axes) == 0:
            out.append(None)
        elif len(axes) == 1:
            out.append(axes[0])
        else:
            out.append(axes)
    return P(*out)


def resolve(spec_: Sequence, mesh) -> P:
    """Drop mesh axes a spec references that `mesh` does not have
    (including the __frozen__ sentinel)."""
    names = set(axis_sizes(mesh))
    out = []
    for entry in spec_:
        if entry is None:
            out.append(None)
        elif isinstance(entry, tuple):
            kept = tuple(a for a in entry if a in names)
            out.append(kept if len(kept) > 1 else (kept[0] if kept else None))
        else:
            out.append(entry if entry in names else None)
    return P(*out)


def axis_product(mesh, axis) -> int:
    """Size of one axis, or the product of a tuple of axes."""
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in entry_axes(axis))


def fit_spec(spec_: Sequence, shape: Sequence[int], mesh,
             fallback: bool = True) -> P:
    """Make a spec legal for `shape` on `mesh`: axes whose size does not
    divide their dim are dropped, then re-placed (leftmost-first) on any
    unsharded dim they do divide — e.g. whisper's 12 heads can't take the
    16-way model axis, so it moves to another dim. Keeps every mesh axis
    in use whenever some dim can host it; `fallback=False` only drops."""
    frozen_dims = {i for i, e in enumerate(spec_)
                   if e == "__frozen__" or (isinstance(e, tuple)
                                            and "__frozen__" in e)}
    spec_ = P(*[None if i in frozen_dims else e
                for i, e in enumerate(spec_)])
    spec_ = resolve(spec_, mesh)
    entries = list(spec_) + [None] * (len(shape) - len(spec_))
    dropped = []
    for i, (e, d) in enumerate(zip(entries, shape)):
        if e is None:
            continue
        kept = []
        for a in entry_axes(e):
            if d % (axis_product(mesh, tuple(kept)) * axis_product(mesh, a)) \
                    == 0:
                kept.append(a)
            else:
                dropped.append(a)
        entries[i] = tuple(kept) if len(kept) > 1 else (kept[0] if kept else None)
    for a in (dropped if fallback else []):
        # leftmost-first: for weight matrices this prefers the contracting
        # (input) dim -> partial sums and a small all-reduce, instead of
        # sharding head_dim, which would all-reduce the attention logits
        for i in range(len(shape)):
            if i in frozen_dims:
                continue
            if entries[i] is None and shape[i] % axis_product(mesh, a) == 0 \
                    and shape[i] > 1:
                entries[i] = a
                break
    return P(*entries)


def positions(mesh) -> Iterator[Dict[str, int]]:
    """Every mesh position's coordinates {axis: index}, row-major (the
    order of `DeviceMesh.devices`)."""
    sizes = axis_sizes(mesh)
    for idx in itertools.product(*(range(n) for n in sizes.values())):
        yield dict(zip(sizes, idx))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A fitted spec on a mesh: which block of a global shape each mesh
    position holds (`repro.sharding.named`'s `NamedSharding`)."""
    mesh: object
    spec: P

    def shard_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        """The shape of every position's block."""
        entries = list(self.spec) + [None] * (len(shape) - len(self.spec))
        out = []
        for d, e in zip(shape, entries):
            n = axis_product(self.mesh, e)
            if d % n:
                raise ValueError(f"dim {d} does not divide over {e} ({n})")
            out.append(d // n)
        return tuple(out)

    def block(self, coords: Mapping[str, int], dim: int,
              shape: Sequence[int]) -> Tuple[int, int]:
        """(start, size) of the block a position holds along `dim`."""
        e = self.spec[dim] if dim < len(self.spec) else None
        idx = 0
        for a in entry_axes(e):        # the first axis major
            idx = idx * axis_sizes(self.mesh)[a] + coords[a]
        size = shape[dim] // axis_product(self.mesh, e)
        return idx * size, size

    def index(self, coords: Mapping[str, int], shape: Sequence[int]
              ) -> Tuple[slice, ...]:
        """The slices of the global shape a position holds."""
        out = []
        for dim in range(len(shape)):
            start, size = self.block(coords, dim, shape)
            out.append(slice(start, start + size))
        return tuple(out)


def named(mesh, spec_: Sequence, shape: Optional[Sequence[int]] = None
          ) -> NamedSharding:
    if shape is not None:
        return NamedSharding(mesh, fit_spec(spec_, shape, mesh))
    return NamedSharding(mesh, resolve(spec_, mesh))


# ------------------------------------------------------------ ambient mesh
@dataclasses.dataclass
class MeshScope:
    """What `use_mesh` holds while it is entered: the mesh, and what the
    collectives of `repro_torch.sharding.placement` moved inside it,
    ``exchange[op] = {"calls", "copies", "bytes"}`` (a copy is one block
    received by one position from another)."""
    mesh: object
    exchange: Dict[str, Dict[str, int]] = dataclasses.field(
        default_factory=dict)

    def record(self, op: str, copies: int, nbytes: int) -> None:
        s = self.exchange.setdefault(op, {"calls": 0, "copies": 0,
                                          "bytes": 0})
        s["calls"] += 1
        s["copies"] += copies
        s["bytes"] += nbytes


_SCOPE: contextvars.ContextVar[Optional[MeshScope]] = contextvars.ContextVar(
    "repro_torch_mesh_scope", default=None)


@contextlib.contextmanager
def use_mesh(mesh):
    """Make `mesh` the ambient mesh (the reference's ``with mesh:``) and
    yield its `MeshScope`."""
    scope = MeshScope(mesh)
    token = _SCOPE.set(scope)
    try:
        yield scope
    finally:
        _SCOPE.reset(token)


def current_scope() -> Optional[MeshScope]:
    return _SCOPE.get()


def current_mesh():
    """The ambient mesh, or None outside `use_mesh`."""
    scope = _SCOPE.get()
    return None if scope is None else scope.mesh


def constrain(x, *logical: Optional[str]):
    """The reference's `with_sharding_constraint` by logical names,
    resolved and fitted (without fallback) against the ambient mesh; a
    no-op outside a mesh or on a mesh of one position.

    Dims that end up unsharded (logical None, or an axis the fit dropped)
    keep what `x` has there unless the name is "rep", which replicates,
    or the axis is wanted on another dim. A placed tensor
    (`placement.ShardedTensor`) is re-laid out by the collectives; a
    plain tensor is taken as the global value and placed."""
    m = current_mesh()
    if m is None or mesh_size(m) == 1:
        return x
    from repro_torch.sharding import placement
    shape = tuple(x.shape)
    s = fit_spec(spec(*logical), shape, m, fallback=False)
    names = list(logical) + [None] * (len(shape) - len(logical))
    entries = list(s) + [None] * (len(shape) - len(s))
    if isinstance(x, placement.ShardedTensor):
        wanted = {a for e in entries for a in entry_axes(e)}
        for i, (name, e) in enumerate(zip(names, entries)):
            cur = x.spec[i]
            if e is None and name != "rep" and not (
                    set(entry_axes(cur)) & wanted):
                entries[i] = cur
        return placement.relayout(x, P(*entries))
    return placement.shard(x, NamedSharding(m, P(*entries)))
