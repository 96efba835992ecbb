"""Placed tensors and their collectives: the single-controller counterpart
of what GSPMD does for the reference (no counterpart file in `repro`).

One process holds a `DeviceMesh` (`repro_torch.launch.mesh`) and, for each
placed tensor, one local tensor per mesh position (row-major, the order of
``mesh.devices``): the block of the global shape that the fitted spec
gives the position (`logical.NamedSharding`). A position's block lives on
its device and owns its memory; positions that the spec leaves replicated
hold equal copies. A mesh may repeat a device (D positions on one card or
on the CPU): the code and the exchanges are the same, so such a mesh shows
correctness and the exchanges' cost, not the capacity of D cards.

The collectives move blocks between positions by copies (`Tensor.to`, a
peer copy between cards), in a fixed order of the positions along the
axis, so that two runs give the same bits. An axis may be a tuple of
axes, the minor axes of a dim's entry (the batch's ("pod", "data") on a
multi-pod mesh): its positions go in the order the dim's blocks are laid
out, row-major over the tuple, the first axis major:

* `all_reduce_sum`: every position receives every other's partial sum
  and adds them all in f32, in axis order, rounding once to the partials'
  dtype;
* `reduce_scatter`: the same f32 sum, in the same order, of one slice of
  the partials along a dim that the axis then shards: each position
  receives its slice of what `all_reduce_sum` would give, bit for bit;
* `all_gather`: every position concatenates every position's block along
  the sharded dim;
* `all_to_all`: a mesh axis moves from one dim to another (each position
  sends the i-th slice of its block to the i-th position), as the
  attention's heads <-> head-dim re-layout needs;
* `columns_to_pairs` / `pairs_to_columns`: column blocks that split heads
  to whole (batch row, head) pairs over the same axis and back, as rwkv's
  time mix needs where its heads do not divide the axis.

Inside `use_mesh` each collective adds to the scope's `exchange` counter
the blocks it copied from one position to another and their bytes, and
runs under a ``exchange.<op>`` profiler range. Under
`launch.cost_analysis.analyze` each also counts as one op, whose result
blocks the receiving positions get (the reference's per-device
collective bytes), not as the copies and sums it runs. `relayout`
composes them; `einsum` runs a product position by position and all-reduces a
contracted dim that is sharded (Megatron's row-parallel product).

`shard_params`, `shard_cache` and `shard_inputs` place a model, a decode
cache and a batch by `param_specs` (the `ParamDef`s' logical axes),
`cache_specs` and `input_shardings`, each fitted with `fit_spec`. Where
`fit_spec` had to move an axis to a fallback dim, the layers run the
moves of `FALLBACK_DIMS` (a head count or a vocab that the axis does not
divide): "model" moved onto d, the contracting dim of the q, k and v
projections and of the head, or the embedding table's columns, where
`einsum` slices the activations' d and sums the partial products, and
the lookup all-gathers the columns; onto the head dim of `wo`, which the
attention's output is re-laid out to; onto the key dim of rwkv's state,
which its decode step updates in that layout. At a batch that the data
axes do not divide (one sequence) the inputs stay replicated over them
(`shard_inputs` never moves an axis), and the cache takes the batch's
axes elsewhere: a KV cache's sequence (split-key decode, each position
its slice of the keys) and, where the KV heads take "model", "data" on
its head dim; rwkv's state over its heads, key and value dims, its
shift states over d. Any other fallback raises `NotImplementedError`.

Training. `shard_params(..., trainable=True)` makes every position's
block a leaf that takes a gradient. The collectives are copies, slices,
concatenations and f32 adds, which autograd runs through, so the backward
pass is the derivative of the one-controller program: a block that
several positions hold (replicated over an axis its spec leaves free)
gets on each copy only the part of its gradient that the copy's own
position used. `sync_grads` adds those parts over the free axes, in f32
and in position order, rounding once (`all_reduce_sum`'s arithmetic),
so that every copy holds the logical gradient's block, bit for bit the
same on each, and `distinct` names the positions whose blocks a sum over
the logical tensor (a norm) counts once.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.device import profiled
from repro_torch.launch import cost_analysis
from repro_torch.sharding.logical import (P, NamedSharding, axis_product,
                                          axis_sizes, current_mesh,
                                          current_scope, entry_axes, fit_spec,
                                          named, positions, spec)


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedTensor:
    """A global tensor of `shape` placed on `mesh` by `spec` (fitted):
    ``locals[i]`` is mesh position i's block."""
    locals: Tuple[torch.Tensor, ...]
    spec: P
    shape: Tuple[int, ...]
    mesh: Any

    @property
    def sharding(self) -> NamedSharding:
        return NamedSharding(self.mesh, self.spec)

    @property
    def dtype(self) -> torch.dtype:
        return self.locals[0].dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def __add__(self, other: "ShardedTensor") -> "ShardedTensor":
        """Elementwise sum of two tensors placed alike (the residual)."""
        if not isinstance(other, ShardedTensor) or other.spec != self.spec:
            raise ValueError(f"adding {other!r} to {self!r}")
        return local_map(torch.add, self, other)

    def block(self, i: int, dim: int) -> Tuple[int, int]:
        """(start, size) of position i's block along `dim`."""
        return self.sharding.block(_coords(self.mesh)[i], dim, self.shape)

    def __repr__(self) -> str:
        return (f"ShardedTensor(shape={self.shape}, spec={self.spec}, "
                f"dtype={self.dtype}, {len(self.locals)} positions)")


def is_sharded(x) -> bool:
    return isinstance(x, ShardedTensor)


def _coords(mesh) -> List[Dict[str, int]]:
    return list(positions(mesh))


def _padded(spec_: Sequence, ndim: int) -> List:
    return list(spec_) + [None] * (ndim - len(spec_))


def wrap(blocks: Sequence[torch.Tensor], spec_: Sequence, mesh
         ) -> ShardedTensor:
    """A placed tensor from its positions' blocks (the global shape
    follows from the first block and the spec)."""
    entries = _padded(spec_, blocks[0].dim())
    shape = tuple(d * axis_product(mesh, e)
                  for d, e in zip(blocks[0].shape, entries))
    return ShardedTensor(tuple(blocks), P(*entries), shape, mesh)


def local_tree(tree, i: int = 0):
    """The same tree (dicts, lists, tuples) with each placed tensor
    replaced by position i's block (on a mesh of one position: the global
    tensors)."""
    if isinstance(tree, ShardedTensor):
        return tree.locals[i]
    if isinstance(tree, dict):
        return {k: local_tree(v, i) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(local_tree(v, i) for v in tree)
    return tree


def _leaves(tree):
    """The leaves of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def named_leaves(tree, prefix: str = ""):
    """(dotted path, leaf) for each leaf of nested dicts and lists, in
    order: "embed", "layers.0.attn.wq", ..."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        yield prefix, tree
        return
    for k, v in items:
        yield from named_leaves(v, f"{prefix}.{k}" if prefix else str(k))


def _first_sharded(tree) -> Optional[ShardedTensor]:
    return next((t for t in _leaves(tree) if isinstance(t, ShardedTensor)),
                None)


def local_map(fn, *args, spec: Optional[Sequence] = None) -> ShardedTensor:
    """fn(*args) position by position: each placed tensor in `args`, or in
    a dict / list of them, is replaced by the position's block, other
    arguments are passed as they are. The result is placed by `spec`
    (default: the first placed argument's)."""
    st = _first_sharded(args)
    n = len(st.locals)
    outs = [fn(*(local_tree(a, i) for a in args)) for i in range(n)]
    return wrap(outs, st.spec if spec is None else spec, st.mesh)


def local_map_n(fn, *args, specs: Sequence[Sequence]
                ) -> Tuple[ShardedTensor, ...]:
    """`local_map` of an `fn` that returns a tuple: one placed tensor per
    result, the j-th placed by ``specs[j]``."""
    st = _first_sharded(args)
    outs = [fn(*(local_tree(a, i) for a in args))
            for i in range(len(st.locals))]
    return tuple(wrap([o[j] for o in outs], s, st.mesh)
                 for j, s in enumerate(specs))


def per_position(fn, *args, spec: Optional[Sequence] = None):
    """`local_map(fn, *args, spec=spec)` where an argument is placed, else
    fn(*args): code that runs on placed and unplaced tensors alike."""
    if _first_sharded(args) is None:
        return fn(*args)
    return local_map(fn, *args, spec=spec)


# ------------------------------------------------------------ place, gather
# the tensors (by their logical axes) whose fallback layout the layers run:
# {dim: the axes that `fit_spec` may move there}. "model" onto d, the input
# dim of the q, k and v projections and of the head, and the embedding
# table's columns; onto the head dim of `wo`; onto the key dim of rwkv's
# state. At a batch that the data axes do not divide (a decode of one
# sequence) the batch's axes onto the sequence of the KV caches (split-key
# decode) and "data" onto the head dim of a cache whose KV heads take
# "model"; onto rwkv's state (its heads, key and value dims) and the d of
# its shift states. fit_spec places leftmost first, so these are the dims
# it picks.
_BATCH = ("pod", "data")
FALLBACK_DIMS = {("embed", "kv_heads", "head_dim"): {0: ("model",)},
                 ("embed", "heads", "head_dim"): {0: ("model",)},
                 ("heads", "head_dim", "embed"): {1: ("model",)},
                 ("embed", "vocab"): {0: ("model",)},
                 ("vocab", "embed"): {1: ("model",)},
                 ("batch", "heads", None, None): {
                     1: ("pod",), 2: ("model", *_BATCH),
                     3: ("model", *_BATCH)},
                 ("batch", "cache_seq", "kv_heads", None): {
                     1: _BATCH, 3: ("data",)},
                 ("batch", "cache_seq", None, "cache_hd"): {1: _BATCH},
                 ("batch", "cache_seq", None, None): {1: _BATCH},
                 ("batch", "embed"): {1: _BATCH}}


def fitted(s: P, shape: Sequence[int], mesh,
           logical: Optional[Sequence] = None) -> P:
    """`fit_spec` of `s` for `shape`. Where the fit had to move an axis to
    a fallback dim it raises, unless `logical` (the tensor's logical axes)
    is one of `FALLBACK_DIMS` and every moved axis went to a dim that
    names it there."""
    out = fit_spec(s, shape, mesh)
    plain = fit_spec(s, shape, mesh, fallback=False)
    allowed = FALLBACK_DIMS.get(tuple(logical or ()), {})
    if any(a != b and out[i] not in allowed.get(i, ())
           for i, (a, b) in enumerate(zip(out, plain))):
        raise NotImplementedError(
            f"placing shape {tuple(shape)} by {s} on mesh "
            f"{axis_sizes(mesh)} needs fit_spec's fallback ({out}); no layer "
            f"runs such a layout")
    return out


def shard(x: torch.Tensor, sharding: NamedSharding) -> ShardedTensor:
    """Place the global tensor `x`: each position receives a fresh copy of
    its block on its device."""
    mesh, shape = sharding.mesh, tuple(x.shape)
    blocks = []
    for c, dev in zip(_coords(mesh), mesh.devices):
        part = x[sharding.index(c, shape)]
        blocks.append(torch.empty(part.shape, dtype=x.dtype,
                                  device=dev).copy_(part))
    return ShardedTensor(tuple(blocks), P(*_padded(sharding.spec, x.dim())),
                         shape, mesh)


def zeros(sharding: NamedSharding, shape: Sequence[int],
          dtype: torch.dtype) -> ShardedTensor:
    """A placed tensor of zeros, allocated block by block."""
    local = sharding.shard_shape(shape)
    blocks = [torch.zeros(local, dtype=dtype, device=dev)
              for dev in sharding.mesh.devices]
    return ShardedTensor(tuple(blocks), P(*_padded(sharding.spec, len(shape))),
                         tuple(shape), sharding.mesh)


def gather(st: ShardedTensor, device=None) -> torch.Tensor:
    """The global tensor on `device` (default: the mesh's first device),
    each distinct block copied once."""
    dev = st.mesh.devices[0] if device is None else torch.device(device)
    coords = _coords(st.mesh)
    copies = nbytes = 0
    with cost_analysis.one_op():
        out = torch.empty(st.shape, dtype=st.dtype, device=dev)
        for i in distinct(st):
            out[st.sharding.index(coords[i], st.shape)] = st.locals[i].to(dev)
            if i:
                copies += 1
                nbytes += _nbytes(st.locals[i])
    _record("gather", copies, nbytes, [out] if len(st.locals) > 1 else [])
    return out


def _first_holders(st: ShardedTensor) -> List[int]:
    """For each position, the first position that holds its block."""
    first: Dict[tuple, int] = {}
    return [first.setdefault(tuple((s.start, s.stop) for s in
                                   st.sharding.index(c, st.shape)), i)
            for i, c in enumerate(_coords(st.mesh))]


def distinct(st: ShardedTensor) -> List[int]:
    """The positions that hold the distinct blocks of `st`, each block
    named once (by its first holder), in position order."""
    return [i for i, j in enumerate(_first_holders(st)) if i == j]


def copies_equal(tree) -> bool:
    """Does every copy of every block of the placed tensors in `tree` hold
    the bits of the block's first holder?"""
    return all(torch.equal(st.locals[i], st.locals[j])
               for st in _leaves(tree) if isinstance(st, ShardedTensor)
               for i, j in enumerate(_first_holders(st)) if i != j)


def as_global(x):
    """`gather(x)` for a placed tensor, x itself otherwise."""
    return gather(x) if is_sharded(x) else x


def position_bytes(tree) -> List[int]:
    """Bytes each mesh position holds of the placed tensors in `tree`."""
    placed = [t for t in _leaves(tree) if isinstance(t, ShardedTensor)]
    return [sum(_nbytes(t.locals[i]) for t in placed)
            for i in range(len(placed[0].locals))]


# ------------------------------------------------------------- collectives
def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _record(op: str, copies: int, nbytes: int,
            received: Sequence[torch.Tensor] = ()) -> None:
    """A collective's copies from one position to another and their bytes
    (the scope's `exchange`), and the result blocks its positions
    received (`cost_analysis.collective`)."""
    scope = current_scope()
    if scope is not None and copies:
        scope.record(op, copies, nbytes)
    if received:
        cost_analysis.collective(op, sum(_nbytes(t) for t in received))


@contextlib.contextmanager
def _exchange(op: str):
    """The context of a collective's copies: a profiler range while a
    profiler records (`profiled`), and one op for `cost_analysis`."""
    with profiled(f"exchange.{op}"), cost_analysis.one_op():
        yield


def _groups(mesh, axes) -> List[List[int]]:
    """The positions along `axes` (one axis name or several) for each
    value of the other axes, each group in the order of the blocks that
    the axes split a dim into: row-major over `axes`, the first major (as
    `logical.NamedSharding` lays them out; position order where `axes`
    are in the mesh's axis order)."""
    axes = entry_axes(axes)
    sizes = axis_sizes(mesh)
    groups: Dict[tuple, List[Tuple[int, int]]] = {}
    for i, c in enumerate(_coords(mesh)):
        key = tuple(v for a, v in c.items() if a not in axes)
        groups.setdefault(key, []).append((_index(c, axes, sizes), i))
    return [[i for _, i in sorted(g)] for g in groups.values()]


def _index(coords, axes, sizes) -> int:
    """A position's index along `axes`, row-major, the first axis major."""
    idx = 0
    for a in axes:
        idx = idx * sizes[a] + coords[a]
    return idx


def entry_of(axes: Sequence[str]):
    """A spec entry of `axes`: None, one axis name or a tuple."""
    axes = tuple(axes)
    return None if not axes else axes[0] if len(axes) == 1 else axes


def _dim_of(st: ShardedTensor, axes) -> Optional[int]:
    """The dim whose entry ends with `axes` (one axis or a tuple, the
    minor axes of its entry), or None where the spec uses none of them."""
    axes = entry_axes(axes)
    for dim, e in enumerate(st.spec):
        ea = entry_axes(e)
        if set(axes) & set(ea):
            if ea[len(ea) - len(axes):] != axes:
                raise NotImplementedError(
                    f"{axes} are not the minor axes of dim {dim} ({e}); the "
                    f"collectives split and join a dim's minor axes only")
            return dim
    return None


def all_reduce_sum(st: ShardedTensor, axis) -> ShardedTensor:
    """Sum the positions' blocks (partial sums) along `axis` (one axis, a
    tuple of axes, or None for none): every position adds all of them in
    f32, in axis order, and rounds once to their dtype. The spec (which
    must not use `axis`) is the result's."""
    if set(entry_axes(axis)) & {a for e in st.spec for a in entry_axes(e)}:
        raise ValueError(f"partial sums sharded over {axis} ({st.spec})")
    return _sum_over(st, entry_axes(axis), "all_reduce_sum")


def _sum_over(st: ShardedTensor, axes: Sequence[str], op: str
              ) -> ShardedTensor:
    """Every position adds the blocks of its group along `axes` in f32,
    in position order, and rounds once to their dtype; counted as `op`."""
    n = axis_product(st.mesh, axes)
    if n == 1:
        return st
    devs = st.mesh.devices
    out = [None] * len(st.locals)
    with _exchange(op):
        for group in _groups(st.mesh, axes):
            for i in group:
                acc = st.locals[group[0]].to(devs[i], torch.float32,
                                             copy=True)
                for j in group[1:]:
                    acc.add_(st.locals[j].to(devs[i]))
                out[i] = acc.to(st.dtype)
    _record(op, len(st.locals) * (n - 1),
            len(st.locals) * (n - 1) * _nbytes(st.locals[0]), out)
    return dataclasses.replace(st, locals=tuple(out))


def free_axes(st: ShardedTensor) -> Tuple[str, ...]:
    """The mesh axes that `st`'s spec leaves free (its blocks replicated
    over them), in axis order."""
    used = {a for e in st.spec for a in entry_axes(e)}
    return tuple(a for a in axis_sizes(st.mesh) if a not in used)


def sync_grads(params) -> Any:
    """The gradients of a placed tree made `trainable`, each leaf's blocks
    summed over the axes its spec leaves free (`free_axes`): the tree's
    structure with each leaf's synced gradient as a `ShardedTensor` (a
    block that took no gradient counts as zeros). Every copy of a block
    then holds the logical gradient's block, the same bits on each; a
    block that only one position holds keeps its gradient. Counted in the
    scope's exchange as "grad_sync". The blocks' `.grad` are released."""
    if isinstance(params, dict):
        return {k: sync_grads(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(sync_grads(v) for v in params)
    grads = []
    for b in params.locals:
        grads.append(torch.zeros_like(b) if b.grad is None else b.grad)
        b.grad = None
    return _sum_over(dataclasses.replace(params, locals=tuple(grads)),
                     free_axes(params), "grad_sync")


def reduce_scatter(st: ShardedTensor, axis, dim: int) -> ShardedTensor:
    """Sum the positions' blocks (partial sums) along `axis` (one axis or
    a tuple) and leave each position its slice of the sum along the
    replicated `dim`, which `axis` then shards: the position at index r
    along the axis adds the r-th slices of all the blocks in f32, in axis
    order, and rounds once to their dtype, so that its block equals that
    slice of `all_reduce_sum`'s result bit for bit, for 1/n of its
    bytes."""
    if _dim_of(st, axis) is not None or st.spec[dim] is not None:
        raise ValueError(f"reduce_scatter over {axis} to dim {dim} of "
                         f"{st.spec}")
    n = axis_product(st.mesh, axis)
    if st.shape[dim] % n:
        raise ValueError(f"dim {dim} ({st.shape[dim]}) does not divide "
                         f"over {axis} ({n})")
    entries = list(st.spec)
    entries[dim] = entry_of(entry_axes(axis))
    if n == 1:
        return wrap(st.locals, entries, st.mesh)
    out = [None] * len(st.locals)
    with _exchange("reduce_scatter"):
        for group in _groups(st.mesh, axis):
            parts = [st.locals[j].chunk(n, dim) for j in group]
            for r, i in enumerate(group):
                dev = st.mesh.devices[i]
                acc = parts[0][r].to(dev, torch.float32, copy=True)
                for p in parts[1:]:
                    acc.add_(p[r].to(dev))
                out[i] = acc.to(st.dtype)
    _record("reduce_scatter", len(st.locals) * (n - 1),
            len(st.locals) * (n - 1) * _nbytes(st.locals[0]) // n, out)
    return wrap(out, entries, st.mesh)


def all_gather(st: ShardedTensor, axis) -> ShardedTensor:
    """Undo the split that `axis` (one axis, or a tuple of the minor axes
    of a dim's entry, such as the batch's ("pod", "data")) makes of its
    dim: every position concatenates the blocks along the axes, in axis
    order (row-major over a tuple, the order the dim was split in). The
    dim keeps the rest of its entry."""
    dim = _dim_of(st, axis)
    if dim is None:
        return st
    axes = entry_axes(axis)
    n = axis_product(st.mesh, axes)
    entries = list(st.spec)
    entries[dim] = entry_of(entry_axes(st.spec[dim])[:-len(axes)])
    if n == 1:
        return wrap(st.locals, entries, st.mesh)
    out = [None] * len(st.locals)
    with _exchange("all_gather"):
        for group in _groups(st.mesh, axes):
            for i in group:
                dev = st.mesh.devices[i]
                out[i] = torch.cat([st.locals[j].to(dev) for j in group],
                                   dim)
    _record("all_gather", len(st.locals) * (n - 1),
            len(st.locals) * (n - 1) * _nbytes(st.locals[0]), out)
    return wrap(out, entries, st.mesh)


def all_to_all(st: ShardedTensor, axis: str, to_dim: int) -> ShardedTensor:
    """Move `axis` from the dim it shards (as that dim's minor axis) to
    `to_dim`, where it becomes the minor axis: the position at index r
    along the axis receives the r-th slice (along `to_dim`) of every
    position's block, concatenated in axis order along the old dim."""
    dim = _dim_of(st, axis)
    n = axis_sizes(st.mesh)[axis]
    if dim is None or dim == to_dim:
        raise ValueError(f"all_to_all of {axis} to dim {to_dim} from "
                         f"{st.spec}")
    if st.locals[0].shape[to_dim] % n:
        raise ValueError(f"dim {to_dim} ({st.shape[to_dim]}) does not "
                         f"divide over {axis} ({n})")
    entries = list(st.spec)
    entries[dim] = entry_of(entry_axes(st.spec[dim])[:-1])
    entries[to_dim] = entry_of(entry_axes(st.spec[to_dim]) + (axis,))
    if n == 1:
        return wrap(st.locals, entries, st.mesh)
    out = [None] * len(st.locals)
    with _exchange("all_to_all"):
        for group in _groups(st.mesh, axis):
            parts = [st.locals[j].chunk(n, to_dim) for j in group]
            for r, i in enumerate(group):
                dev = st.mesh.devices[i]
                out[i] = torch.cat([p[r].to(dev) for p in parts], dim)
    _record("all_to_all", len(st.locals) * (n - 1),
            len(st.locals) * (n - 1) * _nbytes(st.locals[0]) // n, out)
    return wrap(out, entries, st.mesh)


def columns_to_pairs(st: ShardedTensor, width: int) -> ShardedTensor:
    """`st` (B, T, H * width) placed (batch entry, None, axis), its columns
    split over the axis in blocks that need not hold whole groups of
    `width` (heads), re-laid out as (batch row, head) pairs: in each group
    of positions along the axis, pair b * H + h of its B_l * H is head h
    of its batch row b, and position r of the group receives pairs r * m
    to r * m + m - 1 (m = ceil(B_l * H / n); the last position's missing
    pairs are zeros), each whole: a tensor (G, n * m, T, width) placed
    (batch entry, axis, None, None), G the batch's shards. Each position
    receives from each holder of its heads' columns one slice a batch
    row; counted as "columns_to_pairs"."""
    axis = st.spec[2]
    n = axis_sizes(st.mesh)[axis]
    B_l, T, c = st.locals[0].shape
    H = st.shape[2] // width
    P_ = B_l * H
    m = -(-P_ // n)
    out = [None] * len(st.locals)
    copies = nbytes = 0
    with _exchange("columns_to_pairs"):
        for group in _groups(st.mesh, axis):
            for r, i in enumerate(group):
                dev = st.mesh.devices[i]
                parts, p = [], r * m
                while p < min(r * m + m, P_):
                    b, h0 = divmod(p, H)
                    h1 = min(H, h0 + min(r * m + m, P_) - p)
                    lo, hi = h0 * width, h1 * width
                    cols = []
                    for j in range(lo // c, (hi - 1) // c + 1):
                        piece = st.locals[group[j]][
                            b, :, max(lo, j * c) - j * c:min(hi, j * c + c)
                            - j * c]
                        if group[j] != i:
                            copies += 1
                            nbytes += _nbytes(piece)
                        cols.append(piece.to(dev))
                    parts.append(torch.cat(cols, -1).reshape(
                        T, h1 - h0, width).transpose(0, 1))
                    p += h1 - h0
                blk = torch.cat(parts) if parts else st.locals[i].new_zeros(
                    (0, T, width))
                out[i] = torch.nn.functional.pad(
                    blk, (0, 0, 0, 0, 0, m - blk.shape[0]))[None].contiguous()
    _record("columns_to_pairs", copies, nbytes, out)
    return wrap(out, (st.spec[0], axis, None, None), st.mesh)


def pairs_to_columns(pt: ShardedTensor, like: ShardedTensor) -> ShardedTensor:
    """The inverse of `columns_to_pairs`: pairs `pt` (G, n * m, T, width)
    back to the column blocks of `like` (B, T, H * width), placed as
    `like` is (the pairs' T, any dtype); counted as "pairs_to_columns"."""
    axis = pt.spec[1]
    B_l, _, c = like.locals[0].shape
    m, T, width = pt.locals[0].shape[1:]
    H = like.shape[2] // width
    out = [None] * len(pt.locals)
    copies = nbytes = 0
    with _exchange("pairs_to_columns"):
        for group in _groups(pt.mesh, axis):
            for r, i in enumerate(group):
                dev = pt.mesh.devices[i]
                h0, h1 = r * c // width, (r * c + c - 1) // width + 1
                rows = []
                for b in range(B_l):
                    pieces, p = [], b * H + h0
                    while p < b * H + h1:
                        j, q0 = divmod(p, m)
                        k = min(b * H + h1 - p, m - q0)
                        piece = pt.locals[group[j]][0, q0:q0 + k]
                        if group[j] != i:
                            copies += 1
                            nbytes += _nbytes(piece)
                        pieces.append(piece.to(dev))
                        p += k
                    cols = torch.cat(pieces).transpose(0, 1).reshape(
                        T, (h1 - h0) * width)
                    off = r * c - h0 * width
                    rows.append(cols[:, off:off + c])
                out[i] = torch.stack(rows)
    _record("pairs_to_columns", copies, nbytes, out)
    return wrap(out, like.spec, like.mesh)


def _split(st: ShardedTensor, axes, dim: int) -> ShardedTensor:
    """Split `dim` further over `axes` (one axis or a tuple), which join
    its entry as its minor axes: each position keeps (a copy of) its slice
    of its block; nothing crosses between positions."""
    axes = entry_axes(axes)
    sizes = axis_sizes(st.mesh)
    n = axis_product(st.mesh, axes)
    if st.locals[0].shape[dim] % n:
        raise ValueError(f"dim {dim} ({st.shape[dim]}) does not divide "
                         f"over {axes} ({n})")
    entries = list(st.spec)
    entries[dim] = entry_of(entry_axes(st.spec[dim]) + axes)
    if n == 1:
        return wrap(st.locals, entries, st.mesh)
    size = st.locals[0].shape[dim] // n
    out = [b.narrow(dim, _index(c, axes, sizes) * size, size).clone()
           for b, c in zip(st.locals, _coords(st.mesh))]
    return wrap(out, entries, st.mesh)


def relayout(st: ShardedTensor, target: Sequence) -> ShardedTensor:
    """Re-lay `st` out by `target`, axis by axis. Each dim keeps the
    longest prefix of its entry that its target entry shares; its other
    axes leave from the minor end: those that no target dim takes are
    all-gathered (a run of them at once, the batch's ("pod", "data") in
    one gather), one that the next free place of another dim's target
    takes goes there all-to-all; last, the axes that a dim's target adds
    to what it holds are sliced in place."""
    target = _padded(target, st.ndim)
    if list(st.spec) == target:
        return st
    dst = [entry_axes(e) for e in target]
    where = {a: d for d, t in enumerate(dst) for a in t}

    def extra(d):
        s, t = entry_axes(st.spec[d]), dst[d]
        k = 0
        while k < min(len(s), len(t)) and s[k] == t[k]:
            k += 1
        return s[k:]
    for d in range(st.ndim):                      # leave
        run = ()
        for a in reversed(extra(d)):
            if a in where:
                break
            run = (a,) + run
        if run:
            st = all_gather(st, run)
    moved = True
    while moved:                                  # move
        moved = False
        for d in range(st.ndim):
            if not extra(d):
                continue
            a = extra(d)[-1]
            to = where.get(a)
            if to is not None and to != d and entry_axes(st.spec[to]) == \
                    dst[to][:dst[to].index(a)]:
                st = all_to_all(st, a, to)
            else:
                st = all_gather(st, a)
            moved = True
    for d in range(st.ndim):                      # arrive
        add = dst[d][len(entry_axes(st.spec[d])):]
        if add:
            st = _split(st, add, d)
    return st


def einsum(eq: str, a: ShardedTensor, b: ShardedTensor,
           scatter_dim: Optional[int] = None) -> ShardedTensor:
    """`torch.einsum(eq, a, b)` on placed operands, position by position.
    A letter sharded in one operand and replicated in the other is sliced
    there; an output letter keeps its axis; a contracted letter that is
    sharded leaves partial sums, which `all_reduce_sum` adds, or, with
    `scatter_dim`, `reduce_scatter` adds into slices of that output dim
    (the same bits as the all-reduce's slice)."""
    ins, out = eq.split("->")
    la, lb = ins.split(",")
    ea = dict(zip(la, _padded(a.spec, len(la))))
    eb = dict(zip(lb, _padded(b.spec, len(lb))))
    for k in set(la) & set(lb):
        if ea[k] is not None and eb[k] is not None and ea[k] != eb[k]:
            raise ValueError(f"einsum {eq}: letter {k} on {ea[k]} and "
                             f"{eb[k]}; re-lay one operand out first")
    a = relayout(a, [ea[k] if ea[k] is not None else eb.get(k) for k in la])
    b = relayout(b, [eb[k] if eb[k] is not None else ea.get(k) for k in lb])
    ea, eb = dict(zip(la, a.spec)), dict(zip(lb, b.spec))
    entries = [ea.get(k) if ea.get(k) is not None else eb.get(k)
               for k in out]
    res = local_map(lambda x, y: torch.einsum(eq, x, y), a, b, spec=entries)
    partial = {ax for k in (set(la) | set(lb)) - set(out)
               for ax in entry_axes(ea.get(k) or eb.get(k))}
    for ax in sorted(partial):
        res = (all_reduce_sum(res, ax) if scatter_dim is None
               else reduce_scatter(res, ax, scatter_dim))
    return res


# ------------------------------------------------------------- placements
def abstract_placed(tree, specs, mesh):
    """`meta` tensors of each position's block of the tensors in `tree`
    (real or `meta`), placed by the matching `specs` on `mesh` (a
    `DeviceMesh` or an {axis: size} mapping) as `named` fits them: what
    a placement would hold per position, with nothing allocated."""
    if isinstance(tree, dict):
        return {k: abstract_placed(tree[k], specs[k], mesh) for k in tree}
    if isinstance(tree, (list, tuple)):
        return [abstract_placed(t, s, mesh) for t, s in zip(tree, specs)]
    return torch.empty(named(mesh, specs, tree.shape).shard_shape(tree.shape),
                       dtype=tree.dtype, device="meta")


def _place_group(group, mesh, trainable: bool) -> dict:
    """A `ParamGroup` as a dict of placed tensors, each by its
    `ParamDef`'s logical axes; with `trainable` each block a leaf that
    requires grad."""
    out = {}
    for name, d in group.defs.items():
        t = group[name]
        if isinstance(t, torch.nn.Module):
            out[name] = _place_group(t, mesh, trainable)
            continue
        st = shard(t.detach(), NamedSharding(
            mesh, fitted(spec(*d.logical), t.shape, mesh, d.logical)))
        for b in st.locals:
            b.requires_grad_(trainable)
        out[name] = st
    return out


def shard_params(model, mesh, release: bool = False,
                 trainable: bool = False) -> dict:
    """A `DecoderLM`'s parameters placed on `mesh`: a dict of its top
    entries ("embed", "final_norm", "lm_head", ...) and of "layers" /
    "encoder" lists of per-layer dicts, every leaf a `ShardedTensor`
    placed by its `ParamDef`'s logical axes (the leaf's entry of
    `decoder_lm.param_specs`) fitted to the mesh. Every position gets its
    own copy of its blocks. By default the model is left as it was, for a
    caller that places it again on another mesh or runs it unplaced beside
    its placement; with `release` it is emptied group by group as each is
    placed, so that the model and one layer's blocks are held at once, not
    the model twice (a model that fills most of a device). With
    `trainable` every block is a leaf that requires grad, for `loss_fn`'s
    backward pass and `sync_grads`."""
    def place(group):
        out = _place_group(group, mesh, trainable)
        if release:
            for t in group.parameters():
                t.data = t.data.new_empty(0)
        return out

    tree = place(model.top)
    tree["layers"] = [place(g) for g in model.layers]
    tree["encoder"] = [place(g) for g in model.encoder]
    return tree


def shard_cache(cfg, cache: Sequence[dict], mesh) -> List[dict]:
    """A decode cache (`decoder_lm.init_cache`'s list of per-layer dicts)
    placed by `decoder_lm.cache_specs` (`decoder_lm.fit_cache`)."""
    from repro_torch.models.decoder_lm import fit_cache
    return [{n: shard(t, NamedSharding(mesh, fit_cache(cfg, n, t.shape,
                                                       mesh)))
             for n, t in c.items()} for c in cache]


def shard_inputs(cfg, batch: Dict[str, torch.Tensor], mesh
                 ) -> Dict[str, ShardedTensor]:
    """Model inputs ({"tokens", "frontend"?}) placed by
    `configs.input_shardings`: the batch split over the data axes that
    divide it and replicated over the others (a batch of one sequence
    replicated over all), never moved to another dim."""
    from repro_torch.configs import input_shardings
    specs = input_shardings(cfg)
    return {k: (v if is_sharded(v) else shard(v, NamedSharding(
        mesh, fit_spec(specs[k], v.shape, mesh, fallback=False))))
        for k, v in batch.items()}


def placed_mesh(params):
    """The mesh a placed parameter tree lives on (None for a module),
    checked against the ambient `use_mesh`."""
    st = _first_sharded(params) if isinstance(params, dict) else None
    if st is None:
        return None
    if current_mesh() != st.mesh:
        raise ValueError("a placed model runs inside use_mesh(its mesh); "
                         f"the ambient mesh is {current_mesh()}")
    return st.mesh
