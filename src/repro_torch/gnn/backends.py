"""Propagation backends: one interface over every SpMM implementation.

The port of `repro.gnn.backends`. Every implementation is a
`PropagationBackend` registered in `BACKENDS`, and `run_propagation` runs
the ONE masked NAP loop over it, on one device or over the shards of a
mesh:

* ``step(ops, x, node_active, active_rb, ts2, ...)`` — one NAP
  propagation step: the propagated rows plus the per-batch-node exit
  flags. The exit arithmetic is squared-f32 distance vs the squared
  threshold (negative threshold = exits disabled this step). The tile
  backends also carry the non-finite flags of x from step to step
  (`repro_torch.kernels.spmm.nonfinite_blocks`: one pass over x0 per
  batch, then each kernel writes them for its output), so that their
  zero-skipping kernels propagate a NaN or Inf as the dense product does.

Backends:

* ``segment`` — plain PyTorch: a gather of the edge sources and an
  ``index_add_`` into the destinations, then the distance in PyTorch. On
  CUDA ``index_add_`` adds with atomics in an order that changes from run
  to run, so its floats are not bit-reproducible: its exit orders are held
  to the kernel backends and the host path only outside a margin around
  the threshold (tests/test_torch_engine*.py, chip_smoke.py).
* ``block_ell`` — the block-ELL SpMM kernel (B1), then the exit-decision
  kernel (B3) over the batch rows against the dense ``x_inf``: the
  two-launch composition.
* ``fused`` — the fused NAP step kernel (B2): SpMM, distance (x_inf
  rebuilt from its rank-1 factors) and exit flags in one launch.

``block_ell`` and ``fused`` compute bitwise equal propagated rows and
distances (csrc/block_ell.cuh), so their exit orders are identical on the
card. On CPU tensors the kernels' plain versions run instead.

Propagated-feature cache: a pack made with ``seeds=`` carries
``seed_rows`` / ``seed_vals``; after every step the loop writes
``seed_vals[l-1]`` over the cache-hit rows (``index_copy_``, pad ids
dropped), so the next step reads their exact propagated values. The
backends never see these operands.

The loop keeps every per-step decision on the device: the live flag and
the row-block predicate ``step_active[l-1] * live`` are device tensors
handed to the kernels, and the threshold gating depends only on the host
step index, so no step synchronises with the host and a pipelined engine
keeps the card busy while it packs the next batch.

Sharded execution (``mesh=`` with a ``data`` axis of D > 1 devices,
`repro_torch.launch.mesh`): one process drives every shard. Operands come
from ``pack_support(n_shards=D)``, whose shard-major row order makes the
d-th 1/D of every row-split operand shard d's (`OPERAND_SPLIT` says how
each operand splits; `shard_operands` places the slices). Each step, every
shard's x is rebuilt from the shards' rows by the frontier exchange
(``gather_mode``):

* ``dense`` — every shard's rows concatenated (global coordinates);
  operands packed without halo metadata;
* ``halo`` — the same, then a static block gather into the shard's halo
  frame (``pack_support(halo=True)``: frame-local tile_col/src), so the
  kernels read H_pad·CB rows instead of S_pad;
* ``alltoall`` — each shard sends exactly the blocks its peers' frames
  reference (one B_pad slice per receiver) and each receiver indexes its
  frame out of what it got, so only halo blocks cross between shards.

Then each shard launches its backend's step on its own tiles and that x,
decides exits for its own batch rows and, at the end, classifies them.
The live flag is each shard's ``any`` gathered on the first device and
sent back: device tensors throughout, so sharding adds no host sync. The
non-finite flags travel with x through the same block indices (cheaper
than rescanning each frame), so a NaN in a row another shard reads reaches
that shard's kernels. Because the packer moves whole CB superblocks and
keeps every tile's slot, sharded propagation equals single-device bit for
bit on ``block_ell`` and ``fused`` (and on ``segment`` on the CPU);
results come back in the packed batch order, gathered on the mesh's first
device. A mesh may repeat a device (D shards on one card): the copies
between shards are then device-to-device copies on that card.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import profiled, resolve_device
from repro_torch.kernels.nap_exit import nap_exit
from repro_torch.kernels.nap_step import nap_step_fused
from repro_torch.kernels.spmm import (CB, RB, nonfinite_blocks, spmm_block_ell,
                                      zero_flags)

BACKENDS: Dict[str, "PropagationBackend"] = {}

GATHER_MODES = ("dense", "halo", "alltoall")

# the halo metadata of a pack_support(halo=True) pack that travels to the
# device (halo_count stays on the host)
HALO_KEYS = ("halo_src_shard", "halo_src_block", "halo_send_block",
             "halo_frame_src")

# how each operand of a pack_support(n_shards=D) pack splits over the D
# shards (the JAX package's operand_logical / HALO_LOGICAL / SEED_LOGICAL):
# "rows" = the d-th 1/D of axis 0, "rows_axis1" = of axis 1, "stacked" =
# index d of the leading shard axis, "replicated" = whole on every shard
OPERAND_SPLIT: Dict[str, str] = {
    **dict.fromkeys(("tiles", "tile_col", "valid", "x0", "x_inf", "c_inf"),
                    "rows"),
    "step_active": "rows_axis1",
    **dict.fromkeys(("src", "dst", "coef", *HALO_KEYS, "seed_rows",
                     "seed_vals"), "stacked"),
    "s_inf": "replicated",
}


def register_backend(cls):
    """Class decorator: instantiate and register under ``cls.name``."""
    BACKENDS[cls.name] = cls()
    return cls


def get_backend(name: str) -> "PropagationBackend":
    if name not in BACKENDS:
        raise ValueError(f"unknown spmm_impl {name!r} "
                         f"(registered: {sorted(BACKENDS)})")
    return BACKENDS[name]


def _distance_exits(out, x_inf, ts2: float, n_batch: int):
    """Squared-f32 exit decision over the batch region in PyTorch (ts2 < 0
    disables exits, since d2 >= 0 always)."""
    d2 = ((out[:n_batch] - x_inf) ** 2).sum(dim=1)
    return d2 < ts2


class PropagationBackend:
    """One NAP propagation step behind a uniform contract.

    * ``uses_tiles`` — consumes block-ELL operands (``tiles``,
      ``tile_col``, ``valid``) plus the static ``step_active`` row-block
      predicate; the packer must build tiles.
    * ``uses_edges`` — consumes the bucket-padded edge list
      (``src``/``dst``/``coef``); the packer must build edges.
    * ``uses_factors`` — consumes the rank-1 stationary-state factors
      (``c_inf``/``s_inf``) instead of a dense ``x_inf``.
    * ``uses_dense_x_inf`` — the exit distance is taken against the dense
      ``x_inf`` operand.
    """
    name: str = ""
    uses_tiles = False
    uses_edges = False
    uses_factors = False
    uses_dense_x_inf = True

    def validate(self, operands: dict, x0, n_batch: int) -> None:
        """Raise ValueError on operand-contract violations (cheap, static
        shape checks only)."""

    def step(self, ops: dict, x, node_active, active_rb, ts2: float, *,
             n_batch: int, n_rows: int, x_bad=None
             ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
        """One propagation + exit-decision step. ``node_active`` (n_batch,)
        int32 not-yet-exited flags; ``active_rb`` the (n_rb,) int32
        row-block predicate (None for backends without tiles); ``ts2`` the
        squared threshold; ``x_bad`` the non-finite flags of x (tile
        backends). Returns ``(x_out (n_rows, f), exits (n_batch,) bool,
        flags of x_out or None)``."""
        raise NotImplementedError


@register_backend
class SegmentBackend(PropagationBackend):
    """Gather + ``index_add_`` over the edge list; every row updated every
    step (no tile predication)."""
    name = "segment"
    uses_edges = True

    def step(self, ops, x, node_active, active_rb, ts2, *, n_batch,
             n_rows, x_bad=None):
        contrib = ops["coef"][:, None] * x[ops["src"]]
        out = torch.zeros((n_rows, x.shape[1]), dtype=x.dtype,
                          device=x.device)
        out.index_add_(0, ops["dst"], contrib)
        return out, _distance_exits(out, ops["x_inf"], ts2, n_batch), None


@register_backend
class BlockEllBackend(PropagationBackend):
    """Block-ELL SpMM kernel, then the exit-decision kernel on the batch
    rows (two launches; the propagated rows round-trip device memory)."""
    name = "block_ell"
    uses_tiles = True

    def step(self, ops, x, node_active, active_rb, ts2, *, n_batch,
             n_rows, x_bad=None):
        out_bad = zero_flags(ops["tile_col"].shape[0] * RB, x.shape[1],
                              x.device)
        out = spmm_block_ell(ops["tiles"], ops["tile_col"], ops["valid"],
                             active_rb, x, x_bad=x_bad, out_bad=out_bad)
        _, exits, _ = nap_exit(out[:n_batch], ops["x_inf"],
                               node_active[:, None], ts2)
        return out, exits[:, 0] != 0, out_bad


@register_backend
class FusedBackend(PropagationBackend):
    """Fused NAP step kernel: SpMM, exit distance (x_inf rebuilt from the
    rank-1 factors in registers) and exit flags in one launch."""
    name = "fused"
    uses_tiles = True
    uses_factors = True
    uses_dense_x_inf = False

    def validate(self, operands, x0, n_batch):
        S, f = x0.shape
        if n_batch % RB or S % CB:
            raise ValueError(
                f"fused path needs packed operands: n_batch {n_batch} "
                f"% RB, rows {S} % CB must be 0 (see repro_torch.gnn."
                f"packing)")
        if "c_inf" not in operands or "s_inf" not in operands:
            raise ValueError("fused path needs x_inf_factors=(c, s), the "
                             "rank-1 stationary-state factors")
        c = operands["c_inf"].reshape(-1)
        s = operands["s_inf"].reshape(-1)
        if c.shape[0] != n_batch or s.shape[0] != f:
            raise ValueError(f"fused path needs factors padded to "
                             f"({n_batch},) and ({f},), got "
                             f"{tuple(c.shape)} {tuple(s.shape)}")

    def step(self, ops, x, node_active, active_rb, ts2, *, n_batch,
             n_rows, x_bad=None):
        out_bad = zero_flags(ops["tile_col"].shape[0] * RB, x.shape[1],
                              x.device)
        out, exits, _blk_still = nap_step_fused(
            ops["tiles"], ops["tile_col"], ops["valid"], active_rb, x,
            ops["c_inf"], ops["s_inf"], node_active[:, None], ts2,
            x_bad=x_bad, out_bad=out_bad)
        # any(blk_still) == any(node_active & ~exits): the loop recovers
        # the live flag from exit_order, so blk_still is not threaded out
        return out, exits[:, 0] != 0, out_bad


def pack_operands(backend: PropagationBackend, packed,
                  step_active=None) -> dict:
    """Host-side operand dict (numpy) for a `PackedSupport`, keyed as the
    backend consumes it, plus the halo metadata of a halo pack and the
    cache seeds of a ``seeds=`` pack (the dense ``x_inf`` travels as its
    own argument through `make_compiled_infer`)."""
    ops = {}
    if backend.uses_tiles:
        if step_active is None:
            raise ValueError(f"{backend.name} needs the step_active "
                             f"row-block predicate")
        ops.update(tiles=packed.tiles, tile_col=packed.tile_col,
                   valid=packed.valid, step_active=step_active)
    if backend.uses_edges:
        ops.update(src=packed.src, dst=packed.dst, coef=packed.coef)
    if backend.uses_factors:
        ops.update(c_inf=packed.c_inf, s_inf=packed.s_inf)
    if packed.halo_src_shard is not None:
        ops.update({k: getattr(packed, k) for k in HALO_KEYS})
    if packed.seed_rows is not None:
        ops.update(seed_rows=packed.seed_rows, seed_vals=packed.seed_vals)
    return ops


def _as_tensor(a, device: torch.device) -> torch.Tensor:
    """numpy or tensor -> contiguous tensor on `device` (no copy when it
    already lies there)."""
    t = torch.from_numpy(a) if isinstance(a, np.ndarray) else a
    return t.to(device).contiguous()


def _index_operands(ops: dict) -> dict:
    """The index operands as int64 (what PyTorch's gathers take)."""
    for k in ("src", "dst", "seed_rows"):
        if k in ops:
            ops[k] = ops[k].long()
    return ops


# ------------------------------------------------------------ sharding
def normalize_mesh(mesh):
    """The one degenerate-mesh policy of every sharded entry point: None
    stays None, a mesh must name a ``data`` axis, and a data axis of size
    1 collapses to None — the plain single-device path, with no CB*D
    batch padding."""
    if mesh is None:
        return None
    if "data" not in mesh.axis_names:
        raise ValueError(f"sharded propagation needs a 'data' mesh axis, "
                         f"got {mesh.axis_names}")
    if any(n > 1 for a, n in mesh.shape.items() if a != "data"):
        raise ValueError(f"sharded propagation splits rows over 'data' "
                         f"only; got mesh shape {mesh.shape}")
    return mesh if int(mesh.shape["data"]) > 1 else None


def _same_device(a: torch.device, b: torch.device) -> bool:
    def full(d):
        if d.type == "cuda" and d.index is None:
            return torch.device("cuda", torch.cuda.current_device())
        return d
    return full(a) == full(b)


def mesh_devices(mesh, device=None) -> Tuple[torch.device, ...]:
    """The devices the loop runs on: the mesh's, shard by shard, or one
    device — `device`, else a one-device mesh's, else ``"cuda"``. A
    `device` given beside a sharded mesh must be the mesh's first device,
    where results are gathered."""
    sharded = normalize_mesh(mesh)
    if sharded is None:
        if device is None:
            device = "cuda" if mesh is None else mesh.devices[0]
        return (resolve_device(device),)
    devs = tuple(mesh.devices)
    if device is not None and not _same_device(resolve_device(device),
                                               devs[0]):
        raise ValueError(f"device {device} is not the mesh's first device "
                         f"{devs[0]}, where results are gathered")
    return devs


def shard_operands(operands: dict, devices: Sequence[torch.device], *,
                   non_blocking: bool = False) -> List[dict]:
    """Split a full operand dict (numpy arrays or tensors, in the packed
    shard-major order of ``pack_support(n_shards=D)``) into D per-shard
    dicts, each placed on its shard's device as `OPERAND_SPLIT` says.
    The slices of a pinned host tensor are pinned, so with
    ``non_blocking=True`` their copies do not wait for the host."""
    D = len(devices)
    shards: List[dict] = [{} for _ in range(D)]
    for k, v in operands.items():
        how = OPERAND_SPLIT.get(k)
        if how is None:
            raise ValueError(f"no sharding rule for operand {k!r}")
        t = torch.from_numpy(v) if isinstance(v, np.ndarray) else v
        axis = 1 if how == "rows_axis1" else 0
        if how in ("rows", "rows_axis1") and t.shape[axis] % D:
            raise ValueError(f"operand {k!r} {tuple(t.shape)}: axis {axis} "
                             f"does not split over {D} shards")
        if how == "stacked" and t.shape[0] != D:
            raise ValueError(f"operand {k!r} {tuple(t.shape)} is not "
                             f"stacked over {D} shards")
        for d, dev in enumerate(devices):
            if how == "rows":
                n = t.shape[0] // D
                part = t[d * n:(d + 1) * n]
            elif how == "rows_axis1":
                n = t.shape[1] // D
                part = t[:, d * n:(d + 1) * n]
            elif how == "stacked":
                part = t[d]
            else:
                part = t
            shards[d][k] = part.to(dev, non_blocking=non_blocking
                                   ).contiguous()
    return shards


def split_rows(a, devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """A row-split array (x, exit orders; packed order) as D per-shard
    tensors on their devices."""
    return [s["x0"] for s in shard_operands({"x0": a}, devices)]


def _on_each(ts: Sequence[torch.Tensor], devices,
             dim: int = 0) -> List[torch.Tensor]:
    """The concatenation of `ts` along `dim` (the dense frontier, or its
    flags) as each shard's device receives it, in shard order. Shards
    that share a device share the copy."""
    made: Dict[torch.device, torch.Tensor] = {}
    out = []
    for dev in devices:
        if dev not in made:
            # a cross-device `.to` is PyTorch's peer copy, which puts a
            # two-way event barrier between both devices' current streams;
            # a copy moved to a side stream would need its own event
            made[dev] = torch.cat([t.to(dev) for t in ts], dim=dim)
        out.append(made[dev])
    return out


class _Exchange:
    """The per-step frontier exchange of a sharded loop: from each shard's
    own rows ``xs[d]`` (rows_loc, f) and their non-finite flags
    ``bads[d]`` (n_slabs, rows_loc/CB), the x each shard's step reads and
    that x's flags. The flags go through the same block indices as x (one
    byte per CB rows and slab), so a NaN or Inf in a row that another
    shard reads reaches that shard's kernel flags without a rescan.

    * ``dense``: every shard's rows concatenated on each device (global
      packed coordinates).
    * ``halo``: the same, then a static block gather by
      ``halo_src_shard * n_cb_loc + halo_src_block`` into the shard's
      frame.
    * ``alltoall``: shard d sends ``x_d`` blocks ``halo_send_block[d]``
      (D slices of B_pad blocks, one per receiver); shard i concatenates
      the i-th slice of every sender, in sender order, and indexes it
      with ``halo_frame_src[i]``. Only halo blocks cross between shards.

    Between devices the blocks move by ``.to``, PyTorch's peer copy, which
    orders itself against both devices' current streams (see `_on_each`).
    """

    def __init__(self, mode: str, halo: Sequence[dict],
                 devices: Sequence[torch.device], rows_loc: int):
        self.mode, self.devices = mode, tuple(devices)
        self.n_cb_loc = rows_loc // CB
        if mode == "halo":
            self.gblock = [(h["halo_src_shard"].long() * self.n_cb_loc
                            + h["halo_src_block"].long()) for h in halo]
        elif mode == "alltoall":
            self.send = [h["halo_send_block"].long().reshape(-1)
                         for h in halo]
            self.b_pad = halo[0]["halo_send_block"].shape[-1]
            self.frame_src = [h["halo_frame_src"].long() for h in halo]

    def __call__(self, xs, bads):
        f = xs[0].shape[1]
        if self.mode == "alltoall":
            B = self.b_pad
            sends = [x.view(self.n_cb_loc, CB, f)[i]
                     for x, i in zip(xs, self.send)]
            frames = []
            for i, dev in enumerate(self.devices):
                recv = torch.cat([s[i * B:(i + 1) * B].to(dev)
                                  for s in sends])
                frames.append(recv[self.frame_src[i]].view(-1, f))
            if bads is None:
                return frames, None
            sb = [b[:, i] for b, i in zip(bads, self.send)]
            fbads = [torch.cat([s[:, i * B:(i + 1) * B].to(dev)
                                for s in sb], dim=1)[:, self.frame_src[i]]
                     for i, dev in enumerate(self.devices)]
            return frames, fbads
        full = _on_each(xs, self.devices)
        fbad = None if bads is None else _on_each(bads, self.devices, 1)
        if self.mode == "dense":
            return full, fbad
        frames = [x.view(-1, CB, f)[g].view(-1, f)
                  for x, g in zip(full, self.gblock)]
        if fbad is None:
            return frames, None
        return frames, [b[:, g] for b, g in zip(fbad, self.gblock)]


def exchange_bytes_per_step(mode: str, n_shards: int, n_pad: int, f: int,
                            halo_send_pad: int = 0) -> int:
    """f32 bytes that cross between shards in one step of a pack with
    n_pad rows and f features: every other shard's rows for ``dense`` and
    ``halo`` (the frontier is gathered whole), the padded send lists for
    ``alltoall``."""
    if mode == "alltoall":
        return n_shards * (n_shards - 1) * halo_send_pad * CB * f * 4
    return (n_shards - 1) * n_pad * f * 4


def _any_live(flags: Sequence[torch.Tensor], devices) -> List[torch.Tensor]:
    """The live flag of the whole batch, on every shard's device: each
    shard's ``any`` gathered on the first device, reduced there and sent
    back — device tensors throughout, so no step waits for the host."""
    if len(flags) == 1:
        return [flags[0].to(torch.int32)]
    tot = torch.stack([f.to(devices[0]) for f in flags]).any().to(
        torch.int32)
    return [tot.to(d) for d in devices]


# ------------------------------------------------------------ the loop
def _masked_loop(backend, nai, shard_ops, x0s, nb_loc, rows_loc, exchange):
    """The ONE masked NAP loop, over D >= 1 shards: ``shard_ops[d]`` /
    ``x0s[d]`` are shard d's operands and rows on its device, ``exchange``
    builds each step's x (None: one shard, which reads its own x). Each
    shard carries ``x (rows_loc, f)``, ``series (T_max+1, nb_loc, f)``,
    ``exit_order (nb_loc,)`` and the batch's ``live`` flag (a 0-dim int32
    device tensor); the shards' steps are launched one after the other
    from this thread. Exit orders of 0 after the loop mean never-exited
    and collapse to T_max. All T_max steps run, as the reference's
    fori_loop does; once the batch has exited, ``live`` zeroes the
    row-block predicate and the kernels skip every tile. Returns
    per-shard lists of exit orders and series."""
    tmax = nai.t_max
    ts2_on = float(np.float32(nai.t_s) ** 2)
    devs = [x.device for x in x0s]
    D = len(x0s)
    sas = [ops.get("step_active") for ops in shard_ops]
    seeds = []
    for ops in shard_ops:
        seed_rows = ops.pop("seed_rows", None)
        seed_vals = ops.pop("seed_vals", None)
        if seed_rows is not None:
            if seed_vals.shape[0] < tmax:
                raise ValueError(f"seed_vals covers {seed_vals.shape[0]} "
                                 f"steps, loop needs {tmax}")
            # pad ids point one past the rows: send them to batch row 0
            # (never seeded) with row 0's own value, so they write nothing
            # new
            pad = seed_rows >= rows_loc
            seed_rows = torch.where(pad, 0, seed_rows).long()
            seeds.append((seed_rows, pad, seed_vals))
        else:
            seeds.append(None)
    xs = list(x0s)
    series = []
    for x in xs:
        s = torch.zeros((tmax + 1, nb_loc, x.shape[1]), dtype=x.dtype,
                        device=x.device)
        s[0] = x[:nb_loc]
        series.append(s)
    eos = [torch.zeros((nb_loc,), dtype=torch.int32, device=d) for d in devs]
    lives = [torch.ones((), dtype=torch.int32, device=d) for d in devs]
    bads = [nonfinite_blocks(x) for x in xs] if backend.uses_tiles else None
    for l in range(1, tmax + 1):
        # T_min/T_max gating via the threshold sentinel: a negative
        # squared threshold means nobody exits this step
        ts2 = ts2_on if nai.t_min <= l < tmax else -1.0
        if exchange is None:
            xin, bin_ = xs, bads
        else:
            xin, bin_ = exchange(xs, bads)
        for d in range(D):
            node_active = (eos[d] == 0).to(torch.int32)
            active_rb = sas[d][l - 1] * lives[d] if sas[d] is not None \
                else None
            xs[d], exits, bad = backend.step(
                shard_ops[d], xin[d], node_active, active_rb, ts2,
                n_batch=nb_loc, n_rows=rows_loc,
                x_bad=None if bin_ is None else bin_[d])
            if bads is not None:
                bads[d] = bad
            eos[d] = torch.where((node_active != 0) & exits,
                                 torch.full_like(eos[d], l), eos[d])
        lives = _any_live([(e == 0).any() for e in eos], devs)
        for d in range(D):
            if seeds[d] is not None:
                # cache-hit rows: their stored X^(l) over what the
                # edge-dropped step left there (batch rows are never
                # seeded, so exits and series are unaffected); then the
                # flags of the new x
                seed_rows, pad, seed_vals = seeds[d]
                xs[d].index_copy_(0, seed_rows, torch.where(
                    pad[:, None], xs[d][0], seed_vals[l - 1]))
                if bads is not None:
                    bads[d] = nonfinite_blocks(xs[d])
            series[d][l] = xs[d][:nb_loc]
    eos = [torch.where(e == 0, torch.full_like(e, tmax), e) for e in eos]
    return eos, series


def _check_sharded(gather_mode: str, has_halo: bool, D: int, n_batch: int,
                   n_rows: int) -> None:
    """The sharded path's operand contract (the JAX package's errors)."""
    if (gather_mode != "dense") != has_halo:
        raise ValueError(
            f"gather_mode={gather_mode!r} and halo metadata disagree: "
            f"halo/alltoall need pack_support(halo=True) operands "
            f"(frame-local tile_col/src), dense needs global ones")
    if n_batch % (CB * D) or n_rows % (CB * D):
        raise ValueError(
            f"sharded operands must be packed with n_shards={D}: n_batch "
            f"{n_batch} and rows {n_rows} must be multiples of CB*D = "
            f"{CB * D}")


def _check_mode(gather_mode: str) -> None:
    if gather_mode not in GATHER_MODES:
        raise ValueError(f"unknown gather_mode {gather_mode!r} "
                         f"(one of {GATHER_MODES})")


def _placed(operands, x0, devs):
    """(per-shard operand dicts, per-shard x0) on their devices: a full
    dict (and full x0) is split with `shard_operands`; lists of per-shard
    dicts and tensors (the serving engine places them itself) are taken
    as they are."""
    if isinstance(operands, dict):
        shard_ops = shard_operands(operands, devs)
    else:
        shard_ops = [dict(o) for o in operands]
    x0s = (list(x0) if isinstance(x0, (list, tuple))
           else split_rows(x0, devs))
    if len(shard_ops) != len(devs) or len(x0s) != len(devs):
        raise ValueError(f"{len(shard_ops)} operand sets and {len(x0s)} "
                         f"x0 parts for {len(devs)} shards")
    return [_index_operands(o) for o in shard_ops], x0s


def _exchange_for(gather_mode, shard_ops, devs, rows_loc):
    halo = [{k: ops.pop(k) for k in HALO_KEYS if k in ops}
            for ops in shard_ops]
    missing = [k for k in HALO_KEYS if gather_mode != "dense"
               and any(k not in h for h in halo)]
    if missing:
        raise ValueError(f"gather_mode={gather_mode!r} needs the halo "
                         f"operands {missing}")
    return _Exchange(gather_mode, halo, devs, rows_loc)


def make_superstep(backend: PropagationBackend, nai, *, n_batch: int,
                   n_rows: int, device=None, mesh=None,
                   gather_mode: str = "dense"):
    """One NAP propagation step as its own callable — the unit of work of
    the offline full-graph job (`repro_torch.launch.full_graph_infer`),
    which checkpoints the state between steps instead of running the whole
    loop in one dispatch.

    Returns ``step(operands, x, exit_order, l) -> (x_new, exit_order)``
    (device tensors, returned without synchronising) that replicates
    exactly one iteration of `_masked_loop`'s body: the same threshold
    sentinel for T_min/T_max, the same row-block predicate
    ``step_active[l-1] * live``, the same exit-order update. ``live`` is
    recovered from the incoming ``exit_order`` (any batch row still at 0),
    which is what the loop carries in from the previous iteration; the
    non-finite flags of the tile backends, which the loop carries from
    step to step, are recomputed from the incoming ``x`` (a resumed chain
    does not have them). So a chain of supersteps from the same state
    equals the single-dispatch loop bit for bit on ``block_ell`` and
    ``fused``, and equals itself across interruption and resume.
    ``operands`` come from `pack_operands` (plus the dense ``x_inf`` for
    backends with ``uses_dense_x_inf``): numpy arrays are copied to the
    device on every call, tensors already there (``src``/``dst`` as
    int64) are used as they are. Cache-seed operands are not supported.

    With a mesh whose ``data`` axis is D > 1, operands come from
    ``pack_support(n_shards=D)`` (with halo metadata for a ``halo`` or
    ``alltoall`` `gather_mode`), and the step takes and returns the state
    per shard: ``x`` and ``exit_order`` are lists of D tensors on the
    shards' devices (`split_rows` of the packed-order arrays), and
    ``operands`` a full dict (split on every call) or the D per-shard
    dicts of `shard_operands`, placed once."""
    _check_mode(gather_mode)
    devs = mesh_devices(mesh, device)
    mesh = normalize_mesh(mesh)
    D = len(devs)
    if mesh is not None:
        _check_sharded(gather_mode, gather_mode != "dense", D, n_batch,
                       n_rows)
    tmax = nai.t_max
    ts2_on = float(np.float32(nai.t_s) ** 2)
    nb_loc, rows_loc = n_batch // D, n_rows // D

    def step(operands, x, exit_order, l: int):
        if not 1 <= l <= tmax:
            raise ValueError(f"superstep {l} outside 1..{tmax}")
        if mesh is None:
            ops = [_index_operands({k: _as_tensor(v, devs[0])
                                    for k, v in operands.items()})]
            xs = [_as_tensor(x, devs[0])]
            eos = [_as_tensor(exit_order, devs[0])]
        else:
            ops, xs = _placed(operands, x, devs)
            eos = (list(exit_order) if isinstance(exit_order, (list, tuple))
                   else split_rows(exit_order, devs))
        if any("seed_rows" in o for o in ops):
            raise ValueError("supersteps take no cache-seed operands")
        exchange = (None if mesh is None
                    else _exchange_for(gather_mode, ops, devs, rows_loc))
        missing = sorted({k for o in ops for k in _required(backend)
                          if k not in o})
        if missing:
            raise ValueError(f"superstep is missing operands {missing}")
        for o, xd in zip(ops, xs):
            backend.validate(o, xd, nb_loc)
        with torch.inference_mode():
            ts2 = ts2_on if nai.t_min <= l < tmax else -1.0
            lives = _any_live([(e == 0).any() for e in eos], devs)
            bads = ([nonfinite_blocks(xd) for xd in xs]
                    if backend.uses_tiles else None)
            xin, bin_ = (xs, bads) if exchange is None else exchange(xs,
                                                                     bads)
            out_x, out_eo = [], []
            for d in range(D):
                node_active = (eos[d] == 0).to(torch.int32)
                sa = ops[d].get("step_active")
                active_rb = sa[l - 1] * lives[d] if sa is not None else None
                xd, exits, _ = backend.step(
                    ops[d], xin[d], node_active, active_rb, ts2,
                    n_batch=nb_loc, n_rows=rows_loc,
                    x_bad=None if bin_ is None else bin_[d])
                out_x.append(xd)
                out_eo.append(torch.where((node_active != 0) & exits,
                                          torch.full_like(eos[d], l),
                                          eos[d]))
        if mesh is None:
            return out_x[0], out_eo[0]
        return out_x, out_eo

    return step


def _required(backend: PropagationBackend) -> Tuple[str, ...]:
    """The operand keys a backend's step reads."""
    keys = ()
    if backend.uses_tiles:
        keys += ("tiles", "tile_col", "valid", "step_active")
    if backend.uses_edges:
        keys += ("src", "dst", "coef")
    if backend.uses_factors:
        keys += ("c_inf", "s_inf")
    if backend.uses_dense_x_inf:
        keys += ("x_inf",)
    return keys


def _gather(ts: Sequence[torch.Tensor], dev, dim: int = 0):
    """Per-shard results concatenated on `dev` (packed order)."""
    return torch.cat([t.to(dev) for t in ts], dim=dim)


def run_propagation(backend: PropagationBackend, nai, operands, x0,
                    n_batch: int, *, device=None, mesh=None,
                    gather_mode: str = "dense", classify=None,
                    classifiers=None, return_series: bool = False):
    """Run the masked NAP loop for any registered backend on `device`
    (default ``"cuda"``).

    ``operands`` holds the backend's packed arrays (numpy or tensors,
    moved to the device), including the dense ``x_inf`` for backends with
    ``uses_dense_x_inf`` and the cache seeds of a ``seeds=`` pack.
    Returns ``(exit_order (n_batch,), series (T_max+1, n_batch, f))`` —
    or ``(exit_order, preds (n_batch,))`` when ``classify(classifiers,
    exit_order, series)`` is given, and then with ``return_series=True``
    ``(exit_order, preds, series)`` (the propagated-feature cache's fill
    source).

    With a mesh whose ``data`` axis is D > 1, the operands come from
    ``pack_support(n_shards=D)`` — a full dict, or the D per-shard dicts
    of `shard_operands` with `x0` then a list of D row blocks — and every
    shard runs the loop on its own rows, reading the frontier through the
    `gather_mode` exchange (``halo`` and ``alltoall`` need the halo
    metadata of ``pack_support(halo=True)``). Classification runs per
    shard on its own batch rows (``classifiers`` one module, or one per
    shard on its device). Results are gathered on the mesh's first device
    in the PACKED batch order — undo with
    `repro_torch.gnn.packing.shard_batch_perm`."""
    _check_mode(gather_mode)
    devs = mesh_devices(mesh, device)
    mesh = normalize_mesh(mesh)
    if mesh is None:
        if isinstance(operands, dict) and "halo_src_shard" in operands:
            raise ValueError("halo-packed operands (frame-local indices) "
                             "cannot run single-device — pack with "
                             "halo=False")
        shard_ops = [_index_operands({k: _as_tensor(v, devs[0])
                                      for k, v in operands.items()})]
        x0s = [_as_tensor(x0, devs[0])]
        exchange = None
    else:
        parts = isinstance(x0, (list, tuple))
        _check_sharded(gather_mode, "halo_src_shard" in (
            operands[0] if parts else operands), len(devs), n_batch,
            sum(x.shape[0] for x in x0) if parts else x0.shape[0])
        shard_ops, x0s = _placed(operands, x0, devs)
        exchange = _exchange_for(gather_mode, shard_ops, devs,
                                 x0s[0].shape[0])
    D = len(devs)
    nb_loc = n_batch // D
    for o, x in zip(shard_ops, x0s):
        backend.validate(o, x, nb_loc)
    with torch.inference_mode():
        eos, series = _masked_loop(backend, nai, shard_ops, x0s, nb_loc,
                                   x0s[0].shape[0], exchange)
        if classify is None:
            return _gather(eos, devs[0]), _gather(series, devs[0], 1)
        heads = (list(classifiers) if isinstance(classifiers, (list, tuple))
                 else [classifiers] * D)
        with profiled("serve.heads"):
            preds = [classify(h, e, s) for h, e, s in zip(heads, eos, series)]
        out = (_gather(eos, devs[0]), _gather(preds, devs[0]))
        if return_series:
            return (*out, _gather(series, devs[0], 1))
        return out
