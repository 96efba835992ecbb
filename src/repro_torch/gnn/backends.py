"""Propagation backends: one interface over every SpMM implementation.

The port of the single-device half of `repro.gnn.backends`. Every
implementation is a `PropagationBackend` registered in `BACKENDS`, and
`run_propagation` runs the ONE masked NAP loop (`_masked_loop`) over it:

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

The loop keeps every per-step decision on the device: the live flag and
the row-block predicate ``step_active[l-1] * live`` are device tensors
handed to the kernels, and the threshold gating depends only on the host
step index, so no step synchronises with the host and a pipelined engine
keeps the card busy while it packs the next batch.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.nap_exit import nap_exit
from repro_torch.kernels.nap_step import nap_step_fused
from repro_torch.kernels.spmm import (CB, RB, nonfinite_blocks, spmm_block_ell,
                                      zero_flags)

BACKENDS: Dict[str, "PropagationBackend"] = {}


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
    backend consumes it (the dense ``x_inf`` travels as its own argument
    through `make_compiled_infer`)."""
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
    return ops


def _as_tensor(a, device: torch.device) -> torch.Tensor:
    """numpy or tensor -> contiguous tensor on `device` (no copy when it
    already lies there)."""
    t = torch.from_numpy(a) if isinstance(a, np.ndarray) else a
    return t.to(device).contiguous()


def _masked_loop(backend, nai, ops, x0, n_batch, n_rows):
    """The ONE masked NAP loop. Carries ``x (n_rows, f)``, ``series
    (T_max+1, n_batch, f)``, ``exit_order (n_batch,)`` and ``live`` (a
    0-dim int32 device tensor). Exit orders of 0 after the loop mean
    never-exited and collapse to T_max. All T_max steps run, as the
    reference's fori_loop does; once the batch has exited, ``live`` zeroes
    the row-block predicate and the kernels skip every tile."""
    tmax = nai.t_max
    ts2_on = float(np.float32(nai.t_s) ** 2)
    sa = ops.get("step_active")
    x = x0
    series = torch.zeros((tmax + 1, n_batch, x0.shape[1]), dtype=x0.dtype,
                         device=x0.device)
    series[0] = x0[:n_batch]
    exit_order = torch.zeros((n_batch,), dtype=torch.int32,
                             device=x0.device)
    live = torch.ones((), dtype=torch.int32, device=x0.device)
    bad = nonfinite_blocks(x0) if backend.uses_tiles else None
    for l in range(1, tmax + 1):
        node_active = (exit_order == 0).to(torch.int32)
        # T_min/T_max gating via the threshold sentinel: a negative
        # squared threshold means nobody exits this step
        ts2 = ts2_on if nai.t_min <= l < tmax else -1.0
        active_rb = sa[l - 1] * live if sa is not None else None
        x, exits, bad = backend.step(ops, x, node_active, active_rb, ts2,
                                     n_batch=n_batch, n_rows=n_rows,
                                     x_bad=bad)
        exit_order = torch.where((node_active != 0) & exits,
                                 torch.full_like(exit_order, l), exit_order)
        live = (exit_order == 0).any().to(torch.int32)
        series[l] = x[:n_batch]
    exit_order = torch.where(exit_order == 0,
                             torch.full_like(exit_order, tmax), exit_order)
    return exit_order, series


def run_propagation(backend: PropagationBackend, nai, operands: dict,
                    x0, n_batch: int, *, device="cuda",
                    classify=None, classifiers=None):
    """Run the masked NAP loop for any registered backend on `device`.

    ``operands`` holds the backend's packed arrays (numpy or tensors,
    moved to `device`), including the dense ``x_inf`` for backends with
    ``uses_dense_x_inf``. Returns ``(exit_order (n_batch,), series
    (T_max+1, n_batch, f))`` — or ``(exit_order, preds (n_batch,))``
    when ``classify(classifiers, exit_order, series)`` is given."""
    dev = resolve_device(device)
    ops = {k: _as_tensor(v, dev) for k, v in operands.items()}
    for k in ("src", "dst"):
        if k in ops:
            ops[k] = ops[k].long()
    x0 = _as_tensor(x0, dev)
    backend.validate(ops, x0, n_batch)
    with torch.inference_mode():
        exit_order, series = _masked_loop(backend, nai, ops, x0, n_batch,
                                          x0.shape[0])
        if classify is None:
            return exit_order, series
        return exit_order, classify(classifiers, exit_order, series)
