"""Wrapper of the fused NAP step CUDA kernel (`csrc/nap_step_fused.cu`).

Replaces `repro.kernels.nap_step.kernel.nap_step_fused` (a Pallas TPU
kernel). Same operand contract: block-ELL operands, the rank-1 stationary
factors c_inf (nb,) and s_inf (F,), node_active (nb, 1) and the squared
threshold `ts2` (negative disables exits) — here a Python float passed by
value, since the NAP loop's gating depends only on the host-side step.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.checks import check, kernel_device, stream_of
from repro_torch.kernels.nap_step.ref import ref_nap_step
from repro_torch.kernels.spmm import CB, FB, RB
from repro_torch.kernels.spmm.kernel import (check_flags, nonfinite_blocks,
                                          zero_flags)


def nap_step_fused(tiles: torch.Tensor, tile_col: torch.Tensor,
                   valid: torch.Tensor, active: torch.Tensor,
                   x: torch.Tensor, c_inf: torch.Tensor,
                   s_inf: torch.Tensor, node_active: torch.Tensor,
                   ts2: float, *, x_bad: Optional[torch.Tensor] = None,
                   out_bad: Optional[torch.Tensor] = None):
    """One fused NAP step. tiles/tile_col/valid/active/x, x_bad and
    out_bad as for `spmm_block_ell`; c_inf (nb,) or (nb, 1) f32 and s_inf
    (F,) or (1, F) f32 with nb % RB == 0 and RB <= nb <= n_rb*RB;
    node_active (nb, 1) int32. Returns (out (n_rb*RB, F) f32, exit (nb,
    1) int32, blk_still (n_rb, 1) int32, zero on non-batch row blocks);
    on the card `out` and out_bad are bitwise `spmm_block_ell`'s."""
    flags = {k: f for k, f in (("x_bad", x_bad), ("out_bad", out_bad))
             if f is not None}
    dev = kernel_device(tiles=tiles, tile_col=tile_col, valid=valid,
                        active=active, x=x, c_inf=c_inf, s_inf=s_inf,
                        node_active=node_active, **flags)
    cuda = dev.type == "cuda"
    n_rb, tb = tile_col.shape
    n_x, F = x.shape
    if n_x % CB or F % FB or F == 0:
        raise ValueError(f"x shape {(n_x, F)}: rows must be a multiple of "
                         f"{CB} and features a positive multiple of {FB}")
    nb = c_inf.numel()
    if nb % RB or nb < RB or nb > n_rb * RB:
        raise ValueError(f"c_inf has {nb} rows: need a multiple of {RB} "
                         f"between {RB} and {n_rb * RB}")
    check("tiles", tiles, torch.float32, (n_rb, tb, RB, CB), aligned=True)
    check("tile_col", tile_col, torch.int32, (n_rb, tb))
    check("valid", valid, torch.int32, (n_rb, tb))
    check("active", active, torch.int32, (n_rb,))
    check("x", x, torch.float32, aligned=cuda)
    check("c_inf", c_inf, torch.float32)
    check("s_inf", s_inf, torch.float32)
    if s_inf.numel() != F:
        raise ValueError(f"s_inf has {s_inf.numel()} entries, x has {F} "
                         f"features")
    check("node_active", node_active, torch.int32, (nb, 1))
    check_flags("x_bad", x_bad, n_x, F)
    check_flags("out_bad", out_bad, n_rb * RB, F)
    ts2 = float(ts2)
    if not cuda:
        res = ref_nap_step(tiles, tile_col, valid, active, x, c_inf, s_inf,
                           node_active, ts2)
        if out_bad is not None:
            out_bad.copy_(nonfinite_blocks(res[0]))
        return res
    if x_bad is None:
        x_bad = nonfinite_blocks(x)
    if out_bad is None:
        out_bad = zero_flags(n_rb * RB, F, dev)
    out = torch.empty((n_rb * RB, F), dtype=torch.float32, device=dev)
    exits = torch.empty((nb, 1), dtype=torch.int32, device=dev)
    blk = torch.empty((n_rb, 1), dtype=torch.int32, device=dev)
    err = build.library().nap_step_fused_launch(
        tiles.data_ptr(), tile_col.data_ptr(), valid.data_ptr(),
        active.data_ptr(), x_bad.data_ptr(), x.data_ptr(), c_inf.data_ptr(),
        s_inf.data_ptr(), node_active.data_ptr(), ts2, out.data_ptr(),
        out_bad.data_ptr(), exits.data_ptr(), blk.data_ptr(), n_rb, tb, F,
        n_x, nb, dev.index, stream_of(dev))
    build.check_launch("nap_step_fused", err)
    nap_step_fused.launches += 1
    return out, exits, blk


nap_step_fused.launches = 0
