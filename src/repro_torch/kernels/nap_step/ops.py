"""`fused_step` and `two_launch_step`: the fused kernel and the unfused
composition it replaces (`spmm_block_ell` then `nap_exit`), with the same
output contract. Both take the unsquared threshold `t_s`, squared in f32
exactly as the JAX package's `repro.kernels.nap_step.ops` does."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.nap_exit import nap_exit
from repro_torch.kernels.nap_step.kernel import nap_step_fused
from repro_torch.kernels.spmm import RB, spmm_block_ell


def _ts2(t_s: float) -> float:
    return float(np.float32(t_s * t_s))


def fused_step(tiles, tile_col, valid, active, x, c_inf, s_inf,
               node_active, t_s: float):
    """One fused propagation + exit step. Returns (out, exit,
    blk_still)."""
    return nap_step_fused(tiles, tile_col, valid, active, x, c_inf, s_inf,
                          node_active, _ts2(t_s))


def two_launch_step(tiles, tile_col, valid, active, x, c_inf, s_inf,
                    node_active, t_s: float):
    """The unfused composition: SpMM launch, the dense stationary state
    materialized, then the exit-decision launch over the batch region.
    On the card its exit flags equal `fused_step`'s bit for bit."""
    x_inf = c_inf.reshape(-1, 1) * s_inf.reshape(1, -1)
    nb = x_inf.shape[0]
    out = spmm_block_ell(tiles, tile_col, valid, active, x)
    _, exits, blk_batch = nap_exit(out[:nb], x_inf, node_active, _ts2(t_s))
    blk = torch.zeros((tile_col.shape[0], 1), dtype=torch.int32,
                      device=out.device)
    blk[:nb // RB] = blk_batch
    return out, exits, blk
