"""Plain PyTorch version of the fused NAP step kernel."""
from __future__ import annotations

import torch

from repro_torch.kernels.spmm import RB
from repro_torch.kernels.spmm.ref import ref_spmm_block_ell


def ref_nap_step(tiles, tile_col, valid, active, x, c_inf, s_inf,
                 node_active, ts2: float):
    """Predicated tile SpMM, then the exit decision on the batch region
    against the rank-1 stationary state c ⊗ s. Returns (out, exit (nb, 1)
    int32, blk_still (n_rb, 1) int32) like `nap_step_fused`."""
    out = ref_spmm_block_ell(tiles, tile_col, valid, active, x)
    x_inf = c_inf.reshape(-1, 1) * s_inf.reshape(1, -1)
    nb = x_inf.shape[0]
    diff = (out[:nb] - x_inf).float()
    dist2 = (diff * diff).sum(dim=1, keepdim=True)
    was_active = node_active.reshape(-1, 1) != 0
    exits = was_active & (dist2 < ts2)
    still = was_active & ~exits
    n_rb = tile_col.shape[0]
    blk = torch.zeros((n_rb, 1), dtype=torch.int32, device=out.device)
    blk[:nb // RB, 0] = still.reshape(-1, RB).any(dim=1).to(torch.int32)
    return out, exits.to(torch.int32), blk
