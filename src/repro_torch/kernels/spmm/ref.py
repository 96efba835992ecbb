"""Plain PyTorch version of the block-ELL SpMM kernel."""
from __future__ import annotations

import torch

from repro_torch.kernels.spmm import CB, RB


def ref_spmm_block_ell(tiles: torch.Tensor, tile_col: torch.Tensor,
                       valid: torch.Tensor, active: torch.Tensor,
                       x: torch.Tensor) -> torch.Tensor:
    """out[rb*RB:+RB] = sum over slots t of [active[rb] & valid[rb, t]]
    tiles[rb, t] @ x[tile_col[rb, t]*CB:+CB], accumulated in f32 slot by
    slot. Works per tile slot on the rows that use it, so it never builds
    the (n_rb, tb, CB, F) gather of every slot at once."""
    n_rb, tb = tile_col.shape
    F = x.shape[1]
    xb = x.reshape(-1, CB, F)
    out = torch.zeros(n_rb, RB, F, dtype=torch.float32, device=x.device)
    use = (valid != 0) & (active[:, None] != 0)
    for t in range(tb):
        rows = torch.nonzero(use[:, t]).flatten()
        if rows.numel():
            out[rows] += torch.bmm(tiles[rows, t].float(),
                                   xb[tile_col[rows, t].long()].float())
    return out.reshape(n_rb * RB, F).to(x.dtype)
