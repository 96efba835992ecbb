"""Plain PyTorch versions of the block-ELL SpMM kernel: one on the packed
tiles (`ref_spmm_block_ell`) and one on the edge list (`ref_spmm_dense`),
which catches converter bugs apart from kernel bugs."""
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


def ref_spmm_dense(src, dst, coef, n_pad: int, x: torch.Tensor,
                   active) -> torch.Tensor:
    """Dense-materialised Â @ x with inactive row blocks zeroed, in f64.
    src/dst/coef: the edge list (deduplicated: a repeated edge keeps one
    of its coefficients), numpy or tensors; x (n_pad, F); active (n_rb,).
    Builds an (n_pad, n_pad) matrix on x's device: for small graphs."""
    dev = x.device
    A = torch.zeros((n_pad, n_pad), dtype=torch.float64, device=dev)
    A[torch.as_tensor(dst, device=dev).long(),
      torch.as_tensor(src, device=dev).long()] = torch.as_tensor(
          coef, device=dev).double()
    out = A @ x.double()
    rows = torch.repeat_interleave(torch.as_tensor(active, device=dev) != 0,
                                   RB)[:n_pad]
    return torch.where(rows[:, None], out, 0.0).to(x.dtype)
