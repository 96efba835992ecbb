"""Wrapper of the block-ELL SpMM CUDA kernel (`csrc/spmm_block_ell.cu`).

Replaces `repro.kernels.spmm.kernel.spmm_block_ell` (a Pallas TPU
kernel). CPU tensors go to the plain version (`ref.py`); CUDA tensors
launch the kernel on PyTorch's current stream, without synchronising.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.checks import check, kernel_device, stream_of
from repro_torch.kernels.spmm import CB, FB, RB
from repro_torch.kernels.spmm.ref import ref_spmm_block_ell


def spmm_block_ell(tiles: torch.Tensor, tile_col: torch.Tensor,
                   valid: torch.Tensor, active: torch.Tensor,
                   x: torch.Tensor) -> torch.Tensor:
    """tiles (n_rb, tb, RB, CB) f32 adjacency coefficient tiles;
    tile_col (n_rb, tb) int32 column-block index per tile; valid (n_rb,
    tb) int32 1 for real tiles; active (n_rb,) int32 NAP row-block
    predicate; x (n_x, F) f32 with n_x % CB == 0 and F % FB == 0.
    Returns out (n_rb*RB, F) f32; inactive row blocks are
    zero. On the card the kernel touches only the non-zero coefficients
    (bitwise the same sums as the dense fused step on finite x).

    The tile_col of every valid slot must index a block of x (< n_x/CB):
    the packer guarantees it, and the CUDA path does not re-check it
    (that would need a device sync)."""
    dev = kernel_device(tiles=tiles, tile_col=tile_col, valid=valid,
                        active=active, x=x)
    n_rb, tb = tile_col.shape
    n_x, F = x.shape
    if n_x % CB or F % FB or F == 0:
        raise ValueError(f"x shape {(n_x, F)}: rows must be a multiple of "
                         f"{CB} and features a positive multiple of {FB}")
    check("tiles", tiles, torch.float32, (n_rb, tb, RB, CB), aligned=True)
    check("tile_col", tile_col, torch.int32, (n_rb, tb))
    check("valid", valid, torch.int32, (n_rb, tb))
    check("active", active, torch.int32, (n_rb,))
    check("x", x, torch.float32, aligned=dev.type == "cuda")
    if dev.type == "cpu":
        return ref_spmm_block_ell(tiles, tile_col, valid, active, x)
    out = torch.empty((n_rb * RB, F), dtype=torch.float32, device=dev)
    err = build.library().spmm_block_ell_launch(
        tiles.data_ptr(), tile_col.data_ptr(), valid.data_ptr(),
        active.data_ptr(), x.data_ptr(), out.data_ptr(), n_rb, tb, F,
        dev.index, stream_of(dev))
    build.check_launch("spmm_block_ell", err)
    spmm_block_ell.launches += 1
    return out


spmm_block_ell.launches = 0
