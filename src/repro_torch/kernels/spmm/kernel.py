"""Wrapper of the block-ELL SpMM CUDA kernel (`csrc/spmm_block_ell.cu`).

Replaces `repro.kernels.spmm.kernel.spmm_block_ell` (a Pallas TPU
kernel). CPU tensors go to the plain version (`ref.py`); CUDA tensors
launch the kernel on PyTorch's current stream, without synchronising.

The kernel skips zero coefficients, which is exact only where x is
finite; it keeps them for tiles whose x block holds a NaN or an Inf. It
learns which from the flags of `nonfinite_blocks` and writes the same
flags for its output, so a loop of steps passes them on (`x_bad`,
`out_bad`) instead of scanning every x again.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F_

from repro_torch.kernels import build
from repro_torch.kernels.checks import check, kernel_device, stream_of
from repro_torch.kernels.spmm import CB, FB, RB, SLAB
from repro_torch.kernels.spmm.ref import ref_spmm_block_ell


def nonfinite_blocks(x: torch.Tensor) -> torch.Tensor:
    """(ceil(F / SLAB), ceil(n / CB)) uint8 flags of x (n, F): 1 where
    x[CB*i : CB*i + CB, SLAB*y : SLAB*y + SLAB] holds a NaN or an Inf. A
    few PyTorch ops on x's device (one pass over x)."""
    n, F = x.shape
    bad = F_.pad(torch.isfinite(x).logical_not_(), (0, 0, 0, (-n) % CB))
    bad = bad.view(-1, CB, F).any(dim=1)
    return torch.stack([bad[:, y:y + SLAB].any(dim=1)
                        for y in range(0, F, SLAB)]).to(torch.uint8)


def zero_flags(n_rows: int, F: int, dev: torch.device) -> torch.Tensor:
    """All-clear flags for n_rows x F values: what the kernels' `out_bad`
    must hold on entry."""
    return torch.zeros((-(-F // SLAB), -(-n_rows // CB)), dtype=torch.uint8,
                       device=dev)


def check_flags(name: str, flags, n_rows: int, F: int) -> None:
    """Type and shape of an optional flag tensor for n_rows x F values
    (its device is checked with the operands')."""
    if flags is not None:
        check(name, flags, torch.uint8, (-(-F // SLAB), -(-n_rows // CB)))


def spmm_block_ell(tiles: torch.Tensor, tile_col: torch.Tensor,
                   valid: torch.Tensor, active: torch.Tensor,
                   x: torch.Tensor, *, x_bad: Optional[torch.Tensor] = None,
                   out_bad: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tiles (n_rb, tb, RB, CB) f32 adjacency coefficient tiles;
    tile_col (n_rb, tb) int32 column-block index per tile; valid (n_rb,
    tb) int32 1 for real tiles; active (n_rb,) int32 NAP row-block
    predicate; x (n_x, F) f32 with n_x % CB == 0 and F % FB == 0.
    Returns out (n_rb*RB, F) f32; inactive row blocks are zero. Equal to
    the dense product wherever x holds NaN or Inf (0 * NaN = NaN).

    x_bad: `nonfinite_blocks(x)`, or flags set wherever it sets them (a
    superset only costs time); computed here when None. out_bad: a
    `zero_flags(n_rb * RB, F)` tensor, all zero on entry, in which the
    kernel sets the flags of out (on the CPU it is overwritten with them).
    On the card the kernel touches only the non-zero coefficients of
    tiles whose x block is finite (bitwise the same sums as the dense
    chain of the fused step).

    The tile_col of every valid slot must index a block of x (< n_x/CB):
    the packer guarantees it, and the CUDA path does not re-check it
    (that would need a device sync)."""
    flags = {k: f for k, f in (("x_bad", x_bad), ("out_bad", out_bad))
             if f is not None}
    dev = kernel_device(tiles=tiles, tile_col=tile_col, valid=valid,
                        active=active, x=x, **flags)
    cuda = dev.type == "cuda"
    n_rb, tb = tile_col.shape
    n_x, F = x.shape
    if n_x % CB or F % FB or F == 0:
        raise ValueError(f"x shape {(n_x, F)}: rows must be a multiple of "
                         f"{CB} and features a positive multiple of {FB}")
    check("tiles", tiles, torch.float32, (n_rb, tb, RB, CB), aligned=True)
    check("tile_col", tile_col, torch.int32, (n_rb, tb))
    check("valid", valid, torch.int32, (n_rb, tb))
    check("active", active, torch.int32, (n_rb,))
    check("x", x, torch.float32, aligned=cuda)
    check_flags("x_bad", x_bad, n_x, F)
    check_flags("out_bad", out_bad, n_rb * RB, F)
    if not cuda:
        out = ref_spmm_block_ell(tiles, tile_col, valid, active, x)
        if out_bad is not None:
            out_bad.copy_(nonfinite_blocks(out))
        return out
    if x_bad is None:
        x_bad = nonfinite_blocks(x)
    if out_bad is None:
        out_bad = zero_flags(n_rb * RB, F, dev)
    out = torch.empty((n_rb * RB, F), dtype=torch.float32, device=dev)
    err = build.library().spmm_block_ell_launch(
        tiles.data_ptr(), tile_col.data_ptr(), valid.data_ptr(),
        active.data_ptr(), x_bad.data_ptr(), x.data_ptr(), out.data_ptr(),
        out_bad.data_ptr(), n_rb, tb, F, n_x, dev.index, stream_of(dev))
    build.check_launch("spmm_block_ell", err)
    spmm_block_ell.launches += 1
    return out


spmm_block_ell.launches = 0
