"""Host-side block-ELL converter and the one-step wrapper (the port of
`repro.kernels.spmm.ops`). The converter is numpy and builds the same
arrays as the JAX package's; `spmm` runs kernel B1 on CUDA tensors and its
plain version on CPU tensors."""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels.spmm import CB, FB, RB
from repro_torch.kernels.spmm.kernel import spmm_block_ell


@dataclasses.dataclass
class BlockEll:
    tiles: np.ndarray      # (n_rb, max_tb, RB, CB) f32
    tile_col: np.ndarray   # (n_rb, max_tb) int32
    valid: np.ndarray      # (n_rb, max_tb) int32
    n: int                 # original (unpadded) node count
    n_pad: int

    @property
    def density(self) -> float:
        return float(self.valid.mean())


def build_block_ell(src, dst, coef, n: int) -> BlockEll:
    """Edge list (local ids) -> block-ELL tiles. Rows/cols padded to CB so
    feature blocks index cleanly."""
    n_pad = -(-n // CB) * CB
    n_rb = n_pad // RB
    rb = dst // RB
    cb = src // CB
    key = rb.astype(np.int64) * (n_pad // CB) + cb
    uniq = np.unique(key)
    tiles_of_rb: dict = {}
    for u in uniq:
        r, c = int(u) // (n_pad // CB), int(u) % (n_pad // CB)
        tiles_of_rb.setdefault(r, []).append(c)
    max_tb = max((len(v) for v in tiles_of_rb.values()), default=1)

    tiles = np.zeros((n_rb, max_tb, RB, CB), np.float32)
    tile_col = np.zeros((n_rb, max_tb), np.int32)
    valid = np.zeros((n_rb, max_tb), np.int32)
    slot_of = {}
    for r, cols in tiles_of_rb.items():
        for t, c in enumerate(sorted(cols)):
            tile_col[r, t] = c
            valid[r, t] = 1
            slot_of[(r, c)] = t
    t_idx = np.fromiter((slot_of[(int(r), int(c))] for r, c in zip(rb, cb)),
                        np.int64, len(rb))
    tiles[rb, t_idx, dst % RB, src % CB] += coef
    return BlockEll(tiles=tiles, tile_col=tile_col, valid=valid, n=n,
                    n_pad=n_pad)


def pad_features(x: np.ndarray, n_pad: int) -> np.ndarray:
    f_pad = -(-x.shape[1] // FB) * FB
    out = np.zeros((n_pad, f_pad), np.float32)
    out[:x.shape[0], :x.shape[1]] = x
    return out


def spmm(ell: BlockEll, x: torch.Tensor,
         active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One propagation step on x's device. x (n_pad, F_pad) f32; active
    (n_rb,) int32 or None (= all active). Returns (n_pad, F_pad)."""
    n_rb = ell.tile_col.shape[0]
    if active is None:
        active = torch.ones((n_rb,), dtype=torch.int32, device=x.device)

    def on(a):
        return torch.from_numpy(a).to(x.device)

    return spmm_block_ell(on(ell.tiles), on(ell.tile_col), on(ell.valid),
                          active, x)


def active_blocks_from_nodes(node_active, n_pad: int) -> torch.Tensor:
    """Node-level NAP mask -> row-block predicate (any node active),
    int32 (n_pad / RB,) on the mask's device."""
    node_active = torch.as_tensor(node_active, dtype=torch.bool)
    m = torch.zeros((n_pad,), dtype=torch.bool, device=node_active.device)
    m[:len(node_active)] = node_active
    return m.reshape(-1, RB).any(dim=1).to(torch.int32)
