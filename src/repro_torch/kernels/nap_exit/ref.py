"""Plain PyTorch version of the NAP exit-decision kernel."""
from __future__ import annotations

import torch

from repro_torch.kernels.nap_exit import NB


def ref_nap_exit(x: torch.Tensor, x_inf: torch.Tensor, active: torch.Tensor,
                 ts2: float):
    """Returns (dist2 (n, 1) f32, exit (n, 1) int32, blk_active (n/NB, 1)
    int32) for `ts2` the squared threshold (negative disables exits)."""
    diff = (x - x_inf).float()
    dist2 = (diff * diff).sum(dim=1, keepdim=True)
    was_active = active != 0
    exits = was_active & (dist2 < ts2)
    still = was_active & ~exits
    blk = still.reshape(-1, NB).any(dim=1, keepdim=True).to(torch.int32)
    return dist2, exits.to(torch.int32), blk
