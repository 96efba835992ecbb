"""`exit_decision`: the exit-decision kernel on unpadded inputs, as the
JAX package's `repro.kernels.nap_exit.ops.exit_decision` takes them."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.nap_exit import FB, NB
from repro_torch.kernels.nap_exit.kernel import nap_exit


def exit_decision(x: torch.Tensor, x_inf: torch.Tensor,
                  active_nodes: torch.Tensor, t_s: float):
    """x, x_inf (n, f) f32; active_nodes (n,) bool; t_s the (unsquared)
    threshold, squared in f32 as the JAX function squares it. Pads to
    (n_pad, f_pad) multiples of (NB, FB) with zeros and returns (dist
    (n,) = sqrt(dist2), exit (n,) bool, blk_active (n_pad / NB,) int32,
    on the padded grid)."""
    n, f = x.shape
    n_pad, f_pad = -(-n // NB) * NB, -(-f // FB) * FB
    xp = x.new_zeros((n_pad, f_pad))
    xp[:n, :f] = x
    ip = x.new_zeros((n_pad, f_pad))
    ip[:n, :f] = x_inf
    ap = torch.zeros((n_pad, 1), dtype=torch.int32, device=x.device)
    ap[:n, 0] = active_nodes.to(torch.int32)
    dist2, exits, blk = nap_exit(xp, ip, ap, float(np.float32(t_s * t_s)))
    return torch.sqrt(dist2[:n, 0]), exits[:n, 0] != 0, blk[:, 0]
