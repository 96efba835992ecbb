"""Wrapper of the NAP exit-decision CUDA kernel (`csrc/nap_exit.cu`).

Replaces `repro.kernels.nap_exit.kernel.nap_exit` (a Pallas TPU kernel).
Unlike the JAX function it takes the SQUARED threshold `ts2`, the form the
NAP loop carries (negative = exits disabled this step); callers holding
the unsquared T_s pass ``float(np.float32(t_s * t_s))``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.checks import check, kernel_device, stream_of
from repro_torch.kernels.nap_exit import FB, NB
from repro_torch.kernels.nap_exit.ref import ref_nap_exit


def nap_exit(x: torch.Tensor, x_inf: torch.Tensor, active: torch.Tensor,
             ts2: float):
    """x, x_inf (n, F) f32 propagated / stationary features with n % NB
    == 0 and F % FB == 0; active (n, 1) int32 'not yet exited'; ts2 the
    squared threshold. Returns (dist2 (n, 1) f32, exit (n, 1) int32,
    blk_active (n/NB, 1) int32)."""
    dev = kernel_device(x=x, x_inf=x_inf, active=active)
    n, F = x.shape
    if n % NB or F % FB or F == 0:
        raise ValueError(f"x shape {(n, F)}: rows must be a multiple of "
                         f"{NB} and features a positive multiple of {FB}")
    cuda = dev.type == "cuda"
    check("x", x, torch.float32, aligned=cuda)
    check("x_inf", x_inf, torch.float32, (n, F), aligned=cuda)
    check("active", active, torch.int32, (n, 1))
    ts2 = float(ts2)
    if not cuda:
        return ref_nap_exit(x, x_inf, active, ts2)
    dist2 = torch.empty((n, 1), dtype=torch.float32, device=dev)
    exits = torch.empty((n, 1), dtype=torch.int32, device=dev)
    blk = torch.empty((n // NB, 1), dtype=torch.int32, device=dev)
    err = build.library().nap_exit_launch(
        x.data_ptr(), x_inf.data_ptr(), active.data_ptr(), ts2,
        dist2.data_ptr(), exits.data_ptr(), blk.data_ptr(), n, F,
        dev.index, stream_of(dev))
    build.check_launch("nap_exit", err)
    nap_exit.launches += 1
    return dist2, exits, blk


nap_exit.launches = 0
