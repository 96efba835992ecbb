"""Wrapper of the WKV6 CUDA kernel (`csrc/wkv6.cu`).

Replaces `repro.kernels.wkv6.kernel.wkv6` (a Pallas TPU kernel). Unlike
the JAX function it also returns the final recurrent state, which the
serving prefill stores in its cache (the JAX layer takes it from
`repro.nn.rwkv._wkv_chunked`).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.checks import check, kernel_device, stream_of
from repro_torch.kernels.wkv6 import CHUNK, HEAD_DIMS
from repro_torch.kernels.wkv6.ref import ref_wkv6


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         logw: torch.Tensor, u: torch.Tensor):
    """r/k/v/logw (BH, T, hd) f32 with T % CHUNK == 0 and logw in
    [MIN_LOGW, 0]; u (BH, hd) f32. Zero initial state. Returns (out (BH, T,
    hd) f32, state (BH, hd, hd) f32), state[b, c, d] the key-c value-d
    entry after the last step."""
    dev = kernel_device(r=r, k=k, v=v, logw=logw, u=u)
    BH, T, hd = r.shape
    if T % CHUNK:
        raise ValueError(f"T = {T} is not a multiple of CHUNK = {CHUNK}")
    for name, t in (("r", r), ("k", k), ("v", v), ("logw", logw)):
        check(name, t, torch.float32, (BH, T, hd))
    check("u", u, torch.float32, (BH, hd))
    if dev.type == "cpu":
        return ref_wkv6(r, k, v, logw, u)
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd}: the CUDA kernel takes {HEAD_DIMS}")
    out = torch.empty_like(r)
    state = torch.empty((BH, hd, hd), dtype=torch.float32, device=dev)
    err = build.library().wkv6_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
        u.data_ptr(), out.data_ptr(), state.data_ptr(), BH, T, hd,
        dev.index, stream_of(dev))
    build.check_launch("wkv6", err)
    wkv6.launches += 1
    return out, state


wkv6.launches = 0
