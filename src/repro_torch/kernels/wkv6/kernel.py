"""Wrapper of the WKV6 CUDA kernel (`csrc/wkv6.cu`).

Replaces `repro.kernels.wkv6.kernel.wkv6` (a Pallas TPU kernel). Unlike
the JAX function it also returns the final recurrent state, which the
serving prefill stores in its cache (the JAX layer takes it from
`repro.nn.rwkv._wkv_chunked`). The kernel reads its operands through
strides, so the model's (B, T, H, hd) layout goes in without a copy
(`launch_heads`, for `ops.wkv6_heads`).

On `meta` inputs (the dry run, `repro_torch.launch.dryrun`) both make
their checks and return empty outputs of the kernel's shapes and dtypes,
handing the kernel's `cost` to the running
`launch.cost_analysis.analyze`: shape inference, not a fallback.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.checks import (check, kernel_device,
                                        refuse_grad, stream_of)
from repro_torch.kernels.wkv6 import CHUNK, HEAD_DIMS
from repro_torch.kernels.wkv6.ref import ref_wkv6
from repro_torch.launch import cost_analysis


def cost(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         logw: torch.Tensor, u: torch.Tensor):
    """(flops, bytes) of one call on r/k/v/logw (BH, T, hd) as `wkv6`
    takes them or (B, T, H, hd) as `launch_heads` does: per (batch row,
    head) and chunk of CHUNK steps, the intra-chunk products (4·C²·hd),
    the state's read and update (4·C·hd²) and the elementwise decay terms
    (10·C·hd); r, k, v, logw read and the output written once (f32), u
    read once per (batch row, head) and the final state written once."""
    if r.dim() == 4:
        B, T, H, hd = r.shape
        BH = B * H
    else:
        BH, T, hd = r.shape
    C = CHUNK
    flops = BH * -(-T // C) * (4 * C * C * hd + 4 * C * hd * hd
                               + 10 * C * hd)
    return flops, (5 * BH * T * hd + BH * hd + BH * hd * hd) * 4


def _launch(r, k, v, logw, u, B: int, H: int, T: int, hd: int,
            strides, u_batch_stride: int):
    """The kernel on operands with element (b, t, h, c) at b*sB + t*sT +
    h*sH + c, u row b*u_batch_stride + h. Returns (out in the operands'
    layout, state (B*H, hd, hd))."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd}: the CUDA kernel takes {HEAD_DIMS}")
    dev = r.device
    out = torch.empty_like(r)
    state = torch.empty((B * H, hd, hd), dtype=torch.float32, device=dev)
    if dev.type == "meta":
        cost_analysis.kernel_flops(cost(r, k, v, logw, u)[0])
        return out, state
    sB, sT, sH = strides
    err = build.library().wkv6_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
        u.data_ptr(), out.data_ptr(), state.data_ptr(), B, H, T, hd, sB, sT,
        sH, u_batch_stride, dev.index, stream_of(dev))
    build.check_launch("wkv6", err)
    wkv6.launches += 1
    return out, state


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         logw: torch.Tensor, u: torch.Tensor):
    """r/k/v/logw (BH, T, hd) f32 with T % CHUNK == 0 and logw in
    [MIN_LOGW, 0]; u (BH, hd) f32. Zero initial state. Returns (out (BH, T,
    hd) f32, state (BH, hd, hd) f32), state[b, c, d] the key-c value-d
    entry after the last step. No backward: inputs that require grad
    raise while grad mode is on (`checks.refuse_grad`)."""
    dev = kernel_device(meta=True, r=r, k=k, v=v, logw=logw, u=u)
    refuse_grad("wkv6", r=r, k=k, v=v, logw=logw, u=u)
    BH, T, hd = r.shape
    if T % CHUNK:
        raise ValueError(f"T = {T} is not a multiple of CHUNK = {CHUNK}")
    for name, t in (("r", r), ("k", k), ("v", v), ("logw", logw)):
        check(name, t, torch.float32, (BH, T, hd), aligned=dev.type == "cuda")
    check("u", u, torch.float32, (BH, hd))
    if dev.type == "cpu":
        return ref_wkv6(r, k, v, logw, u)
    return _launch(r, k, v, logw, u, BH, 1, T, hd, (T * hd, hd, 0), 1)


def launch_heads(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 logw: torch.Tensor, u: torch.Tensor):
    """The kernel on the model's layout, CUDA (or `meta`) tensors only:
    r/k/v/logw (B, T, H, hd) f32 contiguous, any T (the last chunk's
    missing steps count as state-neutral); u (H, hd) f32. Returns (out
    (B, T, H, hd), state (B, H, hd, hd))."""
    dev = kernel_device(meta=True, r=r, k=k, v=v, logw=logw, u=u)
    refuse_grad("wkv6", r=r, k=k, v=v, logw=logw, u=u)
    if dev.type not in ("cuda", "meta"):
        raise ValueError(f"launch_heads runs the CUDA kernel; got {dev}")
    B, T, H, hd = r.shape
    for name, t in (("r", r), ("k", k), ("v", v), ("logw", logw)):
        check(name, t, torch.float32, (B, T, H, hd),
              aligned=dev.type == "cuda")
    check("u", u, torch.float32, (H, hd))
    out, state = _launch(r, k, v, logw, u, B, H, T, hd,
                         (T * H * hd, H * hd, hd), 0)
    return out, state.reshape(B, H, hd, hd)


wkv6.launches = 0
