"""Wrapper of the flash-attention CUDA kernel (`csrc/flash_attention.cu`).

Replaces `repro.kernels.flash_attention.kernel.flash_attention` (a Pallas
TPU kernel). It takes the model's (batch, seq, heads, head_dim) layout
with fewer key/value heads than query heads (GQA/MQA) as they are: the
kernel reads key/value head h // (H / KV) for query head h. The JAX
kernel's (BH, S, hd) layout is the case H = KV = 1.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.checks import check, kernel_device, stream_of
from repro_torch.kernels.flash_attention import BK, BQ, HEAD_DIMS
from repro_torch.kernels.flash_attention.ref import ref_attention


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B, Sq, H, hd); k, v (B, Sk, KV, hd); Sq % BQ == 0 == Sk % BK,
    H % KV == 0; float32 or bfloat16. Causal attention, banded to the last
    `window` keys when window > 0 (no mask when not causal); softmax in
    f32, output (B, Sq, H, hd) in q's dtype.

    On the card the dtype picks one of two hand-written kernels: bfloat16
    runs Q K^T and P V on the tensor cores (wgmma, f32 accumulation, P
    rounded to bf16); float32 runs f32 FMAs on the CUDA cores (no TF32).
    Neither falls back to the other: a failed launch raises."""
    dev = kernel_device(q=q, k=k, v=v)
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if Sq % BQ or Sk % BK:
        raise ValueError(f"sequence lengths {Sq}, {Sk} must be multiples of "
                         f"{BQ}, {BK}")
    if KV == 0 or H % KV:
        raise ValueError(f"{H} query heads are not a multiple of {KV} "
                         f"key/value heads")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q: dtype {q.dtype}, expected float32 or bfloat16")
    check("q", q, q.dtype, aligned=dev.type == "cuda")
    check("k", k, q.dtype, (B, Sk, KV, hd), aligned=dev.type == "cuda")
    check("v", v, q.dtype, (B, Sk, KV, hd), aligned=dev.type == "cuda")
    window = int(window)
    if dev.type == "cpu":
        return ref_attention(q, k, v, causal=causal, window=window)
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd}: the CUDA kernel takes {HEAD_DIMS}")
    out = torch.empty_like(q)
    err = build.library().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq, Sk,
        H, KV, hd, int(causal), window, 1.0 / hd ** 0.5,
        int(q.dtype == torch.bfloat16), dev.index, stream_of(dev))
    build.check_launch("flash_attention", err)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
