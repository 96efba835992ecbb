"""Wrapper of the flash-attention CUDA kernel (`csrc/flash_attention.cu`).

Replaces `repro.kernels.flash_attention.kernel.flash_attention` (a Pallas
TPU kernel). It takes the model's (batch, seq, heads, head_dim) layout
with fewer key/value heads than query heads (GQA/MQA) as they are: the
kernel reads key/value head h // (H / KV) for query head h. The JAX
kernel's (BH, S, hd) layout is the case H = KV = 1.

On `meta` inputs (the dry run, `repro_torch.launch.dryrun`) the wrapper
makes its checks and returns an empty output of the kernel's shape and
dtype, handing the kernel's `cost` to the running
`launch.cost_analysis.analyze`: shape inference, as a `torch.library`
fake would give, not a fallback.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.checks import (check, kernel_device,
                                        refuse_grad, stream_of)
from repro_torch.kernels.flash_attention import (BK, BQ, HEAD_DIMS,
                                                 OFFSET_HEAD_DIMS)
from repro_torch.kernels.flash_attention.ref import ref_attention
from repro_torch.launch import cost_analysis


def pairs(Sq: int, Sk: int, *, causal: bool = True, window: int = 0,
          kv_len=None, q_offset=None) -> int:
    """The (query, key) pairs a row of heads attends: under the causal
    band (query i at position i + q_offset sees keys j <= that position,
    and within `window` of it when window > 0) and the key bound (keys
    j < kv_len); every key below the bound when not causal."""
    kv_len = Sk if kv_len is None else int(kv_len)
    if not causal:
        return Sq * kv_len
    pos = np.arange(Sq, dtype=np.int64) + int(q_offset or 0)
    hi = np.minimum(pos, kv_len - 1)
    lo = np.maximum(pos - window + 1, 0) if window > 0 else 0
    return int(np.maximum(hi - lo + 1, 0).sum())


def cost(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
         causal: bool = True, window: int = 0, softcap: float = 0.0,
         kv_len=None, q_offset=None):
    """(flops, bytes) of one call with these arguments: 4·B·H·hd flops
    for each (query, key) pair under the mask (`pairs`: Q K^T and P V,
    2 flops a multiply-add each), and q read and the output written once
    with the keys and values that the rows reach read once (causal: up to
    the last row's position; the key bound caps them)."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    n = pairs(Sq, Sk, causal=causal, window=window, kv_len=kv_len,
              q_offset=q_offset)
    reach = Sk if kv_len is None else int(kv_len)
    if causal:
        reach = min(reach, int(q_offset or 0) + Sq)
    nbytes = (2 * B * Sq * H * hd + 2 * B * reach * KV * hd) * q.element_size()
    return 4 * B * H * n * hd, nbytes


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0, kv_len=None,
                    q_offset=None) -> torch.Tensor:
    """q (B, Sq, H, hd); k, v (B, Sk, KV, hd); Sq % BQ == 0 == Sk % BK,
    H % KV == 0; float32 or bfloat16. Causal attention (Sq == Sk), banded
    to the last `window` keys when window > 0; not causal, any Sq and no
    mask but the key bound. With `q_offset` (>= 0, causal only) the
    queries are rows of a longer sequence, row 0 at position q_offset:
    query i attends keys j <= i + q_offset (any Sq and Sk), and keys past
    the rows' last position are never read; on the card an offset > 0
    runs the instances compiled with it (`OFFSET_HEAD_DIMS`, no soft-cap),
    an offset of 0 those without it. Softmax in f32, output (B, Sq, H, hd) in q's
    dtype. softcap > 0 caps the scaled logits to softcap * tanh(s /
    softcap) before the mask (grok-1); at 0 the kernels run compiled
    without the cap. Keys at positions >= `kv_len` (0 < kv_len <= Sk;
    None: Sk) take no part and are never read: the zero padding of a key
    length that is not a multiple of BK (an encoder's 1500 frames); at
    kv_len == Sk the kernels run compiled without the bound.

    On the card the dtype picks one of two hand-written kernels: bfloat16
    runs Q K^T and P V on the tensor cores (wgmma, f32 accumulation, P
    rounded to bf16); float32 runs f32 FMAs on the CUDA cores (no TF32).
    Neither falls back to the other: a failed launch raises. The kernel
    has no backward: with grad mode on, an input that requires grad
    raises (training goes through `repro_torch.nn.attention._sdpa`)."""
    dev = kernel_device(meta=True, q=q, k=k, v=v)
    refuse_grad("flash_attention", q=q, k=k, v=v)
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if Sq % BQ or Sk % BK:
        raise ValueError(f"sequence lengths {Sq}, {Sk} must be multiples of "
                         f"{BQ}, {BK}")
    if causal and Sq != Sk and q_offset is None:
        raise ValueError(f"causal attention needs Sq == Sk, got {Sq}, {Sk} "
                         f"(or a q_offset)")
    q_offset = 0 if q_offset is None else int(q_offset)
    if q_offset < 0 or (q_offset and not causal):
        raise ValueError(f"q_offset {q_offset}: expected >= 0, and 0 when "
                         f"not causal")
    kv_len = Sk if kv_len is None else int(kv_len)
    if not 0 < kv_len <= Sk:
        raise ValueError(f"kv_len {kv_len}: expected 0 < kv_len <= {Sk}")
    if KV == 0 or H % KV:
        raise ValueError(f"{H} query heads are not a multiple of {KV} "
                         f"key/value heads")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q: dtype {q.dtype}, expected float32 or bfloat16")
    check("q", q, q.dtype, aligned=dev.type == "cuda")
    check("k", k, q.dtype, (B, Sk, KV, hd), aligned=dev.type == "cuda")
    check("v", v, q.dtype, (B, Sk, KV, hd), aligned=dev.type == "cuda")
    window, softcap = int(window), float(softcap)
    if not softcap >= 0.0:
        raise ValueError(f"softcap {softcap}: expected >= 0 (0: no cap)")
    if dev.type == "meta":
        cost_analysis.kernel_flops(cost(
            q, k, v, causal=causal, window=window, kv_len=kv_len,
            q_offset=q_offset)[0])
        return torch.empty_like(q)
    if dev.type == "cpu":
        return ref_attention(q, k, v, causal=causal, window=window,
                             softcap=softcap, kv_len=kv_len,
                             q_offset=q_offset)
    dtype = str(q.dtype).removeprefix("torch.")
    dims = (OFFSET_HEAD_DIMS if q_offset else HEAD_DIMS)[dtype]
    if hd not in dims or (q_offset and softcap):
        raise ValueError(f"head dim {hd}: the CUDA kernel takes {dims} in "
                         f"{q.dtype}" + (" with a q_offset, without the "
                                         "soft-cap" if q_offset else ""))
    out = torch.empty_like(q)
    err = build.library().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq, Sk,
        kv_len, H, KV, hd, int(causal), window, q_offset, 1.0 / hd ** 0.5,
        softcap, int(q.dtype == torch.bfloat16), dev.index, stream_of(dev))
    build.check_launch("flash_attention", err)
    flash_attention.launches += 1
    if q_offset:
        flash_attention.offset_launches += 1
    return out


flash_attention.launches = 0
# the launches of the instances with a query offset (also in `launches`)
flash_attention.offset_launches = 0
