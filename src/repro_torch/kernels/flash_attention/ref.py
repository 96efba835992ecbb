"""Plain PyTorch version of the flash-attention kernel
(`repro.kernels.flash_attention.ref.ref_attention`, in the GQA layout)."""
from __future__ import annotations

import torch

NEG_INF = -1.0e30


def ref_attention(q, k, v, *, causal: bool = True, window: int = 0,
                  softcap: float = 0.0, kv_len=None, q_offset: int = 0):
    """q (B, Sq, H, hd); k, v (B, Sk, KV, hd) with H % KV == 0. f32
    arithmetic, output in q's dtype. softcap > 0 caps the scaled logits
    to softcap * tanh(s / softcap) before the mask, as the reference's
    `repro.nn.attention._sdpa` does (its Pallas kernel has no cap).

    Keys at positions >= `kv_len` (None: Sk) take no part, on top of the
    causal / band mask: their logits would be -1e30, whose weight
    exp(-1e30 - max) is exactly 0 in f32, so they are cut off before the
    products and whatever they hold (padding, NaN) is never read.

    `q_offset` is the position of query row 0 in the causal mask (query
    i attends keys j <= i + q_offset, and within the window of it)."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if kv_len is not None and kv_len < Sk:
        k, v, Sk = k[:, :kv_len], v[:, :kv_len], int(kv_len)
    kf = k.float().repeat_interleave(H // KV, dim=2)
    vf = v.float().repeat_interleave(H // KV, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) / (hd ** 0.5)
    if softcap > 0.0:
        s = torch.tanh(s / softcap) * softcap
    if causal:
        qpos = torch.arange(Sq, device=q.device)[:, None] + q_offset
        kpos = torch.arange(Sk, device=q.device)[None, :]
        mask = kpos <= qpos
        if window > 0:
            mask &= kpos > qpos - window
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w, vf).to(q.dtype)
