"""Plain PyTorch version of the flash-attention kernel
(`repro.kernels.flash_attention.ref.ref_attention`, in the GQA layout)."""
from __future__ import annotations

import torch

NEG_INF = -1.0e30


def ref_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q (B, Sq, H, hd); k, v (B, Sk, KV, hd) with H % KV == 0. f32
    arithmetic, output in q's dtype."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    kf = k.float().repeat_interleave(H // KV, dim=2)
    vf = v.float().repeat_interleave(H // KV, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) / (hd ** 0.5)
    if causal:
        qpos = torch.arange(Sq, device=q.device)[:, None]
        kpos = torch.arange(Sk, device=q.device)[None, :]
        mask = kpos <= qpos
        if window > 0:
            mask &= kpos > qpos - window
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w, vf).to(q.dtype)
