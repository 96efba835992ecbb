"""Multi-head RWKV6 time-mix core through the WKV6 kernel
(`repro.kernels.wkv6.ops`)."""
from __future__ import annotations

import torch.nn.functional as F

from repro_torch.kernels.wkv6 import CHUNK
from repro_torch.kernels.wkv6.kernel import wkv6


def wkv6_heads(r, k, v, logw, u):
    """r/k/v/logw (B, T, H, hd) f32; u (H, hd). Pads T to CHUNK with
    logw = 0 (no decay) and k = 0 — state-neutral steps, as
    `repro.nn.rwkv` masks them. Returns (out (B, T, H, hd), final state
    (B, H, hd, hd))."""
    B, T, H, hd = r.shape
    pad = (-T) % CHUNK

    def prep(x):
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        return x.transpose(1, 2).reshape(B * H, T + pad, hd).contiguous()

    uf = u.float()[None].expand(B, H, hd).reshape(B * H, hd).contiguous()
    out, state = wkv6(prep(r), prep(k), prep(v), prep(logw), uf)
    out = out.reshape(B, H, T + pad, hd).transpose(1, 2)[:, :T]
    return out, state.reshape(B, H, hd, hd)
