"""Multi-head RWKV6 time-mix core through the WKV6 kernel
(`repro.kernels.wkv6.ops`)."""
from __future__ import annotations

import torch.nn.functional as F

from repro_torch.kernels.wkv6 import CHUNK
from repro_torch.kernels.wkv6.kernel import launch_heads, wkv6


def wkv6_heads(r, k, v, logw, u):
    """r/k/v/logw (B, T, H, hd) f32; u (H, hd). Returns (out (B, T, H,
    hd), final state (B, H, hd, hd)). On the card (and on `meta`, the
    dry run) the kernel reads this layout as it is, any T. On the CPU the
    plain version runs on (B*H, T, hd) copies with T padded to CHUNK by
    logw = 0 (no decay) and k = 0 — state-neutral steps, as
    `repro.nn.rwkv` masks them."""
    if r.device.type in ("cuda", "meta"):
        uf = u.float().contiguous()
        return launch_heads(*(a.contiguous() for a in (r, k, v, logw)), uf)
    B, T, H, hd = r.shape
    pad = (-T) % CHUNK

    def prep(x):
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        return x.transpose(1, 2).reshape(B * H, T + pad, hd).contiguous()

    uf = u.float()[None].expand(B, H, hd).reshape(B * H, hd).contiguous()
    out, state = wkv6(prep(r), prep(k), prep(v), prep(logw), uf)
    out = out.reshape(B, H, T + pad, hd).transpose(1, 2)[:, :T]
    return out, state.reshape(B, H, hd, hd)
