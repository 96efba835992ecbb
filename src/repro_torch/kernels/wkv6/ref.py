"""Plain PyTorch version of the WKV6 kernel: the chunked factorization of
`repro.nn.rwkv._wkv_chunked` / `repro.kernels.wkv6.kernel._kernel`, with
a zero initial state."""
from __future__ import annotations

import torch

from repro_torch.kernels.wkv6 import CHUNK


def ref_wkv6(r, k, v, logw, u):
    """r/k/v/logw (BH, T, hd) f32 with T % CHUNK == 0, logw <= 0; u (BH, hd).
    Returns (out (BH, T, hd) f32, final state (BH, hd, hd) f32)."""
    BH, T, hd = r.shape
    tri = torch.tril(torch.ones((CHUNK, CHUNK), dtype=torch.float32,
                                device=r.device), diagonal=-1)
    S = torch.zeros((BH, hd, hd), dtype=torch.float32, device=r.device)
    out = torch.empty_like(r)
    for c0 in range(0, T, CHUNK):
        sl = slice(c0, c0 + CHUNK)
        rr, kk, vv, lw = r[:, sl], k[:, sl], v[:, sl], logw[:, sl]
        Lc = torch.cumsum(lw, dim=1)              # inclusive log cumprod
        rp = rr * torch.exp(Lc - lw)              # r_t prod_{s<t} w_s
        kd = kk * torch.exp(-Lc)                  # k_s / prod_{s'<=s} w
        A = torch.einsum("btc,bsc->bts", rp, kd) * tri
        diag = (rr * u[:, None] * kk).sum(-1, keepdim=True)
        out[:, sl] = (torch.einsum("bts,bsd->btd", A, vv) + diag * vv
                      + torch.einsum("btc,bcd->btd", rp, S))
        last = Lc[:, -1:]                          # (BH, 1, hd)
        kscale = kk * torch.exp(last - Lc)         # prod_{s<tau<=C} w
        S = S * torch.exp(last).transpose(1, 2) \
            + torch.einsum("bsc,bsd->bcd", kscale, vv)
    return out, S
