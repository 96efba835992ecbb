"""GQA attention at any sequence length through the flash kernel
(`repro.kernels.flash_attention.ops`)."""
from __future__ import annotations

import torch.nn.functional as F

from repro_torch.kernels.flash_attention import BK, BQ
from repro_torch.kernels.flash_attention.kernel import flash_attention


def gqa_flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q (B, S, H, hd); k, v (B, S, KV, hd). Pads S with zeros to the block
    size, runs the kernel, unpads. Unlike the JAX wrapper it does not
    repeat the KV heads: the kernel indexes them."""
    S = q.shape[1]
    pad = -(-S // max(BQ, BK)) * max(BQ, BK) - S

    def prep(x):
        return F.pad(x, (0, 0, 0, 0, 0, pad)).contiguous()

    out = flash_attention(prep(q), prep(k), prep(v), causal=causal,
                          window=window)
    return out[:, :S]
