"""GQA attention at any sequence length through the flash kernel
(`repro.kernels.flash_attention.ops`)."""
from __future__ import annotations

import torch.nn.functional as F

from repro_torch.kernels.flash_attention import BK, BQ
from repro_torch.kernels.flash_attention.kernel import flash_attention


def _pad_to(x, block: int):
    """x (B, S, heads, hd) zero-padded along S to a multiple of `block`."""
    S = x.shape[1]
    return F.pad(x, (0, 0, 0, 0, 0, -(-S // block) * block - S)).contiguous()


def gqa_flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0, q_offset=None):
    """q (B, Sq, H, hd); k, v (B, Sk, KV, hd). Pads the queries and the
    keys with zeros, each to a multiple of the block size, runs the kernel
    with the true Sk as its key bound, and cuts the queries back to Sq.
    Unlike the JAX wrapper it does not repeat the KV heads: the kernel
    indexes them. Causal attention takes Sq == Sk (the causal mask alone
    would keep the padded keys out; the bound does too), or any Sq with
    `q_offset`, the position of query row 0 (a block of rows of a longer
    sequence; its padded rows see keys the real rows do not, and are cut
    off). `softcap` as in `flash_attention`."""
    Sq, Sk = q.shape[1], k.shape[1]
    block = max(BQ, BK)
    out = flash_attention(_pad_to(q, block), _pad_to(k, block),
                          _pad_to(v, block), causal=causal, window=window,
                          softcap=softcap, kv_len=Sk, q_offset=q_offset)
    return out[:, :Sq]
