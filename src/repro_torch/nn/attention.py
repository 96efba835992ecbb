"""Causal self-attention with GQA/MQA, RoPE, sliding windows and KV caches
(`repro.nn.attention`).

Shapes: x (B, S, d); q (B, S, H, hd); k/v (B, S, KV, hd). The full-
sequence path runs through kernel B4 (`repro_torch.kernels.
flash_attention`), at every S, causal and optionally banded; on CPU
tensors its plain PyTorch version computes it. Decode uses the plain
`_sdpa`. Cross-attention (`xattn`/`encdec`) waits for ROADMAP A10.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import gqa_flash_attention
from repro_torch.nn.basic import rotary
from repro_torch.nn.params import ParamDef

NEG_INF = -2.0e38


def attn_defs(cfg):
    d, H, KV, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                    cfg.resolved_head_dim)
    return {
        "wq": ParamDef((d, H, hd), ("embed", "heads", "head_dim")),
        "wk": ParamDef((d, KV, hd), ("embed", "kv_heads", "head_dim")),
        "wv": ParamDef((d, KV, hd), ("embed", "kv_heads", "head_dim")),
        "wo": ParamDef((H, hd, d), ("heads", "head_dim", "embed")),
    }


def _soft_cap(logits, cap):
    if cap and cap > 0.0:
        return torch.tanh(logits / cap) * cap
    return logits


def _sdpa(cfg, q, k, v, mask):
    """q (B,Sq,H,hd), k/v (B,Sk,KV,hd), mask broadcastable to (B,Sq,Sk).
    As in the reference: q scaled in f32 and rounded to its dtype, logits
    and softmax in f32, the weights rounded to v's dtype, f32 sums."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qf = (q.float() / torch.sqrt(torch.tensor(float(hd)))).to(q.dtype)
    qf = qf.reshape(B, Sq, KV, G, hd)
    logits = torch.einsum("bqkgh,bskh->bkgqs", qf.float(), k.float())
    logits = _soft_cap(logits, cfg.attn_logit_softcap)
    if mask is not None:
        bias = torch.where(mask, 0.0, NEG_INF).float()
        logits = logits + bias[:, None, None, :, :]
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", w.to(v.dtype).float(), v.float())
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def causal_mask(Sq: int, Sk: int, window: int = 0, offset: int = 0,
                device=None):
    """(1, Sq, Sk) causal (optionally banded) mask. `offset` = absolute
    position of query 0 minus key 0 (for prefill continuation)."""
    qpos = torch.arange(Sq, device=device)[:, None] + offset
    kpos = torch.arange(Sk, device=device)[None, :]
    m = kpos <= qpos
    if window and window > 0:
        m &= kpos > qpos - window
    return m[None]


def _project_qkv(cfg, p, x, positions):
    q = torch.einsum("bsd,dhe->bshe", x, p["wq"])
    k = torch.einsum("bsd,dke->bske", x, p["wk"])
    v = torch.einsum("bsd,dke->bske", x, p["wv"])
    if cfg.use_rope:
        q = rotary(q, positions, cfg.rope_theta)
        k = rotary(k, positions, cfg.rope_theta)
    return q, k, v


def self_attention(cfg, p, x, positions, *, window: int = 0):
    """Full-sequence causal self attention (train / prefill), banded to
    `window` keys when window > 0, through kernel B4. Returns
    (out, (k, v))."""
    if cfg.attn_logit_softcap:
        raise ValueError(f"{cfg.name}: the attention kernel has no logit "
                         f"soft-cap (attn_logit_softcap = "
                         f"{cfg.attn_logit_softcap})")
    q, k, v = _project_qkv(cfg, p, x, positions)
    out = gqa_flash_attention(q, k, v, causal=True, window=window)
    out = torch.einsum("bshe,hed->bsd", out, p["wo"])
    return out, (k, v)


# ----------------------------------------------------------------- decoding
def init_kv_cache(cfg, batch: int, length: int, dtype, device) -> dict:
    KV, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    shape = (batch, length, KV, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_self_attention(cfg, p, x, cache, pos: int, *, window: int = 0):
    """One-token decode. x (B,1,d); cache {'k','v'} (B,L,KV,hd); pos = index
    of the new token. For windowed layers the cache is a ring buffer of
    length `window` (position p in slot p % window). The new key and value
    are written into the cache's buffers in place (the JAX function
    returns updated copies); the returned dict holds the same buffers."""
    B = x.shape[0]
    L = cache["k"].shape[1]
    positions = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
    q, k, v = _project_qkv(cfg, p, x, positions)
    slot = pos % window if window > 0 else pos
    ck, cv = cache["k"], cache["v"]
    ck[:, slot] = k[:, 0].to(ck.dtype)
    cv[:, slot] = v[:, 0].to(cv.dtype)
    kpos = torch.arange(L, device=x.device)[None, :]
    # ring buffer: every slot written so far is within the window by
    # construction; RoPE was applied at absolute positions already
    valid = kpos <= (min(pos, L - 1) if window > 0 else pos)
    mask = valid[None].expand(B, 1, L)
    out = _sdpa(cfg, q, ck, cv, mask)
    out = torch.einsum("bshe,hed->bsd", out, p["wo"])
    return out, {"k": ck, "v": cv}
