"""Self/cross attention with GQA/MQA, RoPE, sliding windows and KV caches
(`repro.nn.attention`).

Shapes: x (B, S, d); q (B, S, H, hd); k/v (B, S, KV, hd). The full-
sequence paths run through kernel B4 (`repro_torch.kernels.
flash_attention`) at every S: self-attention causal and optionally
banded, or bidirectional (`enc` layers), with the logit soft-cap where
the config sets one; cross-attention (`xattn`, `encdec`) unmasked over
the frontend's or the encoder's keys, whose length the kernel takes as
its key bound. On CPU tensors its plain PyTorch version computes them.
Decode (one query) uses the plain `_sdpa`, for cross-attention too.

B4 has no backward. Training asks for the differentiable path
(`differentiable=True`), the reference's own training code: `_sdpa` with
`causal_mask`, or `_chunked_sdpa` over query chunks above
`CHUNK_THRESHOLD` tokens, in plain PyTorch that autograd differentiates.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import gqa_flash_attention
from repro_torch.nn.basic import rotary
from repro_torch.nn.params import ParamDef

NEG_INF = -2.0e38


def attn_defs(cfg, cross: bool = False):
    """The projections of self- or (`cross`) cross-attention: the same
    shapes (the reference's `cross` changes nothing but its name)."""
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


# Sequences longer than this are processed in query chunks on the
# differentiable path: no (S, S) buffer is ever made, the per-chunk (B, H,
# Q_CHUNK, S) logits are the only transient. Exact numerics.
CHUNK_THRESHOLD = 8192
Q_CHUNK = 512


def _chunked_sdpa(cfg, q, k, v, *, window: int):
    """Causal (optionally banded) `_sdpa` over query chunks of Q_CHUNK
    (S % Q_CHUNK == 0), each against all S keys under its rows of the
    mask, as the reference's `lax.scan` computes it."""
    S = q.shape[1]
    kpos = torch.arange(S, device=q.device)[None, :]
    outs = []
    for off in range(0, S, Q_CHUNK):
        qpos = off + torch.arange(Q_CHUNK, device=q.device)[:, None]
        m = kpos <= qpos
        if window and window > 0:
            m &= kpos > qpos - window
        outs.append(_sdpa(cfg, q[:, off:off + Q_CHUNK], k, v, m[None]))
    return torch.cat(outs, dim=1)


def _plain_self_attention(cfg, q, k, v, *, window: int, causal: bool):
    """The differentiable full-sequence attention of the reference's
    training path: unmasked when not `causal`, query chunks above
    CHUNK_THRESHOLD, else one `_sdpa` under `causal_mask`."""
    S = q.shape[1]
    if not causal:
        return _sdpa(cfg, q, k, v, None)
    if S > CHUNK_THRESHOLD and S % Q_CHUNK == 0:
        return _chunked_sdpa(cfg, q, k, v, window=window)
    return _sdpa(cfg, q, k, v, causal_mask(S, S, window, device=q.device))


def _project_qkv(cfg, p, x, positions):
    q = torch.einsum("bsd,dhe->bshe", x, p["wq"])
    k = torch.einsum("bsd,dke->bske", x, p["wk"])
    v = torch.einsum("bsd,dke->bske", x, p["wv"])
    if cfg.use_rope:
        q = rotary(q, positions, cfg.rope_theta)
        k = rotary(k, positions, cfg.rope_theta)
    return q, k, v


def self_attention(cfg, p, x, positions, *, window: int = 0,
                   causal: bool = True, differentiable: bool = False):
    """Full-sequence self attention (train / prefill) through kernel B4:
    causal, banded to `window` keys when window > 0, or bidirectional
    when not `causal` (`enc` layers; the reference passes an all-ones
    mask), with the logits soft-capped at `cfg.attn_logit_softcap` when
    it is set (grok-1); `differentiable` takes the plain path instead
    (`_plain_self_attention`). Returns (out, (k, v))."""
    q, k, v = _project_qkv(cfg, p, x, positions)
    if differentiable:
        out = _plain_self_attention(cfg, q, k, v, window=window,
                                    causal=causal)
    else:
        out = gqa_flash_attention(q, k, v, causal=causal, window=window,
                                  softcap=cfg.attn_logit_softcap)
    out = torch.einsum("bshe,hed->bsd", out, p["wo"])
    return out, (k, v)


def cross_attention(cfg, p, x, kv, *, differentiable: bool = False):
    """x (B, Sq, d) attends, unmasked, to precomputed (k, v) (B, Se, KV,
    hd) of the frontend or the encoder (no RoPE on cross-attention).
    Several queries (train / prefill) go through kernel B4, not causal,
    with Se as its key bound; one query (decode), and the
    `differentiable` path, through the plain `_sdpa`."""
    k, v = kv
    q = torch.einsum("bsd,dhe->bshe", x, p["wq"])
    if q.shape[1] == 1 or differentiable:
        out = _sdpa(cfg, q, k, v, None)
    else:
        out = gqa_flash_attention(q, k, v, causal=False,
                                  softcap=cfg.attn_logit_softcap)
    return torch.einsum("bshe,hed->bsd", out, p["wo"])


def project_kv(cfg, p, y):
    """Frontend / encoder output y (B, Se, d) to the (k, v) that
    cross-attention reads (no RoPE)."""
    k = torch.einsum("bsd,dke->bske", y, p["wk"])
    v = torch.einsum("bsd,dke->bske", y, p["wv"])
    return k, v


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
