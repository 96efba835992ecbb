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

Tensor-parallel (x placed on a mesh, `repro_torch.sharding.placement`):
q is column-parallel over the heads, k and v over the KV heads or, by
`attn_defs`, the head dim; they are re-laid out so that each position
holds whole head dims for RoPE, then B4 runs once per position on its
own heads (the GQA groups stay whole; `differentiable` takes the plain
path there instead), and `wo` is row-parallel with an all-reduce.
Decode follows the cache's layout (`decoder_lm.cache_specs`): over KV
heads each position attends its own heads; over the head dim (the
reference's `cache_hd`) q, k and v take head-dim slices, the partial q.k
logits are all-reduced before the softmax, P.v runs on each slice, and
an all-to-all brings the heads back for `wo`; over the sequence (a batch
that the data axes do not divide: `fit_spec` moves them there) each
position scores its own key slice and the partial softmaxes are combined
(`_split_key_sdpa`), and only the position whose slice holds the new
token's slot writes it. Cross-attention on a placed
x reads a placed frontend or encoder output: `project_kv` is
column-parallel as k / v are, its full-sequence path re-lays k / v out to
whole heads for B4 (not causal, the key bound the frontend's length) as
self-attention does, and decode reads the placed `xk` / `xv` in the
cache's layout as self-attention decode reads `k` / `v`.

The query rows over "model" (`splits_rows`): where the reference's
`_seq_shard` splits them (context-parallel attention, logical axis
"qseq": `cfg.seq_shard_attn` and S >= 256, S % 16 == 0), and where the
query heads do not divide the axis (`fit_spec` then puts it on d of `wq`
and on the head dim of `wo`), the full-sequence paths of self- and
cross-attention split the rows instead of the heads: x padded to a
multiple of the axis, each position's partial q of its columns of x
reduce-scattered into its rows (or q's heads moved to the rows
all-to-all), B4 once per position on its rows against the whole k / v,
causal with its first row's position as the kernel's query offset (so
it reads the keys up to its last row only), or not causal with the keys'
bound; `differentiable` runs `_plain_self_attention` on the rows under
`causal_mask(..., offset)`. The output rows are re-laid out all-to-all
as `wo` is placed, the padding cut, and `wo` contracts them row-parallel.
Decode keeps the cache's layout and hands `wo` its output laid out so.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import gqa_flash_attention
from repro_torch.nn.basic import rotary
from repro_torch.nn.params import ParamDef
from repro_torch.sharding import placement as pl
from repro_torch.sharding.logical import (axis_sizes, entry_axes, fit_spec,
                                          spec)

NEG_INF = -2.0e38


def attn_defs(cfg, cross: bool = False):
    """The projections of self- or (`cross`) cross-attention: the same
    shapes (the reference's `cross` changes nothing but its name).

    When the KV heads do not divide the production model axis (16) but
    the query heads and the head dim do (GQA with 8 KV heads, MQA), wk
    and wv are sharded over the head dim (`cache_hd`), the layout of the
    KV cache, as in the reference."""
    d, H, KV, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                    cfg.resolved_head_dim)
    kv_nd = KV % 16 != 0
    hd_tp = kv_nd and H % 16 == 0 and hd % 16 == 0
    # kv_heads must be absent from the spec when cache_hd is used, or the
    # duplicate-axis guard of `spec` drops the hd entry
    kv_logical = ("embed", None, "cache_hd") if hd_tp \
        else ("embed", "kv_heads", "head_dim")
    return {
        "wq": ParamDef((d, H, hd), ("embed", "heads", "head_dim")),
        "wk": ParamDef((d, KV, hd), kv_logical),
        "wv": ParamDef((d, KV, hd), kv_logical),
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
    logits = torch.einsum("bqkgh,bskh->bkgqs",
                          _scaled_q(q, KV, hd).float(), k.float())
    w = _weights(cfg, logits, mask)
    out = torch.einsum("bkgqs,bskh->bqkgh", w.to(v.dtype).float(), v.float())
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def _scaled_q(q, KV: int, hd: int):
    """q / sqrt(hd) in f32, rounded to q's dtype, as (B, Sq, KV, G, -1)."""
    B, Sq, H = q.shape[:3]
    qf = (q.float() / torch.sqrt(torch.tensor(float(hd)))).to(q.dtype)
    return qf.reshape(B, Sq, KV, H // KV, q.shape[-1])


def _weights(cfg, logits, mask):
    """Soft-capped, masked f32 logits (B, KV, G, Sq, Sk) -> softmax."""
    logits = _soft_cap(logits, cfg.attn_logit_softcap)
    if mask is not None:
        bias = torch.where(mask, 0.0, NEG_INF).float()
        logits = logits + bias[:, None, None, :, :]
    return torch.softmax(logits, dim=-1)


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


def _chunked_sdpa(cfg, q, k, v, *, window: int, offset: int = 0):
    """Causal (optionally banded) `_sdpa` over query chunks of Q_CHUNK
    (Sq % Q_CHUNK == 0), each against all Sk keys under its rows of the
    mask, as the reference's `lax.scan` computes it; query row 0 stands
    at position `offset`."""
    S = q.shape[1]
    kpos = torch.arange(k.shape[1], device=q.device)[None, :]
    outs = []
    for off in range(0, S, Q_CHUNK):
        qpos = offset + off + torch.arange(Q_CHUNK, device=q.device)[:, None]
        m = kpos <= qpos
        if window and window > 0:
            m &= kpos > qpos - window
        outs.append(_sdpa(cfg, q[:, off:off + Q_CHUNK], k, v, m[None]))
    return torch.cat(outs, dim=1)


def _plain_self_attention(cfg, q, k, v, *, window: int, causal: bool,
                          offset: int = 0):
    """The differentiable full-sequence attention of the reference's
    training path: unmasked when not `causal`, query chunks above
    CHUNK_THRESHOLD keys, else one `_sdpa` under `causal_mask`. The
    queries may be rows of the keys' sequence, row 0 at position
    `offset` (a position's rows of the context-parallel split)."""
    Sq, Sk = q.shape[1], k.shape[1]
    if not causal:
        return _sdpa(cfg, q, k, v, None)
    if Sk > CHUNK_THRESHOLD and Sq % Q_CHUNK == 0:
        return _chunked_sdpa(cfg, q, k, v, window=window, offset=offset)
    return _sdpa(cfg, q, k, v, causal_mask(Sq, Sk, window, offset,
                                           device=q.device))


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
    if pl.is_sharded(x):
        return _sharded_self_attention(cfg, p, x, positions, window=window,
                                       causal=causal,
                                       differentiable=differentiable)
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
    if pl.is_sharded(x):
        return _sharded_cross_attention(cfg, p, x, kv, differentiable)
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
    cross-attention reads (no RoPE); column-parallel on a placed y."""
    if pl.is_sharded(y):
        return (pl.einsum("bsd,dke->bske", y, p["wk"]),
                pl.einsum("bsd,dke->bske", y, p["wv"]))
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
    if pl.is_sharded(x):
        return _sharded_decode_self_attention(cfg, p, x, cache, pos,
                                              window=window)
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


# ------------------------------------------------------------------ sharded
def _whole_head_dim(t):
    """k or v (B, S, KV, hd) placed so that every position holds whole
    head dims, which RoPE needs (it pairs dim i with i + hd / 2): the KV
    heads over the model axis where they divide it, else replicated."""
    return pl.relayout(t, fit_spec(spec("batch", "seq", "kv_heads", None),
                                   t.shape, t.mesh, fallback=False))


def _rope(cfg, t, positions):
    """RoPE on a placed q or k at its rows' placed positions."""
    return pl.local_map(lambda t_, p_: rotary(t_, p_, cfg.rope_theta), t,
                        positions)


def _sharded_kv(cfg, p, x, positions):
    k = _whole_head_dim(pl.einsum("bsd,dke->bske", x, p["wk"]))
    v = _whole_head_dim(pl.einsum("bsd,dke->bske", x, p["wv"]))
    return (_rope(cfg, k, positions) if cfg.use_rope else k), v


def _sharded_qkv(cfg, p, x, positions):
    q = pl.einsum("bsd,dhe->bshe", x, p["wq"])
    if cfg.use_rope:
        q = _rope(cfg, q, positions)
    return (q, *_sharded_kv(cfg, p, x, positions))


# ------------------------------------------- the query rows over "model"
def splits_rows(cfg, wq, S: int) -> bool:
    """Do S > 1 queries split their rows over "model": where the
    reference's `_seq_shard` splits them (`cfg.seq_shard_attn`, S >= 256,
    S % 16 == 0: context-parallel attention, logical axis "qseq"), and
    where the query heads do not divide the axis (`wq` then has it on
    d), so that no position runs the attention of all heads?"""
    n = axis_sizes(wq.mesh).get("model", 1)
    if S == 1 or n == 1:
        return False
    return (cfg.seq_shard_attn and S >= 256 and S % 16 == 0) \
        or "model" not in entry_axes(wq.spec[1])


def _row_queries(cfg, wq, x, positions=None):
    """q of the placed x (B, S, d) with its rows split over "model",
    padded with zero rows to a multiple of the axis: (B, S_pad, H, hd)
    placed ("data", "model", None, None). With "model" on d of `wq` each
    position's partial q of its columns of x are summed in f32 into its
    rows (`reduce_scatter`); q column-parallel over the heads moves its
    axis to the rows (all-to-all). RoPE at the rows' `positions` where
    they are given."""
    n = axis_sizes(x.mesh)["model"]
    pad = (-x.shape[1]) % n
    rows = (x.spec[0], "model")
    if pad:
        x = pl.local_map(lambda t: F.pad(t, (0, 0, 0, pad)), x)
    q = pl.relayout(pl.einsum("bsd,dhe->bshe", x, wq, scatter_dim=1),
                    (*rows, None, None))
    if positions is None:
        return q
    if pad:
        positions = pl.local_map(lambda t: F.pad(t, (0, pad)), positions)
    return _rope(cfg, q, pl.relayout(positions, rows))


def _row_attention(cfg, q, k, v, *, causal: bool, window: int = 0,
                   differentiable: bool = False):
    """Each position's query rows (`_row_queries`) against the whole k / v:
    B4 once per position, causal with its first row's position as the
    query offset (so that it reads only the keys up to its last row), or
    not causal with the keys' length as its bound; the plain
    `_plain_self_attention` under the same mask when `differentiable`."""
    rep = (k.spec[0], None, None, None)
    k, v = pl.relayout(k, rep), pl.relayout(v, rep)

    def attend(i):
        start = q.block(i, 1)[0] if causal else 0
        if differentiable:
            return _plain_self_attention(cfg, q.locals[i], k.locals[i],
                                         v.locals[i], window=window,
                                         causal=causal, offset=start)
        return gqa_flash_attention(q.locals[i], k.locals[i], v.locals[i],
                                   causal=causal, window=window,
                                   softcap=cfg.attn_logit_softcap,
                                   q_offset=start if causal else None)
    return pl.wrap([attend(i) for i in range(len(q.locals))], q.spec,
                   q.mesh)


def _row_output(out, wo, S: int):
    """The attention's output rows re-laid out as `wo` is placed (its
    heads or, the fallback, its head dim over "model"), the padded rows
    cut off, then `wo` row-parallel with its all-reduce."""
    out = pl.relayout(out, (out.spec[0], None, *wo.spec[:2]))
    if out.shape[1] != S:
        out = pl.local_map(lambda t: t[:, :S], out)
    return pl.einsum("bshe,hed->bsd", out, wo)


def _kv_for_heads(q, kv, i: int):
    """Position i's keys or values for its query heads: its own block of
    KV heads, or, where the KV heads are whole on every position (fewer
    than the model axis), the one group that its query heads read."""
    if kv.spec[2] is not None or q.spec[2] is None:
        if kv.spec[2] != q.spec[2]:
            raise NotImplementedError(f"query heads on {q.spec[2]}, KV "
                                      f"heads on {kv.spec[2]}")
        return kv.locals[i]
    G = q.shape[2] // kv.shape[2]
    start, size = q.block(i, 2)
    g0 = start // G
    if (start + size - 1) // G != g0:
        raise NotImplementedError(
            f"{size} query heads a position span two GQA groups of {G}; "
            f"not sharded yet (ROADMAP A, item 4)")
    return kv.locals[i][:, :, g0:g0 + 1]


def _per_position_attention(cfg, q, k, v, *, causal: bool, window: int = 0,
                            differentiable: bool = False):
    """Each position's query heads against the KV heads they read (k / v
    with whole head dims): B4 once per position, or the plain
    `_plain_self_attention` when `differentiable`."""
    def attend(i):
        kk, vv = _kv_for_heads(q, k, i), _kv_for_heads(q, v, i)
        if differentiable:
            return _plain_self_attention(cfg, q.locals[i], kk, vv,
                                         window=window, causal=causal)
        return gqa_flash_attention(q.locals[i], kk, vv, causal=causal,
                                   window=window,
                                   softcap=cfg.attn_logit_softcap)
    return pl.wrap([attend(i) for i in range(len(q.locals))], q.spec,
                   q.mesh)


def _sharded_self_attention(cfg, p, x, positions, *, window: int,
                            causal: bool, differentiable: bool = False):
    if splits_rows(cfg, p["wq"], x.shape[1]):
        k, v = _sharded_kv(cfg, p, x, positions)
        q = _row_queries(cfg, p["wq"], x,
                         positions if cfg.use_rope else None)
        out = _row_attention(cfg, q, k, v, causal=causal, window=window,
                             differentiable=differentiable)
        return _row_output(out, p["wo"], x.shape[1]), (k, v)
    q, k, v = _sharded_qkv(cfg, p, x, positions)
    out = _per_position_attention(cfg, q, k, v, causal=causal, window=window,
                                  differentiable=differentiable)
    return pl.einsum("bshe,hed->bsd", out, p["wo"]), (k, v)


def _sharded_cross_attention(cfg, p, x, kv, differentiable=False):
    """Several queries: B4 per position (the plain `_sdpa` when
    `differentiable`), not causal, over k / v re-laid out to whole heads;
    one query (decode): the placed `xk` / `xv` in the cache's layout, as
    `_sharded_decode_self_attention` reads `k` / `v`. Then the
    row-parallel `wo`."""
    k, v = kv
    if splits_rows(cfg, p["wq"], x.shape[1]):
        out = _row_attention(cfg, _row_queries(cfg, p["wq"], x), k, v,
                             causal=False, differentiable=differentiable)
        return _row_output(out, p["wo"], x.shape[1])
    q = pl.einsum("bsd,dhe->bshe", x, p["wq"])
    if q.shape[1] > 1:
        out = _per_position_attention(cfg, q, _whole_head_dim(k),
                                      _whole_head_dim(v), causal=False,
                                      differentiable=differentiable)
    else:
        out = _attend_cache(cfg, pl.relayout(q, _one_token(k.spec)), k, v,
                            lambda dev, start, size: None, p["wo"])
    return pl.einsum("bshe,hed->bsd", out, p["wo"])


def _sdpa_over_head_dim(cfg, q, k, v, mask, axis: str):
    """`_sdpa` with the head dim split over `axis`: each position's
    partial q.k logits, summed in f32 by `all_reduce_sum`, the softmax on
    every position, then P.v on each position's head-dim slice."""
    Sq, H, hd = q.shape[1:]
    L = k.shape[1]
    logits = pl.local_map(lambda q_, k_: torch.einsum(
        "bqkgh,bskh->bkgqs", _scaled_q(q_, k_.shape[2], hd).float(),
        k_.float()), q, k, spec=(q.spec[0], k.spec[2], None, None, None))
    w = pl.local_map(lambda lg: _weights(cfg, lg, mask(lg.device, 0, L)),
                     pl.all_reduce_sum(logits, axis))
    return pl.local_map(lambda w_, v_: torch.einsum(
        "bkgqs,bskh->bqkgh", w_.to(v_.dtype).float(), v_.float()).reshape(
        w_.shape[0], Sq, -1, v_.shape[-1]).to(q.dtype), w, v, spec=q.spec)


def _split_key_sdpa(cfg, q, k, v, mask):
    """`_sdpa` of one query over a cache whose sequence is split over an
    axis (a batch that the data axes do not divide: `fit_spec` moves them
    onto the sequence), and perhaps its head dim over another (whose
    partial q.k logits are summed in f32 first, as `_sdpa_over_head_dim`
    does). Each position scores its own key slice, masked at the slice's
    global key positions, and keeps its row max m, its sum l of
    exp(logit - m) and its unnormalised P.v (P rounded to v's dtype, as
    `_sdpa` rounds the weights), in f32; `all_gather` brings every
    position the (m, l, o) of the whole sequence (a few KB), and each
    combines them in axis order: o = sum_j e^(m_j - M) o_j / sum_j
    e^(m_j - M) l_j, M the largest m_j. Every copy holds the same bits."""
    sax, hax = k.spec[1], k.spec[3]
    hd = q.shape[3]

    def local(i):
        q_, k_, v_ = q.locals[i], k.locals[i], v.locals[i]
        return torch.einsum("bqkgh,bskh->bkgqs",
                            _scaled_q(q_, k_.shape[2], hd).float(), k_.float())
    logits = pl.wrap([local(i) for i in range(len(q.locals))],
                     (q.spec[0], k.spec[2], None, None, sax), q.mesh)
    if hax is not None:
        logits = pl.all_reduce_sum(logits, hax)

    def partial(i):
        s0, n = k.block(i, 1)
        lg = _soft_cap(logits.locals[i], cfg.attn_logit_softcap)
        m_ = mask(lg.device, s0, n)
        if m_ is not None:
            lg = lg + torch.where(m_, 0.0, NEG_INF).float()[:, None, None]
        m = lg.amax(-1)
        p_ = torch.exp(lg - m[..., None])
        v_ = v.locals[i]
        o = torch.einsum("bkgqs,bskh->bqkgh", p_.to(v_.dtype).float(),
                         v_.float())
        return torch.cat([m.flatten(), p_.sum(-1).flatten(),
                          o.flatten()])[None], (m.shape, o.shape)
    parts, shapes = zip(*(partial(i) for i in range(len(q.locals))))
    gathered = pl.all_gather(pl.wrap(parts, (sax, None), q.mesh), sax)

    def combine(i):
        (m_shape, o_shape), g = shapes[i], gathered.locals[i]
        nm, no = m_shape.numel(), o_shape.numel()
        ms = [r[:nm].view(m_shape) for r in g]
        M = ms[0]
        for m in ms[1:]:
            M = torch.maximum(M, m)
        num = den = None
        for m, r in zip(ms, g):
            e = torch.exp(m - M)
            lo = e * r[nm:2 * nm].view(m_shape)
            oo = r[2 * nm:2 * nm + no].view(o_shape) * \
                e.permute(0, 3, 1, 2)[..., None]
            num = oo if num is None else num + oo
            den = lo if den is None else den + lo
        out = num / den.permute(0, 3, 1, 2)[..., None]
        B, Sq = o_shape[:2]
        return out.reshape(B, Sq, -1, o_shape[-1]).to(q.dtype)
    return pl.wrap([combine(i) for i in range(len(q.locals))], q.spec,
                   q.mesh)


def _one_token(cache_spec):
    """The layout of one token's q, k or v beside a cache laid out by
    `cache_spec`: the cache's batch, head and head-dim entries, its
    sequence entry dropped (a split-key cache's axis stays free)."""
    return (cache_spec[0], None, *cache_spec[2:])


def _sharded_decode_self_attention(cfg, p, x, cache, pos: int, *,
                                   window: int):
    ck, cv = cache["k"], cache["v"]
    positions = pl.local_map(lambda t: torch.full(
        (t.shape[0], 1), pos, dtype=torch.int64, device=t.device), x,
        spec=x.spec[:2])
    q, k, v = _sharded_qkv(cfg, p, x, positions)
    # the reference's constraint sites: q, k and v take the cache's layout
    # (its head and head-dim entries; a sequence split stays with the keys)
    q, k, v = (pl.relayout(t, _one_token(c.spec))
               for t, c in ((q, ck), (k, ck), (v, cv)))
    slot = pos % window if window > 0 else pos
    # the positions whose block of the sequence holds the slot write it
    for i, (kl, vl, ckl, cvl) in enumerate(zip(k.locals, v.locals,
                                               ck.locals, cv.locals)):
        s0, n = ck.block(i, 1)
        if s0 <= slot < s0 + n:
            ckl[:, slot - s0] = kl[:, 0].to(ckl.dtype)
            cvl[:, slot - s0] = vl[:, 0].to(cvl.dtype)
    L = ck.shape[1]
    last = min(pos, L - 1) if window > 0 else pos

    def mask(dev, start, size):
        return (torch.arange(start, start + size, device=dev) <= last
                )[None, None]

    out = _attend_cache(cfg, q, ck, cv, mask, p["wo"])
    return pl.einsum("bshe,hed->bsd", out, p["wo"]), {"k": ck, "v": cv}


def _attend_cache(cfg, q, ck, cv, mask, wo):
    """One query's attention over a placed cache, q laid out as the cache
    is (`_one_token`): `_sdpa` per position, `_sdpa_over_head_dim` where
    the cache splits the head dim, `_split_key_sdpa` where it splits the
    sequence (and perhaps the head dim); the result laid out as `wo`
    contracts it (its heads, or the fallback's head dim, over "model").
    `mask(device, start, size)` gives the mask of the keys at positions
    start .. start + size - 1 (None: all)."""
    L = ck.shape[1]
    if ck.spec[1] is not None:
        out = _split_key_sdpa(cfg, q, ck, cv, mask)
    elif ck.spec[3] is None:
        out = pl.local_map(lambda q_, k_, v_: _sdpa(cfg, q_, k_, v_,
                                                    mask(q_.device, 0, L)),
                           q, ck, cv)
    else:
        out = _sdpa_over_head_dim(cfg, q, ck, cv, mask, ck.spec[3])
    return pl.relayout(out, (out.spec[0], None, *wo.spec[:2]))
