"""Per-kind transformer blocks (`repro.nn.blocks`), one `layer_defs` /
`apply_layer` pair for every kind of `repro_torch.common.LAYER_KINDS`:
`rwkv`, `rglru`, `local`, `attn` (`local` with window 0), `attn_moe`
(`attn` with the MoE FFN of `repro_torch.nn.moe`), `xattn` (gated
cross-attention to the frontend's embeddings + gated MLP), `encdec`
(causal self-attention, cross-attention to the encoder's output, MLP)
and `enc` (bidirectional self-attention + MLP, the encoder's layer).

apply_layer contract:
    x, cache, aux = apply_layer(cfg, kind, p, x, mode=..., positions=...,
                                cache=..., frontend=..., pos=..., aux=...)
  mode     : 'train' | 'prefill' | 'decode'
  cache    : kind-specific dict (see init_layer_cache); None for 'train'
             and for `enc`, which caches nothing
  frontend : (B, Se, d) frontend embeddings (`xattn`) or encoder output
             (`encdec`) for the full modes; decode reads the cache's
             `xk` / `xv` instead
  pos      : decode position (int)
  aux      : accumulated auxiliary loss (MoE load balance); `attn_moe`
             adds its layer's, the other kinds return it as given
  differentiable : full modes only; attention and the WKV recurrence run
             their plain differentiable paths instead of kernels B4 / B5,
             which have no backward (the trainer's `loss_fn` asks for it)

On a mesh of more than one position (x a `placement.ShardedTensor`,
`repro_torch.models.decoder_lm`'s sharded path) every kind runs through
the sharded branches of `apply_norm`, `self_attention`,
`decode_self_attention`, `cross_attention`, `project_kv`, `apply_mlp`,
`apply_moe`, `rwkv` and `rglru` (`frontend` and the cache's `xk` / `xv`
placed too), `ring_cache` takes each position's block and the `xattn`
gates scale each position's block; `differentiable` takes the plain
attention (`_sdpa` / `_chunked_sdpa`) and the plain WKV recurrence
(`_wkv_chunked`) on each position's heads, as the unplaced path does.

Two differences from the reference, both faults of the reference
recorded in ROADMAP C:
  * rwkv prefill caches the time-mix shift state as norm1 of the layer's
    INPUT at the last position, what decode stores and reads (the
    reference stores norm1 of the layer's output);
  * local prefill caches a ring of length `window` with position p in
    slot p % window, zero-padded when S < window, the layout decode
    writes and masks (the reference keeps the last keys in sequence
    order, right only when S is a multiple of the window).
"""
from __future__ import annotations

import torch

from repro_torch.nn import attention as attn
from repro_torch.nn import rglru as rg
from repro_torch.nn import rwkv as rk
from repro_torch.nn.basic import apply_mlp, apply_norm, mlp_defs, norm_defs
from repro_torch.nn.moe import apply_moe, apply_moe_decode, moe_defs
from repro_torch.nn.params import ParamDef
from repro_torch.sharding import placement as pl

# --------------------------------------------------------------------- defs
def layer_defs(cfg, kind: str):
    if kind in ("attn", "local", "enc"):
        return {"norm1": norm_defs(cfg), "attn": attn.attn_defs(cfg),
                "norm2": norm_defs(cfg), "mlp": mlp_defs(cfg)}
    if kind == "attn_moe":
        return {"norm1": norm_defs(cfg), "attn": attn.attn_defs(cfg),
                "norm2": norm_defs(cfg), "moe": moe_defs(cfg)}
    if kind == "rglru":
        return {"norm1": norm_defs(cfg), "rglru": rg.rglru_defs(cfg),
                "norm2": norm_defs(cfg), "mlp": mlp_defs(cfg)}
    if kind == "rwkv":
        return {"norm1": norm_defs(cfg), "norm2": norm_defs(cfg),
                **rk.rwkv_defs(cfg)}
    if kind == "xattn":
        return {"norm1": norm_defs(cfg),
                "xattn": attn.attn_defs(cfg, cross=True),
                "gate_attn": ParamDef((), (), "zeros"),
                "norm2": norm_defs(cfg), "mlp": mlp_defs(cfg),
                "gate_mlp": ParamDef((), (), "zeros")}
    if kind == "encdec":
        return {"norm1": norm_defs(cfg), "attn": attn.attn_defs(cfg),
                "normx": norm_defs(cfg),
                "xattn": attn.attn_defs(cfg, cross=True),
                "norm2": norm_defs(cfg), "mlp": mlp_defs(cfg)}
    raise ValueError(f"unknown layer kind {kind!r}")


def _window(cfg, kind: str) -> int:
    return cfg.sliding_window if kind == "local" else 0


# -------------------------------------------------------------------- cache
def init_layer_cache(cfg, kind: str, batch: int, length: int, dtype, device):
    """`length` = max decode length (KV cache size). Windowed layers use a
    ring buffer of `min(window, length)`. Cross-attention keeps the
    frontend's keys and values as `xk` / `xv`: `num_image_tokens` of them
    (`xattn`) or `encoder_seq` (`encdec`, beside its self-attention's
    `k` / `v`)."""
    if kind in ("attn", "attn_moe"):
        return attn.init_kv_cache(cfg, batch, length, dtype, device)
    if kind == "encdec":
        c = attn.init_kv_cache(cfg, batch, length, dtype, device)
        x = attn.init_kv_cache(cfg, batch, cfg.encoder_seq, dtype, device)
        return dict(c, xk=x["k"], xv=x["v"])
    if kind == "local":
        w = min(cfg.sliding_window or length, length)
        return attn.init_kv_cache(cfg, batch, w, dtype, device)
    if kind == "rglru":
        return rg.init_rglru_cache(cfg, batch, dtype, device)
    if kind == "rwkv":
        return rk.init_rwkv_cache(cfg, batch, dtype, device)
    if kind == "xattn":
        x = attn.init_kv_cache(cfg, batch, cfg.num_image_tokens, dtype,
                               device)
        return {"xk": x["k"], "xv": x["v"]}
    raise ValueError(kind)


def ring_cache(t: torch.Tensor, window: int) -> torch.Tensor:
    """Keys or values (B, S, KV, hd) of positions 0..S-1 as a ring buffer
    of length `window`: position p in slot p % window, the last `window`
    positions kept, zero slots when S < window. A placed t (the sequence
    never sharded) is ringed position by position."""
    if pl.is_sharded(t):
        return pl.local_map(lambda t_: ring_cache(t_, window), t)
    B, S = t.shape[:2]
    if S < window:
        ring = t.new_zeros((B, window) + t.shape[2:])
        ring[:, :S] = t
        return ring
    return torch.roll(t[:, S - window:], shifts=S % window, dims=1)


# -------------------------------------------------------------------- apply
def apply_layer(cfg, kind: str, p, x, *, mode: str = "train",
                positions=None, cache=None, frontend=None, pos=None,
                aux=0.0, differentiable: bool = False):
    if mode == "decode":
        return _decode_layer(cfg, kind, p, x, cache, pos, aux)
    return _full_layer(cfg, kind, p, x, positions, frontend, mode, aux,
                       differentiable)


def _token(x, i: int):
    """x[:, i] of (B, S, d) activations, placed or not."""
    if pl.is_sharded(x):
        return pl.local_map(lambda t: t[:, i], x, spec=(x.spec[0],
                                                        x.spec[2]))
    return x[:, i]


def _like(t, c):
    """A new cache entry `t` laid out as the entry `c` it replaces (a
    placed shift state split over its d is sliced back)."""
    return pl.relayout(t, c.spec) if pl.is_sharded(t) else t


def _ffn(cfg, kind, p, xn, aux, decode=False):
    """The layer's FFN on its normed input: the MoE for `attn_moe` (its
    aux loss added to `aux`), else the dense MLP."""
    if kind != "attn_moe":
        return apply_mlp(cfg, p["mlp"], xn), aux
    h, moe_aux = (apply_moe_decode if decode else apply_moe)(cfg, p["moe"],
                                                             xn)
    return h, aux + moe_aux


def _gated(gate, h):
    """tanh(gate) * h: the scalar gate (replicated where h is placed)
    times each position's block."""
    return pl.per_position(lambda h_, g: torch.tanh(g) * h_, h, gate)


def _gated_xattn(cfg, p, x, kv, differentiable=False):
    """`xattn`: x + tanh(gate_attn) * cross-attention, then x +
    tanh(gate_mlp) * MLP."""
    h = attn.cross_attention(cfg, p["xattn"], apply_norm(cfg, p["norm1"], x),
                             kv, differentiable=differentiable)
    x = x + _gated(p["gate_attn"], h)
    h = apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["norm2"], x))
    return x + _gated(p["gate_mlp"], h)


def _full_layer(cfg, kind, p, x, positions, frontend, mode, aux,
                differentiable):
    new_cache = None
    if kind == "rwkv":
        xt = apply_norm(cfg, p["norm1"], x)
        h, state = rk.rwkv_time_mix_full(cfg, p["tmix"], xt, differentiable)
        x = x + h
        xn = apply_norm(cfg, p["norm2"], x)
        x = x + rk.rwkv_channel_mix_full(cfg, p["cmix"], xn)
        if mode == "prefill":
            new_cache = {"state": state, "x_t": _token(xt, -1),
                         "x_c": _token(xn, -1)}
        return x, new_cache, aux

    if kind == "rglru":
        h, h_last, conv_tail = rg.rglru_full(cfg, p["rglru"],
                                             apply_norm(cfg, p["norm1"], x))
        x = x + h
        x = x + apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["norm2"], x))
        if mode == "prefill":
            new_cache = {"h": h_last, "conv": conv_tail}
        return x, new_cache, aux

    if kind == "xattn":
        xk, xv = attn.project_kv(cfg, p["xattn"], frontend)
        x = _gated_xattn(cfg, p, x, (xk, xv), differentiable)
        if mode == "prefill":
            new_cache = {"xk": xk, "xv": xv}
        return x, new_cache, aux

    # attention-style kinds
    window = _window(cfg, kind)
    h, (k, v) = attn.self_attention(cfg, p["attn"],
                                    apply_norm(cfg, p["norm1"], x),
                                    positions, window=window,
                                    causal=kind != "enc",
                                    differentiable=differentiable)
    x = x + h
    if kind == "encdec":
        xk, xv = attn.project_kv(cfg, p["xattn"], frontend)
        x = x + attn.cross_attention(cfg, p["xattn"],
                                     apply_norm(cfg, p["normx"], x),
                                     (xk, xv), differentiable=differentiable)
    h, aux = _ffn(cfg, kind, p, apply_norm(cfg, p["norm2"], x), aux)
    x = x + h
    if mode == "prefill" and kind != "enc":
        if window:
            k, v = ring_cache(k, window), ring_cache(v, window)
        new_cache = {"k": k, "v": v}
        if kind == "encdec":
            new_cache.update(xk=xk, xv=xv)
    return x, new_cache, aux


def _decode_layer(cfg, kind, p, x, cache, pos, aux):
    if kind == "rwkv":
        xn = apply_norm(cfg, p["norm1"], x)
        h, state = rk.rwkv_tmix_decode(cfg, p["tmix"], xn, cache["state"],
                                       cache["x_t"])
        x = x + h
        xc = apply_norm(cfg, p["norm2"], x)
        x = x + rk.rwkv_cmix_decode(cfg, p["cmix"], xc, cache["x_c"])
        return x, {"state": state, "x_t": _like(_token(xn, 0), cache["x_t"]),
                   "x_c": _like(_token(xc, 0), cache["x_c"])}, aux

    if kind == "rglru":
        h, new_cache = rg.rglru_decode(cfg, p["rglru"],
                                       apply_norm(cfg, p["norm1"], x), cache)
        x = x + h
        x = x + apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["norm2"], x))
        return x, new_cache, aux

    if kind == "xattn":
        return _gated_xattn(cfg, p, x, (cache["xk"], cache["xv"])), cache, aux

    h, kv = attn.decode_self_attention(
        cfg, p["attn"], apply_norm(cfg, p["norm1"], x),
        {"k": cache["k"], "v": cache["v"]}, pos, window=_window(cfg, kind))
    x = x + h
    new_cache = dict(cache, **kv)
    if kind == "encdec":
        x = x + attn.cross_attention(cfg, p["xattn"],
                                     apply_norm(cfg, p["normx"], x),
                                     (cache["xk"], cache["xv"]))
    h, aux = _ffn(cfg, kind, p, apply_norm(cfg, p["norm2"], x), aux,
                  decode=True)
    return x + h, new_cache, aux
