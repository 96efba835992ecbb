"""Per-kind transformer blocks (`repro.nn.blocks`) for the kinds the port
serves: `rwkv`, `rglru`, `local` and `attn` (`local` with window 0).

apply_layer contract:
    x, cache = apply_layer(cfg, kind, p, x, mode=..., positions=...,
                           cache=..., pos=...)
  mode     : 'train' | 'prefill' | 'decode'
  cache    : kind-specific dict (see init_layer_cache); None for 'train'
  pos      : decode position (int)

The other kinds (`attn_moe`, `xattn`, `encdec`, `enc`) raise
NotImplementedError until ROADMAP A10 ports them; the MoE auxiliary loss
of the reference's contract goes with them.

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

PORTED_KINDS = ("attn", "local", "rglru", "rwkv")


def check_kind(kind: str) -> None:
    if kind not in PORTED_KINDS:
        raise NotImplementedError(
            f"layer kind {kind!r} is not ported yet (ROADMAP A10); the port "
            f"serves {PORTED_KINDS}")


# --------------------------------------------------------------------- defs
def layer_defs(cfg, kind: str):
    check_kind(kind)
    if kind in ("attn", "local"):
        return {"norm1": norm_defs(cfg), "attn": attn.attn_defs(cfg),
                "norm2": norm_defs(cfg), "mlp": mlp_defs(cfg)}
    if kind == "rglru":
        return {"norm1": norm_defs(cfg), "rglru": rg.rglru_defs(cfg),
                "norm2": norm_defs(cfg), "mlp": mlp_defs(cfg)}
    return {"norm1": norm_defs(cfg), "norm2": norm_defs(cfg),
            **rk.rwkv_defs(cfg)}


def _window(cfg, kind: str) -> int:
    return cfg.sliding_window if kind == "local" else 0


# -------------------------------------------------------------------- cache
def init_layer_cache(cfg, kind: str, batch: int, length: int, dtype, device):
    """`length` = max decode length (KV cache size). Windowed layers use a
    ring buffer of `min(window, length)`."""
    check_kind(kind)
    if kind == "attn":
        return attn.init_kv_cache(cfg, batch, length, dtype, device)
    if kind == "local":
        w = min(cfg.sliding_window or length, length)
        return attn.init_kv_cache(cfg, batch, w, dtype, device)
    if kind == "rglru":
        return rg.init_rglru_cache(cfg, batch, dtype, device)
    return rk.init_rwkv_cache(cfg, batch, dtype, device)


def ring_cache(t: torch.Tensor, window: int) -> torch.Tensor:
    """Keys or values (B, S, KV, hd) of positions 0..S-1 as a ring buffer
    of length `window`: position p in slot p % window, the last `window`
    positions kept, zero slots when S < window."""
    B, S = t.shape[:2]
    if S < window:
        ring = t.new_zeros((B, window) + t.shape[2:])
        ring[:, :S] = t
        return ring
    return torch.roll(t[:, S - window:], shifts=S % window, dims=1)


# -------------------------------------------------------------------- apply
def apply_layer(cfg, kind: str, p, x, *, mode: str = "train",
                positions=None, cache=None, pos=None):
    check_kind(kind)
    if mode == "decode":
        return _decode_layer(cfg, kind, p, x, cache, pos)
    return _full_layer(cfg, kind, p, x, positions, mode)


def _full_layer(cfg, kind, p, x, positions, mode):
    new_cache = None
    if kind == "rwkv":
        xt = apply_norm(cfg, p["norm1"], x)
        h, state = rk.rwkv_time_mix_full(cfg, p["tmix"], xt)
        x = x + h
        xn = apply_norm(cfg, p["norm2"], x)
        x = x + rk.rwkv_channel_mix_full(cfg, p["cmix"], xn)
        if mode == "prefill":
            new_cache = {"state": state, "x_t": xt[:, -1], "x_c": xn[:, -1]}
        return x, new_cache

    if kind == "rglru":
        h, h_last, conv_tail = rg.rglru_full(cfg, p["rglru"],
                                             apply_norm(cfg, p["norm1"], x))
        x = x + h
        x = x + apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["norm2"], x))
        if mode == "prefill":
            new_cache = {"h": h_last, "conv": conv_tail}
        return x, new_cache

    window = _window(cfg, kind)
    h, (k, v) = attn.self_attention(cfg, p["attn"],
                                    apply_norm(cfg, p["norm1"], x),
                                    positions, window=window)
    x = x + h
    x = x + apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["norm2"], x))
    if mode == "prefill":
        if window:
            k, v = ring_cache(k, window), ring_cache(v, window)
        new_cache = {"k": k, "v": v}
    return x, new_cache


def _decode_layer(cfg, kind, p, x, cache, pos):
    if kind == "rwkv":
        xn = apply_norm(cfg, p["norm1"], x)
        h, state = rk.rwkv_tmix_decode(cfg, p["tmix"], xn, cache["state"],
                                       cache["x_t"])
        x = x + h
        xc = apply_norm(cfg, p["norm2"], x)
        x = x + rk.rwkv_cmix_decode(cfg, p["cmix"], xc, cache["x_c"])
        return x, {"state": state, "x_t": xn[:, 0], "x_c": xc[:, 0]}

    if kind == "rglru":
        h, new_cache = rg.rglru_decode(cfg, p["rglru"],
                                       apply_norm(cfg, p["norm1"], x), cache)
        x = x + h
        x = x + apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["norm2"], x))
        return x, new_cache

    h, new_cache = attn.decode_self_attention(
        cfg, p["attn"], apply_norm(cfg, p["norm1"], x), cache, pos,
        window=_window(cfg, kind))
    x = x + h
    x = x + apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["norm2"], x))
    return x, new_cache
