"""RWKV-6 "Finch" layer (arXiv:2404.05892): time-mix with data-dependent
per-channel decay + channel-mix (`repro.nn.rwkv`).

The full-sequence WKV recurrence runs through kernel B5
(`repro_torch.kernels.wkv6`), the chunked factorization of the JAX
package's `_wkv_chunked` with a zero initial state; on CPU tensors the
kernel's plain PyTorch version computes it. As in the reference, the
ddlerp token-shift LoRA of full RWKV-6 is simplified to static
interpolation weights; the data-dependent decay is implemented.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.wkv6 import CHUNK, wkv6_heads
from repro_torch.nn.params import ParamDef

LORA_R = 32
# Per-step log-decay is clamped to >= MIN_LOGW so the intra-chunk
# factorization exp(Lc_t)·exp(-Lc_s) stays inside f32 range:
# |CHUNK * MIN_LOGW| = 80 < log(f32_max) ~ 88.
MIN_LOGW = -5.0


def _heads(cfg):
    hd = cfg.rwkv_head_dim
    H = cfg.d_model // hd
    return H, hd


def rwkv_defs(cfg):
    d, f = cfg.d_model, cfg.d_ff
    H, hd = _heads(cfg)
    D = H * hd
    mix = {f"mu_{n}": ParamDef((d,), ("embed",), "zeros") for n in
           ("r", "k", "v", "g", "w")}
    tmix = dict(
        mix,
        w_r=ParamDef((d, D), ("embed", "rnn")),
        w_k=ParamDef((d, D), ("embed", "rnn")),
        w_v=ParamDef((d, D), ("embed", "rnn")),
        w_g=ParamDef((d, D), ("embed", "rnn")),
        w0=ParamDef((D,), ("rnn",), "normal", 0.5),
        w_lora_a=ParamDef((d, LORA_R), ("embed", None), "small"),
        w_lora_b=ParamDef((LORA_R, D), (None, "rnn"), "small"),
        u=ParamDef((D,), ("rnn",), "small"),
        ln_scale=ParamDef((D,), ("rnn",), "ones"),
        w_o=ParamDef((D, d), ("rnn", "embed")),
    )
    cmix = dict(
        mu_ck=ParamDef((d,), ("embed",), "zeros"),
        mu_cr=ParamDef((d,), ("embed",), "zeros"),
        w_ck=ParamDef((d, f), ("embed", "mlp")),
        w_cv=ParamDef((f, d), ("mlp", "embed")),
        w_cr=ParamDef((d, d), ("embed", "embed")),
    )
    return {"tmix": tmix, "cmix": cmix}


def _lerp(x, x_prev, mu):
    """x + (x_prev - x) * mu in one op."""
    return torch.lerp(x, x_prev, mu)


def _shift(x):
    """x (B, T, d) delayed by one step, zero first."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def _decay(p, xw):
    """log-decay (negative) per channel: w = exp(-exp(w0 + lora(x)))."""
    lora = (xw @ p["w_lora_a"]) @ p["w_lora_b"]
    logw = -torch.exp(p["w0"].float() + lora.float())
    return torch.clamp(logw, min=MIN_LOGW)


def _group_norm(p, x, H, hd, eps=1e-5):
    """Per-head normalization (no affine) times ln_scale, in f32."""
    B, T, D = x.shape
    xg = F.layer_norm(x.reshape(B, T, H, hd).float(), (hd,), eps=eps)
    return (xg.reshape(B, T, D) * p["ln_scale"].float()).to(x.dtype)


def _tmix_project(cfg, p, x, x_prev):
    r = _lerp(x, x_prev, p["mu_r"]) @ p["w_r"]
    k = _lerp(x, x_prev, p["mu_k"]) @ p["w_k"]
    v = _lerp(x, x_prev, p["mu_v"]) @ p["w_v"]
    g = _lerp(x, x_prev, p["mu_g"]) @ p["w_g"]
    logw = _decay(p, _lerp(x, x_prev, p["mu_w"]))
    return r, k, v, g, logw


def wkv_inputs(cfg, p, x):
    """The WKV operands of the time-mix on x (B, T, d): r, k, v, logw
    (B, T_pad, H, hd) f32 with T padded to CHUNK by state-neutral steps
    (k = 0, logw = 0), u (H, hd) f32, and the gate g (B, T, D)."""
    B, T, _ = x.shape
    H, hd = _heads(cfg)
    pad = (-T) % CHUNK
    xp = F.pad(x, (0, 0, 0, pad))
    r, k, v, g, logw = _tmix_project(cfg, p, xp, _shift(xp))
    shp = (B, T + pad, H, hd)
    rf, kf, vf = (a.float().reshape(shp) for a in (r, k, v))
    lw = logw.reshape(shp)
    if pad:  # padded steps: w=1 (logw=0), k=0 -> state untouched
        mask = (torch.arange(T + pad, device=x.device) < T)[None, :, None,
                                                            None]
        kf = kf * mask
        lw = lw * mask
    return rf, kf, vf, lw, p["u"].float().reshape(H, hd), g[:, :T]


def rwkv_time_mix_full(cfg, p, x):
    """x (B,T,d), zero initial state. Returns (y, final state (B,H,hd,hd)
    f32); the recurrence runs in kernel B5."""
    B, T, d = x.shape
    H, hd = _heads(cfg)
    rf, kf, vf, lw, u, g = wkv_inputs(cfg, p, x)
    out, state = wkv6_heads(rf, kf, vf, lw, u)
    out = out[:, :T].reshape(B, T, H * hd).to(x.dtype)
    out = _group_norm(p, out, H, hd) * F.silu(g)
    return out @ p["w_o"], state


def rwkv_channel_mix_full(cfg, p, x):
    kx = _lerp(x, _shift(x), p["mu_ck"]) @ p["w_ck"]
    kx = torch.relu(kx).square()
    rx = torch.sigmoid(_lerp(x, _shift(x), p["mu_cr"]) @ p["w_cr"])
    return rx * (kx @ p["w_cv"])


def init_rwkv_cache(cfg, batch: int, dtype, device) -> dict:
    H, hd = _heads(cfg)
    return {
        "state": torch.zeros((batch, H, hd, hd), dtype=torch.float32,
                             device=device),
        "x_t": torch.zeros((batch, cfg.d_model), dtype=dtype,
                           device=device),   # tmix shift state
        "x_c": torch.zeros((batch, cfg.d_model), dtype=dtype,
                           device=device),   # cmix shift state
    }


def rwkv_tmix_decode(cfg, p, x, state, x_prev):
    """One token time-mix. x (B,1,d); state (B,H,hd,hd) f32; x_prev (B,d).
    Returns (y (B,1,d), new_state)."""
    B = x.shape[0]
    H, hd = _heads(cfg)
    r, k, v, g, logw = _tmix_project(cfg, p, x, x_prev[:, None, :])
    rf = r.float().reshape(B, H, hd)
    kf = k.float().reshape(B, H, hd)
    vf = v.float().reshape(B, H, hd)
    w = torch.exp(logw.reshape(B, H, hd))
    u = p["u"].float().reshape(H, hd)
    kv = kf[..., :, None] * vf[..., None, :]
    out = torch.einsum("bhc,bhcd->bhd", rf, state + u[..., None] * kv)
    state = state * w[..., None] + kv
    out = out.reshape(B, 1, H * hd).to(x.dtype)
    out = _group_norm(p, out, H, hd) * F.silu(g)
    return out @ p["w_o"], state


def rwkv_cmix_decode(cfg, p, x, x_prev):
    """One token channel-mix. x (B,1,d); x_prev (B,d)."""
    xp = x_prev[:, None, :]
    kx = torch.relu(_lerp(x, xp, p["mu_ck"]) @ p["w_ck"]).square()
    rx = torch.sigmoid(_lerp(x, xp, p["mu_cr"]) @ p["w_cr"])
    return rx * (kx @ p["w_cv"])
