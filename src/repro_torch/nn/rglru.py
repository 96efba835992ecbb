"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427),
the port of `repro.nn.rglru`.

Block = [linear in (x, gate branches)] -> causal depthwise conv1d -> RG-LRU
-> gated output projection. The full-sequence recurrence h_t = a_t h_{t-1}
+ b_t is a log-depth (Hillis–Steele) scan over T in plain PyTorch: about
log2(T) passes of elementwise products (12 at T = 4096) instead of T
sequential steps. The JAX package's `associative_scan` combines in
another tree, so the two agree to f32 rounding (the tests hold them at
rtol = atol = 1e-5). Decode mode is a single state update.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.nn.basic import gelu
from repro_torch.nn.params import ParamDef

_C = 8.0  # Griffin's fixed scaling constant in a_t = exp(-c * softplus(Λ) * r_t)


def rglru_defs(cfg):
    d, w = cfg.d_model, cfg.resolved_rnn_width
    return {
        "w_x": ParamDef((d, w), ("embed", "rnn")),
        "w_gate": ParamDef((d, w), ("embed", "rnn")),
        "conv_w": ParamDef((cfg.conv1d_width, w), (None, "rnn"), "small"),
        "conv_b": ParamDef((w,), ("rnn",), "zeros"),
        "w_a": ParamDef((w, w), ("rnn", None), "small"),
        "w_i": ParamDef((w, w), ("rnn", None), "small"),
        "lam": ParamDef((w,), ("rnn",), "normal", 0.5),
        "w_out": ParamDef((w, d), ("rnn", "embed")),
    }


def _conv1d_full(p, x):
    """Causal depthwise conv; x (B,T,w)."""
    K = p["conv_w"].shape[0]
    T = x.shape[1]
    pads = F.pad(x, (0, 0, K - 1, 0))
    out = pads[:, 0:T] * p["conv_w"][0]
    for i in range(1, K):
        out = out + pads[:, i:i + T] * p["conv_w"][i]
    return out + p["conv_b"]


def _gates(p, xc):
    xf = xc.float()
    rf = torch.sigmoid(xf @ p["w_a"].float())
    i = torch.sigmoid(xf @ p["w_i"].float())
    log_a = -_C * F.softplus(p["lam"].float()) * rf
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    b = beta * i * xf
    return a, b


def linear_scan(a, b):
    """h_t = a_t h_{t-1} + b_t with h_{-1} = 0 along dim 1, by a log-depth
    Hillis–Steele scan: after the pass with offset o, (a_t, h_t) combine
    steps t-2o+1..t. a, b (B, T, w) f32; returns h (B, T, w)."""
    T = a.shape[1]
    o = 1
    while o < T:
        b = torch.cat([b[:, :o], torch.addcmul(b[:, o:], a[:, o:],
                                               b[:, :-o])], dim=1)
        if 2 * o < T:
            a = torch.cat([a[:, :o], a[:, o:] * a[:, :-o]], dim=1)
        o *= 2
    return b


def rglru_full(cfg, p, x):
    """x (B,T,d) -> (y (B,T,d), h_last (B,w) f32, conv_tail (B,K-1,w))."""
    gate = gelu(x @ p["w_gate"])
    xb = x @ p["w_x"]
    xc = _conv1d_full(p, xb)
    a, b = _gates(p, xc)
    hh = linear_scan(a, b)
    y = (hh.to(x.dtype) * gate) @ p["w_out"]
    # the last K-1 conv inputs, zero-padded on the left when T < K-1
    K = p["conv_w"].shape[0]
    conv_tail = F.pad(xb, (0, 0, K - 1, 0))[:, xb.shape[1]:]
    return y, hh[:, -1], conv_tail


def init_rglru_cache(cfg, batch: int, dtype, device) -> dict:
    w, K = cfg.resolved_rnn_width, cfg.conv1d_width
    return {"h": torch.zeros((batch, w), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, K - 1, w), dtype=dtype,
                                device=device)}


def rglru_decode(cfg, p, x, cache):
    """x (B,1,d), cache {'h' (B,w) f32, 'conv' (B,K-1,w)} -> (y, cache)."""
    gate = gelu(x @ p["w_gate"])
    xb = x @ p["w_x"]                                   # (B,1,w)
    hist = torch.cat([cache["conv"], xb.to(cache["conv"].dtype)], dim=1)
    xc = torch.einsum("bkw,kw->bw", hist, p["conv_w"]) + p["conv_b"]
    a, b = _gates(p, xc)                                # (B,w) f32
    h = a * cache["h"] + b
    y = ((h.to(x.dtype) * gate[:, 0, :]) @ p["w_out"])[:, None, :]
    return y, {"h": h, "conv": hist[:, 1:, :]}
