"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427),
the port of `repro.nn.rglru`.

Block = [linear in (x, gate branches)] -> causal depthwise conv1d -> RG-LRU
-> gated output projection. The full-sequence recurrence h_t = a_t h_{t-1}
+ b_t is a log-depth (Hillis–Steele) scan over T in plain PyTorch: about
log2(T) passes of elementwise products (12 at T = 4096) instead of T
sequential steps. The JAX package's `associative_scan` combines in
another tree, so the two agree to f32 rounding (the tests hold them at
rtol = atol = 1e-5). Decode mode is a single state update.

On a mesh (x a `placement.ShardedTensor`, the batch over "data") the
block is tensor-parallel over "rnn" (-> "model"): `w_x` and `w_gate`
column-parallel; the conv, `lam`, the scan and the state per channel, so
local; the gates contract the position's channels of the conv output
with its rows of `w_a` / `w_i` (rnn, None), and an f32 reduce-scatter of
the (B, T, w) partials leaves each position the sum on its channels (the
elements of the reference's all-reduce then slice, bit for bit, for
1/model of its bytes: 134 MB a gate and copy of partials at
recurrentgemma-9b's 2 x 4096 tokens of width 4096, 67 MB of them sent at
model 2); `w_out` is row-parallel with an all-reduce.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.nn.basic import gelu
from repro_torch.nn.params import ParamDef
from repro_torch.sharding import placement as pl

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
    return _gate_values(p, xf, xf @ p["w_a"].float(), xf @ p["w_i"].float())


def _gate_values(p, xf, za, zi):
    """(a, b) of the recurrence from the f32 conv output `xf` and its
    products `za`, `zi` with w_a, w_i."""
    rf = torch.sigmoid(za)
    i = torch.sigmoid(zi)
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
    if pl.is_sharded(x):
        return _sharded_rglru_full(p, x)
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
    if pl.is_sharded(x):
        return _sharded_rglru_decode(p, x, cache)
    gate = gelu(x @ p["w_gate"])
    xb = x @ p["w_x"]                                   # (B,1,w)
    hist = torch.cat([cache["conv"], xb.to(cache["conv"].dtype)], dim=1)
    xc = torch.einsum("bkw,kw->bw", hist, p["conv_w"]) + p["conv_b"]
    a, b = _gates(p, xc)                                # (B,w) f32
    h = a * cache["h"] + b
    y = ((h.to(x.dtype) * gate[:, 0, :]) @ p["w_out"])[:, None, :]
    return y, {"h": h, "conv": hist[:, 1:, :]}


# ------------------------------------------------------------------ sharded
def _sharded_gates(p, xc):
    """`_gates` on the rnn-sharded conv output xc (..., w): each position's
    f32 partial product with its rows of w_a / w_i, reduce-scattered onto
    its channels."""
    xf = pl.local_map(torch.Tensor.float, xc)
    za, zi = (pl.reduce_scatter(pl.local_map(
        lambda x_, w_: x_ @ w_.float(), xf, p[w],
        spec=(*xc.spec[:-1], None)), xc.spec[-1], -1) for w in ("w_a", "w_i"))
    return pl.local_map_n(_gate_values, p, xf, za, zi,
                          specs=[xc.spec] * 2)


def _sharded_in(p, x):
    """The column-parallel input branches: gelu(x @ w_gate), x @ w_x."""
    return (pl.local_map(gelu, pl.einsum("btd,dw->btw", x, p["w_gate"])),
            pl.einsum("btd,dw->btw", x, p["w_x"]))


def _sharded_out(p, h, gate):
    """(h * gate) @ w_out, row-parallel."""
    return pl.einsum("btw,wd->btd", pl.local_map(
        lambda h_, g: h_.to(g.dtype) * g, h, gate), p["w_out"])


def _sharded_rglru_full(p, x):
    gate, xb = _sharded_in(p, x)
    a, b = _sharded_gates(p, pl.local_map(_conv1d_full, p, xb, spec=xb.spec))
    hh = pl.local_map(linear_scan, a, b)
    K = p["conv_w"].shape[0]
    tail = pl.local_map(lambda t: F.pad(t, (0, 0, K - 1, 0))[:, t.shape[1]:],
                        xb)
    last = pl.local_map(lambda t: t[:, -1], hh, spec=(hh.spec[0],
                                                      hh.spec[2]))
    return _sharded_out(p, hh, gate), last, tail


def _sharded_rglru_decode(p, x, cache):
    gate, xb = _sharded_in(p, x)
    hist = pl.local_map(lambda c, t: torch.cat([c, t.to(c.dtype)], dim=1),
                        cache["conv"], xb)
    xc = pl.local_map(lambda h_, p_: torch.einsum(
        "bkw,kw->bw", h_, p_["conv_w"]) + p_["conv_b"], hist, p,
        spec=cache["h"].spec)
    a, b = _sharded_gates(p, xc)
    h = pl.local_map(lambda a_, h0, b_: a_ * h0 + b_, a, cache["h"], b)
    y = _sharded_out(p, pl.local_map(lambda t: t[:, None], h,
                                     spec=gate.spec), gate)
    return y, {"h": h, "conv": pl.local_map(lambda t: t[:, 1:], hist)}
