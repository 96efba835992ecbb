"""RWKV-6 "Finch" layer (arXiv:2404.05892): time-mix with data-dependent
per-channel decay + channel-mix (`repro.nn.rwkv`).

The full-sequence WKV recurrence runs through kernel B5
(`repro_torch.kernels.wkv6`), the chunked factorization of the JAX
package's `_wkv_chunked` with a zero initial state; on CPU tensors the
kernel's plain PyTorch version computes it. B5 has no backward: training
(`differentiable=True`) runs `_wkv_chunked` here, the reference's own
training code, in plain PyTorch that autograd differentiates. As in the reference, the
ddlerp token-shift LoRA of full RWKV-6 is simplified to static
interpolation weights; the data-dependent decay is implemented.

On a mesh (x a `placement.ShardedTensor`, the batch over "data") the
time mix is tensor-parallel over "rnn" (-> "model"): `w_r`, `w_k`, `w_v`,
`w_g` and `w_lora_b` column-parallel, `w0`, `u` and `ln_scale` sliced,
so each position holds whole heads and runs B5, the group norm and the
gate on them; `w_o` is row-parallel with an all-reduce. In the channel
mix `w_ck` is column-parallel over "mlp", `w_cv` row-parallel with an
all-reduce, `w_cr` replicated. The state lies over the heads; the shift
states `x_t` and `x_c` are replicated over "model". `differentiable`
runs `_wkv_chunked` on each position's heads instead of B5.

Where the heads do not divide "model" (rwkv6-3b's 40 at 16: 2.5 heads a
position), each position's columns are regrouped into whole (batch row,
head) pairs split over the axis (`placement.columns_to_pairs`, padded
with zero pairs), B5 runs once per position on its pairs (u per pair)
and the group norm on them, and the normed output goes back to the
columns for the gate and `w_o`. The state then lies over its key dim
(`decoder_lm.fit_cache`): a decode step all-gathers the token's r, k, v
and decay, updates each position's key rows and adds the partial
outputs with an f32 all-reduce. At a batch that the data axes do not
divide, `fit_spec` puts them on the state too (its key dim over "data"
and its value dim over "model", its heads over "pod" on a multi-pod
mesh): each position updates its block of heads, keys and values, and
the partial outputs are summed over the keys' axis and gathered over
the others; the shift states `x_t` / `x_c`, then split over d, are
all-gathered before the token shift and sliced back after it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.wkv6 import CHUNK, wkv6, wkv6_heads
from repro_torch.nn.params import ParamDef
from repro_torch.sharding import placement as pl

LORA_R = 32
# Per-step log-decay is clamped to >= MIN_LOGW so the intra-chunk
# factorization exp(Lc_t)·exp(-Lc_s) stays inside f32 range:
# |CHUNK * MIN_LOGW| = 80 < log(f32_max) ~ 88.
MIN_LOGW = -5.0


def _heads(cfg, p=None):
    """(H, hd): the model's heads, or those of the time-mix weights `p`
    (on a mesh, a position's)."""
    hd = cfg.rwkv_head_dim
    H = (cfg.d_model if p is None else p["u"].shape[0]) // hd
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


def _wkv_chunked(r, k, v, logw, u, state):
    """r/k/v (B, T, H, hd) f32; logw (B, T, H, hd) f32 (<= 0); u (H, hd);
    state (B, H, hd, hd). T % CHUNK == 0. Returns (out (B, T, H, hd), new
    state): the chunked factorization of the reference, one chunk at a
    time."""
    B, T, H, hd = r.shape
    if T % CHUNK:
        raise ValueError(f"T = {T} is not a multiple of CHUNK = {CHUNK}")
    tri = torch.tril(torch.ones((CHUNK, CHUNK), dtype=torch.float32,
                                device=r.device), diagonal=-1)
    outs = []
    for c0 in range(0, T, CHUNK):
        rr, kk, vv, lw = (a[:, c0:c0 + CHUNK] for a in (r, k, v, logw))
        Lc = torch.cumsum(lw, dim=1)              # inclusive log cumprod
        P = torch.exp(Lc - lw)                    # prod_{s<t} w_s
        rp = rr * P
        kd = kk * torch.exp(-Lc)                  # k_s / D_s
        A = torch.einsum("bthc,bshc->bhts", rp, kd) * tri[None, None]
        diag = torch.einsum("bthc,bthc->bth", rr * u[None, None], kk)
        outs.append(torch.einsum("bhts,bshc->bthc", A, vv)
                    + diag[..., None] * vv
                    + torch.einsum("bthc,bhcd->bthd", rp, state))
        Dtot = torch.exp(Lc[:, -1])               # (B, H, hd)
        kscale = kk * torch.exp(Lc[:, -1][:, None] - Lc)
        state = state * Dtot[..., None] \
            + torch.einsum("bshc,bshd->bhcd", kscale, vv)
    return torch.cat(outs, dim=1), state


def _tmix_project(cfg, p, x, x_prev):
    r = _lerp(x, x_prev, p["mu_r"]) @ p["w_r"]
    k = _lerp(x, x_prev, p["mu_k"]) @ p["w_k"]
    v = _lerp(x, x_prev, p["mu_v"]) @ p["w_v"]
    g = _lerp(x, x_prev, p["mu_g"]) @ p["w_g"]
    logw = _decay(p, _lerp(x, x_prev, p["mu_w"]))
    return r, k, v, g, logw


def _wkv_columns(cfg, p, x):
    """r, k, v, logw (B, T_pad, D) f32 of the time mix on x (B, T, d), T
    padded to CHUNK by state-neutral steps (k = 0, logw = 0), and the
    gate g (B, T, D), D the columns of `p`."""
    T = x.shape[1]
    pad = (-T) % CHUNK
    xp = F.pad(x, (0, 0, 0, pad))
    r, k, v, g, logw = _tmix_project(cfg, p, xp, _shift(xp))
    rf, kf, vf = (a.float() for a in (r, k, v))
    if pad:  # padded steps: w=1 (logw=0), k=0 -> state untouched
        mask = (torch.arange(T + pad, device=x.device) < T)[None, :, None]
        kf = kf * mask
        logw = logw * mask
    return rf, kf, vf, logw, g[:, :T]


def wkv_inputs(cfg, p, x):
    """The WKV operands of the time-mix on x (B, T, d): r, k, v, logw
    (B, T_pad, H, hd) f32 with T padded to CHUNK by state-neutral steps
    (k = 0, logw = 0), u (H, hd) f32, and the gate g (B, T, D)."""
    H, hd = _heads(cfg, p)
    *ops, g = _wkv_columns(cfg, p, x)
    shp = (x.shape[0], ops[0].shape[1], H, hd)
    return (*(a.reshape(shp) for a in ops), p["u"].float().reshape(H, hd),
            g)


def _mixed_heads(cfg, p, x, differentiable: bool = False):
    """The time mix on x (B, T, d) up to `w_o`: the gated, group-normed
    WKV output (B, T, D) of `p`'s heads, and the final state (B, H, hd,
    hd) f32 (zero initial state), the recurrence in kernel B5, or in
    `_wkv_chunked` when `differentiable`."""
    B, T, _ = x.shape
    H, hd = _heads(cfg, p)
    rf, kf, vf, lw, u, g = wkv_inputs(cfg, p, x)
    if differentiable:
        out, state = _wkv_chunked(rf, kf, vf, lw, u, rf.new_zeros(
            (B, H, hd, hd)))
    else:
        out, state = wkv6_heads(rf, kf, vf, lw, u)
    out = out[:, :T].reshape(B, T, H * hd).to(x.dtype)
    return _group_norm(p, out, H, hd) * F.silu(g), state


def _head_specs(x, p):
    """On a mesh, where `w_r`'s column blocks hold whole heads: the specs
    of the heads' output (B, T, D) and of the state (B, H, hd, hd), the
    batch as x's, the heads as `w_r`'s columns."""
    return (x.spec[0], None, p["w_r"].spec[1]), (x.spec[0], p["w_r"].spec[1],
                                                  None, None)


def _whole_heads(cfg, p) -> bool:
    """Does each position's block of `w_r`'s columns hold whole heads?"""
    return p["u"].locals[0].shape[0] % cfg.rwkv_head_dim == 0


def pair_inputs(cfg, p, x):
    """The WKV operands where a mesh position's columns of `w_r` split
    heads: r, k, v, logw regrouped into (batch row, head) pairs (G, n * m,
    T_pad, hd) f32 placed over the axis (`placement.columns_to_pairs`),
    each position's u and ln_scale rows of its pairs' heads ((m, hd) f32,
    a list by position), and the gate g (B, T, D) in its columns."""
    hd = cfg.rwkv_head_dim
    axis = p["w_r"].spec[1]
    *ops, g = pl.local_map_n(lambda x_, p_: _wkv_columns(cfg, p_, x_), x, p,
                             specs=[(x.spec[0], None, axis)] * 5)
    pairs = [pl.columns_to_pairs(t, hd) for t in ops]
    H = p["u"].shape[0] // hd

    def rows(t, i):
        start, m = pairs[0].block(i, 1)
        heads = torch.arange(start, start + m, device=t.device) % H
        return t.float().reshape(H, hd)[heads]
    u, ln_scale = ([rows(t, i) for i, t in enumerate(
        pl.all_gather(p[n], axis).locals)] for n in ("u", "ln_scale"))
    return pairs, u, ln_scale, g


def _paired_heads(cfg, p, x, differentiable: bool):
    """`_mixed_heads` on a mesh whose positions' column blocks split
    heads: each position projects its columns, `columns_to_pairs` hands
    it whole (batch row, head) pairs, on which it runs B5 (or
    `_wkv_chunked` when `differentiable`) and the group norm, and
    `pairs_to_columns` brings the normed output back to its columns for
    the gate and `w_o`. The final state goes over its key dim
    (`decoder_lm.fit_cache`'s layout, all-to-all from the pairs)."""
    B_l, T = x.locals[0].shape[:2]
    hd = cfg.rwkv_head_dim
    axis = p["w_r"].spec[1]
    (rf, kf, vf, lw), us, lss, g = pair_inputs(cfg, p, x)

    def mix(i):
        r_, k_, v_, w_ = (t.locals[i][0] for t in (rf, kf, vf, lw))
        m = r_.shape[0]
        if differentiable:
            out, state = _wkv_chunked(*(t.transpose(0, 1)[None] for t in
                                        (r_, k_, v_, w_)), us[i],
                                      r_.new_zeros((1, m, hd, hd)))
            out, state = out[0].transpose(0, 1), state[0]
        else:
            out, state = wkv6(r_, k_, v_, w_, us[i])
        # each pair one head of its own ln_scale row
        normed = _group_norm({"ln_scale": lss[i][:, None]},
                             out[:, :T].to(x.dtype), 1, hd)
        return normed[None], state[None]
    outs, states = zip(*(mix(i) for i in range(len(x.locals))))
    pairs = (x.spec[0], axis, None, None)
    normed = pl.pairs_to_columns(pl.wrap(outs, pairs, x.mesh), g)
    out = pl.local_map(lambda y_, g_: y_ * F.silu(g_), normed, g)
    H = p["u"].shape[0] // hd
    state = pl.local_map(
        lambda t: t[0, :B_l * H].reshape(B_l, H, -1, hd),
        pl.all_to_all(pl.wrap(states, pairs, x.mesh), axis, 2),
        spec=(x.spec[0], None, axis, None))
    return out, state


def rwkv_time_mix_full(cfg, p, x, differentiable: bool = False):
    """x (B,T,d), zero initial state. Returns (y, final state (B,H,hd,hd)
    f32); the recurrence runs in kernel B5, or in `_wkv_chunked` when
    `differentiable`."""
    if pl.is_sharded(x):
        if _whole_heads(cfg, p):
            out, state = pl.local_map_n(
                lambda x_, p_: _mixed_heads(cfg, p_, x_, differentiable), x,
                p, specs=_head_specs(x, p))
        else:
            out, state = _paired_heads(cfg, p, x, differentiable)
        return pl.einsum("bte,ed->btd", out, p["w_o"]), state
    out, state = _mixed_heads(cfg, p, x, differentiable)
    return out @ p["w_o"], state


def _cmix_key(p, x, x_prev):
    return torch.relu(_lerp(x, x_prev, p["mu_ck"]) @ p["w_ck"]).square()


def _cmix_receptance(p, x, x_prev):
    return torch.sigmoid(_lerp(x, x_prev, p["mu_cr"]) @ p["w_cr"])


def _channel_mix(p, x, x_prev):
    """sigmoid(r) * (relu(k)^2 @ w_cv) on x and its shifted `x_prev`
    (B, T, d); on a mesh k is column-parallel, w_cv row-parallel."""
    if pl.is_sharded(x):
        kx = pl.local_map(_cmix_key, p, x, x_prev,
                          spec=(x.spec[0], None, p["w_ck"].spec[1]))
        return pl.local_map(torch.mul, pl.local_map(_cmix_receptance, p, x,
                                                    x_prev, spec=x.spec),
                            pl.einsum("btf,fd->btd", kx, p["w_cv"]))
    return _cmix_receptance(p, x, x_prev) * (_cmix_key(p, x, x_prev)
                                             @ p["w_cv"])


def rwkv_channel_mix_full(cfg, p, x):
    return _channel_mix(p, x, pl.local_map(_shift, x) if pl.is_sharded(x)
                        else _shift(x))


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


def _decode_heads(cfg, p, x, state, x_prev):
    """One token of the time mix up to `w_o`: the gated, group-normed
    output (B, 1, D) of `p`'s heads and the new state."""
    B = x.shape[0]
    H, hd = _heads(cfg, p)
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
    return _group_norm(p, out, H, hd) * F.silu(g), state


def _decode_over_keys(cfg, p, x, state, x_prev):
    """`_decode_heads` on a mesh where the state does not lie over whole
    heads as `w_r`'s columns do: over its key dim (`_paired_heads`'
    layout), and at a batch that the data axes do not divide, its heads,
    key and value dims each over an axis of their own (`fit_spec`'s
    fallback). r, k, v and the decay are all-gathered over the columns'
    axis (one token), each position updates its block (heads, key rows,
    value columns) of the state and forms its partial output
    r_c (S_cd + u_c k_c v_d) over its keys c; the f32 all-reduce over the
    key dim's axis adds the partials, the heads and value columns are
    all-gathered, and each position norms the heads and gates its own
    columns for `w_o`."""
    hd = cfg.rwkv_head_dim
    cax = p["w_r"].spec[1]
    cols = (x.spec[0], None, cax)

    def project(x_, p_, xp):
        r, k, v, g, logw = _tmix_project(cfg, p_, x_, xp[:, None, :])
        return torch.stack([r.float(), k.float(), v.float(), logw]), g
    rkvw, g = pl.local_map_n(project, x, p, x_prev,
                             specs=((None, *cols), cols))
    rkvw = pl.all_gather(rkvw, cax)
    u, ln_scale = (pl.all_gather(p[n], cax) for n in ("u", "ln_scale"))
    H = u.shape[0] // hd

    def step(i):
        B = x.locals[i].shape[0]
        rf, kf, vf, lw = (t.reshape(B, H, hd) for t in rkvw.locals[i])
        (h0, nh), (c0, nc), (d0, nd) = (state.block(i, j) for j in (1, 2, 3))
        hs, ks, ds = (slice(h0, h0 + nh), slice(c0, c0 + nc),
                      slice(d0, d0 + nd))
        uc = u.locals[i].float().reshape(H, hd)[hs, ks]
        kv = kf[:, hs, ks, None] * vf[:, hs, None, ds]
        s_ = state.locals[i]
        part = torch.einsum("bhc,bhcd->bhd", rf[:, hs, ks],
                            s_ + uc[..., None] * kv)
        return part, s_ * torch.exp(lw[:, hs, ks])[..., None] + kv
    parts, states = zip(*(step(i) for i in range(len(x.locals))))
    out = pl.all_reduce_sum(pl.wrap(parts, (x.spec[0], state.spec[1],
                                            state.spec[3]), x.mesh),
                            state.spec[2])
    out = pl.relayout(out, (x.spec[0], None, None))

    def gate(o, ls, g_, i):
        normed = _group_norm({"ln_scale": ls}, o.reshape(
            o.shape[0], 1, H * hd).to(x.dtype), H, hd)
        a, c = g.block(i, 2)
        return normed[..., a:a + c] * F.silu(g_)
    y = pl.wrap([gate(out.locals[i], ln_scale.locals[i], g.locals[i], i)
                 for i in range(len(x.locals))], cols, x.mesh)
    return y, pl.wrap(states, state.spec, x.mesh)


def _whole(t):
    """A shift state (B, d) split over its d (at a batch that the data
    axes do not divide) all-gathered: the token shift reads all of d."""
    return pl.relayout(t, (t.spec[0], None))


def rwkv_tmix_decode(cfg, p, x, state, x_prev):
    """One token time-mix. x (B,1,d); state (B,H,hd,hd) f32; x_prev (B,d).
    Returns (y (B,1,d), new_state)."""
    if pl.is_sharded(x):
        x_prev = _whole(x_prev)
        if tuple(state.spec[1:]) == (p["w_r"].spec[1], None, None) \
                and _whole_heads(cfg, p):
            out, state = pl.local_map_n(
                lambda x_, p_, s_, xp: _decode_heads(cfg, p_, x_, s_, xp),
                x, p, state, x_prev, specs=_head_specs(x, p))
        else:
            out, state = _decode_over_keys(cfg, p, x, state, x_prev)
        return pl.einsum("bte,ed->btd", out, p["w_o"]), state
    out, state = _decode_heads(cfg, p, x, state, x_prev)
    return out @ p["w_o"], state


def rwkv_cmix_decode(cfg, p, x, x_prev):
    """One token channel-mix. x (B,1,d); x_prev (B,d)."""
    if pl.is_sharded(x):
        return _channel_mix(p, x, pl.local_map(
            lambda t: t[:, None], _whole(x_prev), spec=x.spec))
    return _channel_mix(p, x, x_prev[:, None, :])
