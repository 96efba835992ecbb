"""Mixture-of-Experts FFN (`repro.nn.moe`): Switch-style top-k routing
with a per-sequence-row capacity.

Each row of x (a sequence; in decode, the whole batch) routes its tokens
on its own: f32 router softmax, top-k experts in descending order, gate
weights renormalised over the k. The (S·k) assignments of a row are
taken token-major, rank-minor; an assignment keeps the running count of
its expert in that order as its slot and is kept iff the slot is below
the capacity C. Dropped assignments contribute 0 and the token passes on
the residual.

The expert products are batched matrix products over (E, B·C, ·)
buffers (the reference leaves them to XLA, outside any Pallas kernel;
here they go to `torch.bmm`).

Dispatch writes only the kept assignments into their (expert, row, slot)
cells, which are unique, by index assignment (deterministic, unlike an
`index_add_` on the card); dropped ones go to one spare row past the
buffer that nothing reads (the reference adds them x 0 into slot C-1,
which would turn a NaN of a dropped token into a NaN of a kept one). No
host synchronisation: the kept count is never read on the host.

On a mesh (x a `placement.ShardedTensor`, the batch over "data", or
over ("pod", "data") on a multi-pod mesh, whose collectives then run
over the tuple, or replicated where the data axes do not divide it) the
experts are replicated over "model" (`DEFAULT_RULES` maps "expert" to no
axis: no expert parallelism), their d over "data" (FSDP) and their f
over "model" (`w_gate` / `w_up` column-, `w_down` row-parallel), the
router replicated. Each position routes its own tokens. In prefill the
rows are sequences, so that needs no exchange; in decode the routing row
is the global batch, so the positions all-gather the (B, k) expert ids
and each ranks every assignment of the row, as one device would, before
keeping its own. The FFN follows the reference's gate on the token
count (`GATHER_WEIGHTS_AT`): at or above it each expert weight is
all-gathered over "data" just before its product and freed after, the
down-projection's partials are reduce-scattered over "model" onto d,
combined there and the token-sized y all-gathered (the reference's
`embed_tp`); below it the tokens move instead of the weights: every
position takes its d slice of all the tokens (an all-to-all), contracts
it with its d slice of the weights, and the partials are summed over
"data", then over "model"; an all-to-all brings y back to its tokens. The tokens move
over the experts' d axis alone ("data"): with the batch over ("pod",
"data") each position takes the d slice of its "pod" group's tokens.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.nn.basic import gelu
from repro_torch.nn.params import ParamDef
from repro_torch.sharding import placement as pl
from repro_torch.sharding.logical import entry_axes

# the reference's `big`: at this many tokens (B * S) or more the FSDP
# product gathers the expert weights over "data"; below it, the tokens
GATHER_WEIGHTS_AT = 8192


def moe_defs(cfg):
    d, f, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {
        "router": ParamDef((d, E), ("embed", None), "small"),
        "w_gate": ParamDef((E, d, f), ("expert", "fsdp", "mlp")),
        "w_up": ParamDef((E, d, f), ("expert", "fsdp", "mlp")),
        "w_down": ParamDef((E, f, d), ("expert", "mlp", "fsdp")),
    }


def _capacity(cfg, tokens_per_row: int) -> int:
    c = int(tokens_per_row * cfg.experts_per_token
            / cfg.num_experts * cfg.capacity_factor)
    return max(8, -(-c // 8) * 8)  # round up to 8


def _choices(cfg, p, x):
    """The router on x (B, S, d): f32 softmax probs (B, S, E), the top-k
    gate weights (renormalised over the k) and expert ids (B, S, k)."""
    gate_logits = torch.einsum("bsd,de->bse", x.float(), p["router"].float())
    probs = torch.softmax(gate_logits, dim=-1)
    gate_w, expert_idx = torch.topk(probs, cfg.experts_per_token, dim=-1)
    return probs, gate_w / gate_w.sum(dim=-1, keepdim=True), expert_idx


def _slots(eid, E: int, C: int):
    """Assignments (R, n) of expert ids, in row order -> keep (R, n) bool
    and slot (R, n): each one's running count of its expert along the
    row, kept below the capacity C (slot clipped to C - 1)."""
    onehot = F.one_hot(eid, E)                              # (R, n, E)
    pos_in_e = (onehot.cumsum(dim=1) * onehot).sum(-1) - 1
    return pos_in_e < C, pos_in_e.clamp(0, C - 1)


def route(cfg, p, x):
    """x (B, S, d) -> (probs (B, S, E) f32, gate_w (B, S, k) f32,
    expert_idx (B, S, k), keep (B, S*k) bool, slot (B, S*k)): the router's
    choices and each assignment's place in its expert's buffer of
    `_capacity(cfg, S)` slots (slot clipped to C - 1 where not kept)."""
    B, S, _ = x.shape
    probs, gate_w, expert_idx = _choices(cfg, p, x)
    keep, slot = _slots(expert_idx.reshape(B, S * cfg.experts_per_token),
                        cfg.num_experts, _capacity(cfg, S))
    return probs, gate_w, expert_idx, keep, slot


def _dispatch(x, eid, keep, slot, E: int, C: int):
    """x (R, T, d) and its assignments (R, T*k) -> (buf (E, R*C, d): each
    kept assignment's token in row (e, r, slot), zero elsewhere; rows
    (R, T*k): those rows)."""
    R, T, d = x.shape
    k = eid.shape[1] // T
    rows = eid * (R * C) + torch.arange(R, device=x.device)[:, None] * C \
        + slot
    spare = E * R * C
    buf = x.new_zeros((spare + 1, d))
    buf[torch.where(keep, rows, spare)] = x.repeat_interleave(k, dim=1)
    return buf[:spare].view(E, R * C, d), rows


def _act(cfg):
    """The experts' gate activation: SiLU for swiglu, tanh-GELU otherwise."""
    return F.silu if cfg.mlp_kind == "swiglu" else gelu


def _combine(out_buf, rows, keep, gate_w, dtype):
    """Each assignment's output row x keep x gate weight, summed over the
    k in `dtype`: out_buf (E, R*C, d), rows / keep (R, T*k), gate_w
    (R, T, k) -> y (R, T, d)."""
    R, T, k = gate_w.shape
    d = out_buf.shape[-1]
    y_rep = out_buf.reshape(-1, d)[rows] * keep[..., None].to(dtype)
    return (y_rep.view(R, T, k, d) * gate_w[..., None].to(dtype)).sum(dim=2)


def apply_moe(cfg, p, x):
    """x (B, S, d) -> (y (B, S, d) in x's dtype, aux loss () f32)."""
    if pl.is_sharded(x):
        return _sharded_moe(cfg, p, x, decode=False)
    E = cfg.num_experts
    C = _capacity(cfg, x.shape[1])
    probs, gate_w, expert_idx, keep, slot = route(cfg, p, x)
    if apply_moe.drops is not None:
        apply_moe.drops.append(((~keep).sum(), keep.numel()))
    buf, rows = _dispatch(x, expert_idx.flatten(1), keep, slot, E, C)
    h = (_act(cfg)(torch.bmm(buf, p["w_gate"])) * torch.bmm(buf, p["w_up"])
         ).to(x.dtype)
    out_buf = torch.bmm(h, p["w_down"]).to(x.dtype)
    y = _combine(out_buf, rows, keep, gate_w, x.dtype)

    # ---- load-balance aux loss (Switch): E * sum_e f_e * P_e
    frac = F.one_hot(expert_idx[..., 0], E).float().mean(dim=(0, 1))
    mean_prob = probs.mean(dim=(0, 1))
    aux = E * torch.sum(frac * mean_prob) * cfg.router_aux_weight
    return y.to(x.dtype), aux


# None, or a list to which each apply_moe call appends (dropped, total):
# its dropped-assignment count (a 0-d tensor on x's device, not read on
# the host) and its number of assignments
apply_moe.drops = None


def apply_moe_decode(cfg, p, x):
    """One-token decode: the batch is the routing row. x (B, 1, d)."""
    if pl.is_sharded(x):
        return _sharded_moe(cfg, p, x, decode=True)
    y, aux = apply_moe(cfg, p, x.transpose(0, 1))
    return y.transpose(0, 1), aux


# ------------------------------------------------------------------ sharded
def sharded_route(cfg, p, x, decode: bool):
    """The routing of x (B, S, d) placed with the batch over "data" (or
    ("pod", "data"), or replicated), each
    position on its own tokens: (probs (B, S, E), gate_w (B, S, k), the
    first choices (B, S), and the assignments eid, keep, slot, each
    placed along its routing rows. In prefill the rows are the sequences
    (B, S*k), over "data" like the batch. In decode the row is the batch
    (1, B*k): the expert ids are all-gathered over "data" and every
    position ranks the whole row, so keep and slot are replicated, those
    of one device.)"""
    E, dax = cfg.num_experts, x.spec[0]
    probs, gate_w, eid = pl.local_map_n(lambda t, p_: _choices(cfg, p_, t),
                                        x, p, specs=[x.spec] * 3)
    first = pl.local_map(lambda t: t[..., 0], eid, spec=x.spec[:2])
    B, S = x.shape[:2]
    if decode:        # (B, 1, k) -> the global row (1, B*k)
        eid = pl.local_map(lambda t: t.reshape(1, -1),
                           pl.all_gather(eid, dax), spec=(None, None))
        C = _capacity(cfg, B)
    else:
        eid = pl.local_map(lambda t: t.flatten(1), eid, spec=x.spec[:2])
        C = _capacity(cfg, S)
    keep, slot = pl.local_map_n(lambda t: _slots(t, E, C), eid,
                                specs=[eid.spec] * 2)
    return probs, gate_w, first, eid, keep, slot


def _sharded_aux(cfg, probs, first, n_tokens: int):
    """The Switch aux loss of the global batch, on the mesh's first
    device: each position's sums of the first-choice counts and the
    probabilities, added over "data", over the token count."""
    E = cfg.num_experts
    sums = pl.local_map(lambda p_, f: torch.cat(
        [F.one_hot(f, E).float().sum(dim=(0, 1)), p_.sum(dim=(0, 1))]),
        probs, first, spec=(None,))
    s = pl.all_reduce_sum(sums, probs.spec[0]).locals[0] / n_tokens
    return E * torch.sum(s[:E] * s[E:]) * cfg.router_aux_weight


def _sharded_moe(cfg, p, x, decode: bool):
    """`apply_moe` (`apply_moe_decode` when `decode`) on x (B, S, d) placed
    with the batch over "data" and replicated over "model"."""
    B, S, _ = x.shape
    dax = x.spec[0]
    fsdp, mdl = p["w_gate"].spec[1:]
    probs, gate_w, first, eid, keep, slot = sharded_route(cfg, p, x, decode)
    if apply_moe.drops is not None:
        kept = pl.gather(keep)
        apply_moe.drops.append(((~kept).sum(), kept.numel()))
    C = _capacity(cfg, B if decode else S)
    # the tokens and gate weights as routing rows (R, T, .)
    if decode:
        rows_of = pl.local_map(lambda t: t.transpose(0, 1), x,
                               spec=(None, dax, None))
        gate_w = pl.local_map(lambda t: t.transpose(0, 1), gate_w,
                              spec=(None, dax, None))
    else:
        rows_of = x
    if B * S >= GATHER_WEIGHTS_AT:
        y = _moe_gather_weights(cfg, p, rows_of, gate_w, eid, keep, slot,
                                C, fsdp, mdl)
    else:
        y = _moe_move_tokens(cfg, p, rows_of, gate_w, eid, keep, slot, C,
                             fsdp, mdl)
    if decode:
        y = pl.local_map(lambda t: t.transpose(0, 1), y, spec=x.spec)
    return y, _sharded_aux(cfg, probs, first, B * S)


def _own(t, rows: pl.ShardedTensor):
    """Replicated assignments of the one decode row, cut to each
    position's tokens (over the axis that shards `rows`' tokens); placed
    rows' assignments as they are."""
    if t.spec[0] is not None or rows.spec[1] is None:
        return t
    return pl.relayout(t, (None, rows.spec[1]))


def _moe_gather_weights(cfg, p, xr, gate_w, eid, keep, slot, C, fsdp, mdl):
    """FSDP by gathering the weights: each position runs the experts on
    its own kept tokens, each weight all-gathered over "data" just before
    its product and freed after it; the down-projection's partial sums
    are reduce-scattered over "model" onto d, each position combines its
    d slice, and y is all-gathered over "model"."""
    E, dtype = cfg.num_experts, xr.dtype
    eid, keep, slot = (_own(t, xr) for t in (eid, keep, slot))
    n = len(xr.locals)
    bufs, rows = zip(*(_dispatch(xr.locals[i], eid.locals[i],
                                 keep.locals[i], slot.locals[i], E, C)
                       for i in range(n)))

    def product(h, name):
        w = p[name] if fsdp is None else pl.all_gather(p[name], fsdp)
        out = [torch.bmm(h[i], w.locals[i]) for i in range(n)]
        del w
        return out

    g, u = product(bufs, "w_gate"), product(bufs, "w_up")
    h = [(_act(cfg)(g_) * u_).to(dtype) for g_, u_ in zip(g, u)]
    del g, u, bufs
    out = pl.wrap(product(h, "w_down"),
                  (None, xr.spec[0] or xr.spec[1], None), xr.mesh)
    if mdl is not None:
        out = pl.reduce_scatter(out, mdl, 2)
    y = pl.wrap([_combine(out.locals[i], rows[i], keep.locals[i],
                          gate_w.locals[i], dtype) for i in range(n)],
                (*xr.spec[:2], out.spec[2]), xr.mesh)
    return y if mdl is None else pl.all_gather(y, mdl)


def _moe_move_tokens(cfg, p, xr, gate_w, eid, keep, slot, C, fsdp, mdl):
    """FSDP by moving the tokens over the experts' d axis ("data"): every
    position takes its d slice of the tokens of its group along that axis
    (the batch's other axes, "pod" of ("pod", "data"), keep their split),
    routes them into the buffer's d slice, contracts it with its d slice
    of the weights (partials summed over "data"), the down-projection's
    partials are summed over "model", and y's d slices go back to their
    tokens."""
    E, dtype = cfg.num_experts, xr.dtype
    tok_dim = 0 if xr.spec[0] is not None else 1
    rest = tuple(a for a in entry_axes(xr.spec[tok_dim]) if a != fsdp)
    rows = [None, None]
    rows[tok_dim] = pl.entry_of(rest)
    xs = pl.relayout(xr, (*rows, fsdp))
    eid, keep, slot = (pl.relayout(t, rows) for t in (eid, keep, slot))
    gate_w = pl.relayout(gate_w, (*rows, None))
    buf, rows_ = pl.local_map_n(lambda x_, e, k_, s_: _dispatch(
        x_, e, k_, s_, E, C), xs, eid, keep, slot,
        specs=[(None, pl.entry_of(rest), fsdp), (pl.entry_of(rest), None)])

    def product(h, name, axis):
        part = pl.local_map(lambda h_, w: torch.bmm(h_, w), h, p[name],
                            spec=(None, pl.entry_of(rest), p[name].spec[2]))
        return pl.all_reduce_sum(part, axis)

    h = pl.local_map(lambda g, u: (_act(cfg)(g) * u).to(dtype),
                     product(buf, "w_gate", fsdp),
                     product(buf, "w_up", fsdp))
    out = product(h, "w_down", mdl)
    y = pl.local_map(lambda o, r, k_, g: _combine(o, r, k_, g, dtype), out,
                     rows_, keep, gate_w, spec=xs.spec)
    return pl.relayout(y, xr.spec)
