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
here they go to `torch.bmm`). The reference's sharding pins (`constrain`,
the `B*S >= 8192` branch) are no-ops on one device and are dropped.

Dispatch writes only the kept assignments into their (expert, row, slot)
cells, which are unique, by index assignment (deterministic, unlike an
`index_add_` on the card); dropped ones go to one spare row past the
buffer that nothing reads (the reference adds them x 0 into slot C-1,
which would turn a NaN of a dropped token into a NaN of a kept one). No
host synchronisation: the kept count is never read on the host.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.nn.basic import gelu
from repro_torch.nn.params import ParamDef


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


def route(cfg, p, x):
    """x (B, S, d) -> (probs (B, S, E) f32, gate_w (B, S, k) f32,
    expert_idx (B, S, k), keep (B, S*k) bool, slot (B, S*k)): the router's
    choices and each assignment's place in its expert's buffer of
    `_capacity(cfg, S)` slots (slot clipped to C - 1 where not kept)."""
    B, S, _ = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    C = _capacity(cfg, S)
    gate_logits = torch.einsum("bsd,de->bse", x.float(), p["router"].float())
    probs = torch.softmax(gate_logits, dim=-1)
    gate_w, expert_idx = torch.topk(probs, k, dim=-1)       # descending
    gate_w = gate_w / gate_w.sum(dim=-1, keepdim=True)
    eid = expert_idx.reshape(B, S * k)
    onehot = F.one_hot(eid, E)                              # (B, S*k, E)
    pos_in_e = (onehot.cumsum(dim=1) * onehot).sum(-1) - 1
    keep = pos_in_e < C
    return probs, gate_w, expert_idx, keep, pos_in_e.clamp(0, C - 1)


def apply_moe(cfg, p, x):
    """x (B, S, d) -> (y (B, S, d) in x's dtype, aux loss () f32)."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    C = _capacity(cfg, S)
    probs, gate_w, expert_idx, keep, slot = route(cfg, p, x)
    eid = expert_idx.reshape(B, S * k)
    if apply_moe.drops is not None:
        apply_moe.drops.append(((~keep).sum(), keep.numel()))

    # ---- dispatch: row (e, b, slot) of an (E * B * C + 1, d) buffer
    rows = eid * (B * C) + torch.arange(B, device=x.device)[:, None] * C \
        + slot                                              # (B, S*k)
    spare = E * B * C
    buf = x.new_zeros((spare + 1, d))
    buf[torch.where(keep, rows, spare)] = x.repeat_interleave(k, dim=1)
    buf = buf[:spare].view(E, B * C, d)

    # ---- expert FFN, gated: SiLU for swiglu, tanh-GELU otherwise
    act = F.silu if cfg.mlp_kind == "swiglu" else gelu
    h = (act(torch.bmm(buf, p["w_gate"])) * torch.bmm(buf, p["w_up"])
         ).to(x.dtype)
    out_buf = torch.bmm(h, p["w_down"]).to(x.dtype).view(E * B * C, d)

    # ---- combine: each assignment's output x keep x gate weight, summed
    # over the k in x's dtype
    y_rep = out_buf[rows] * keep[..., None].to(x.dtype)    # (B, S*k, d)
    y = (y_rep.view(B, S, k, d) * gate_w[..., None].to(x.dtype)).sum(dim=2)

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
    y, aux = apply_moe(cfg, p, x.transpose(0, 1))
    return y.transpose(0, 1), aux
