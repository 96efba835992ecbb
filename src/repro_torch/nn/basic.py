"""Norms, rotary embeddings, dense MLPs — shared primitives
(`repro.nn.basic`). Norms compute in f32 and return the input's dtype.

On placed activations (`repro_torch.sharding.placement.ShardedTensor`)
norms run on every position's block with the replicated gains, and the
MLP is tensor-parallel: `w_gate` / `w_up` column-parallel over "mlp",
`w_down` row-parallel, its partial sums all-reduced."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.nn.params import ParamDef
from repro_torch.sharding import placement as pl


# --------------------------------------------------------------------- norms
def norm_defs(cfg, dim=None):
    d = dim or cfg.d_model
    if cfg.norm_kind == "layernorm":
        return {"scale": ParamDef((d,), ("embed",), "ones"),
                "bias": ParamDef((d,), ("embed",), "zeros")}
    # rmsnorm applies (1 + scale) gemma-style -> zero init = unit gain
    return {"scale": ParamDef((d,), ("embed",), "zeros")}


def apply_norm(cfg, p, x):
    """The reference's f32 formula through PyTorch's fused norms (one
    kernel each instead of a chain of elementwise ops: decode is
    host-bound)."""
    if pl.is_sharded(x):
        return pl.local_map(lambda x_, p_: apply_norm(cfg, p_, x_), x, p)
    xf = x.float()
    if cfg.norm_kind == "layernorm":
        y = F.layer_norm(xf, (xf.shape[-1],), p["scale"].float(),
                         p["bias"].float(), cfg.norm_eps)
    else:  # rmsnorm, gemma-style (1 + scale) gain
        y = F.rms_norm(xf, (xf.shape[-1],), eps=cfg.norm_eps) \
            * (1.0 + p["scale"].float())
    return y.to(x.dtype)


# -------------------------------------------------------------------- rotary
def rotary(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: (..., S, H, hd); positions: (..., S) integer."""
    hd = x.shape[-1]
    half = hd // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions.float()[..., None] * freq                 # (..., S, half)
    ang = ang[..., None, :]                                   # (..., S, 1, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------- dense MLP
def mlp_defs(cfg):
    d, f = cfg.d_model, cfg.d_ff
    if cfg.mlp_kind in ("swiglu", "geglu"):
        return {"w_gate": ParamDef((d, f), ("embed", "mlp")),
                "w_up": ParamDef((d, f), ("embed", "mlp")),
                "w_down": ParamDef((f, d), ("mlp", "embed"))}
    return {"w_up": ParamDef((d, f), ("embed", "mlp")),
            "w_down": ParamDef((f, d), ("mlp", "embed"))}


def gelu(x):
    """tanh-approximate GELU (`jax.nn.gelu(approximate=True)`)."""
    return F.gelu(x, approximate="tanh")


def apply_mlp(cfg, p, x):
    if pl.is_sharded(x):
        up = pl.einsum("bsd,df->bsf", x, p["w_up"])
        if cfg.mlp_kind == "gelu":
            h = pl.local_map(gelu, up)
        else:
            act = F.silu if cfg.mlp_kind == "swiglu" else gelu
            h = pl.local_map(lambda g, u: act(g) * u,
                             pl.einsum("bsd,df->bsf", x, p["w_gate"]), up)
        return pl.einsum("bsf,fd->bsd", h, p["w_down"])
    if cfg.mlp_kind == "swiglu":
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    elif cfg.mlp_kind == "geglu":
        h = gelu(x @ p["w_gate"]) * (x @ p["w_up"])
    else:
        h = gelu(x @ p["w_up"])
    return h @ p["w_down"]
