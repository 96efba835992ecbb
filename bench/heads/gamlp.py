"""The repo's JK-attention form of GAMLP, not the published GAMLP (Zhang
et al., KDD 2022, arXiv:2206.04355), which has a reference MLP over the
concatenated orders, a residual projection and an output MLP of its own.

Head f^(l): each order's score ``tanh(X^(k) W_att) v`` for k = 0..l, a
softmax over the orders, their weighted sum, then the MLP. Weights per
order: the MLP's, then ``att_w`` (f, att_dim) and ``att_v`` (att_dim,)
at scale 0.02."""
import torch

from bench.heads import mlp, mlp_dims, mlp_draws, mlp_macs


def draws(gcfg: dict) -> list:
    f, a = gcfg["feat_dim"], gcfg["att_dim"]
    dims = mlp_dims(gcfg, f)
    out = []
    for l in range(1, gcfg["k"] + 1):
        out += mlp_draws(dims, l)
        out.append((l, "att_w", (f, a), ("normal", 0.02)))
        out.append((l, "att_v", (a,), ("normal", 0.02)))
    return out


def logits(p, series, l, mm):
    sub = series[:l + 1]
    L, N, f = sub.shape
    scores = torch.tanh(mm(sub.reshape(L * N, f), p["att_w"]))
    att = mm(scores, p["att_v"][:, None]).reshape(L, N)
    h = (torch.softmax(att, dim=0)[..., None] * sub).sum(dim=0)
    return mlp(p, h, mm)


def macs(gcfg: dict, l: int) -> int:
    """The MLP, and for each of the l+1 orders its score (f x att_dim,
    then att_dim) and its share of the weighted sum (f)."""
    f, a = gcfg["feat_dim"], gcfg["att_dim"]
    return (mlp_macs(mlp_dims(gcfg, f))
            + (l + 1) * (f * a + a + f))
