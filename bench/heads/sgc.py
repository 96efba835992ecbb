"""SGC (Wu et al., ICML 2019, arXiv:1902.07153): head f^(l) reads X^(l)
alone, then the MLP; ``mlp_layers`` 1 is SGC's one linear layer."""
from bench.heads import mlp, mlp_dims, mlp_draws, mlp_macs


def draws(gcfg: dict) -> list:
    dims = mlp_dims(gcfg, gcfg["feat_dim"])
    return [d for l in range(1, gcfg["k"] + 1) for d in mlp_draws(dims, l)]


def logits(p, series, l, mm):
    return mlp(p, series[l], mm)


def macs(gcfg: dict, l: int) -> int:
    return mlp_macs(mlp_dims(gcfg, gcfg["feat_dim"]))
