"""Linear-propagation scalable GNNs (paper §2.2) as per-order classifiers.

NAI needs one classifier f^(l) per propagation order l = 1..k. The base
model decides what f^(l) consumes:
    SGC   : X^(l)                      (linear/MLP head)
    S2GC  : mean(X^(0)..X^(l))
    SIGN  : concat(X^(0)..X^(l)) -> MLP
    GAMLP : node-wise attention over X^(0)..X^(l) -> MLP  (JK-attention form)

The port of `repro.gnn.models` for inference: each head is an `nn.Module`
taking the stacked series (l+1, N, f) like the JAX `apply_classifier`.
Initialization follows `repro.nn.params` (fan-in normal weights, zero
biases, 0.02-scaled attention) drawn from an explicit `torch.Generator`;
`repro_torch.gnn.convert.params_from_numpy` loads the JAX package's
parameters instead.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List

import torch
from torch import nn

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    base_model: str            # sgc | s2gc | sign | gamlp
    feat_dim: int
    num_classes: int
    k: int                     # max propagation order
    r: float = 0.5             # convolution coefficient (Eq. 1)
    hidden: int = 128
    mlp_layers: int = 2        # P in Table 1
    dropout: float = 0.2       # training only; the heads here infer
    att_dim: int = 32          # GAMLP attention projection

    def input_dim(self, l: int) -> int:
        return self.feat_dim * (l + 1) if self.base_model == "sign" \
            else self.feat_dim

    def layer_dims(self, l: int) -> List[int]:
        return [self.input_dim(l)] + [self.hidden] * (self.mlp_layers - 1) \
            + [self.num_classes]


class OrderClassifier(nn.Module):
    """f^(l): combine the series X^(0..l), then an MLP with ReLU between
    layers (mlp_layers=1 is SGC's linear form)."""

    def __init__(self, cfg: GNNConfig, l: int):
        super().__init__()
        if cfg.base_model not in ("sgc", "s2gc", "sign", "gamlp"):
            raise ValueError(cfg.base_model)
        self.cfg, self.order = cfg, l
        dims = cfg.layer_dims(l)
        self.layers = nn.ModuleList(nn.Linear(a, b)
                                    for a, b in zip(dims[:-1], dims[1:]))
        if cfg.base_model == "gamlp":
            self.att_w = nn.Parameter(torch.empty(cfg.feat_dim, cfg.att_dim))
            self.att_v = nn.Parameter(torch.empty(cfg.att_dim))

    def combine(self, feats: torch.Tensor) -> torch.Tensor:
        """feats (>= l+1, N, f) stacked series -> (N, input_dim)."""
        l, model = self.order, self.cfg.base_model
        if model == "sgc":
            return feats[l]
        sub = feats[:l + 1]
        if model == "s2gc":
            return sub.mean(dim=0)
        if model == "sign":
            return sub.permute(1, 0, 2).reshape(feats.shape[1], -1)
        scores = torch.tanh(torch.einsum("lnf,fa->lna", sub, self.att_w))
        w = torch.softmax(torch.einsum("lna,a->ln", scores, self.att_v),
                          dim=0)
        return torch.einsum("ln,lnf->nf", w, sub)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        """Logits (N, num_classes) of f^(l) on the series feats."""
        x = self.combine(feats)
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = torch.relu(x)
        return x


class Classifiers(nn.Module):
    """The per-order heads f^(1..k); `head(l)` is f^(l)."""

    def __init__(self, cfg: GNNConfig):
        super().__init__()
        self.cfg = cfg
        self.heads = nn.ModuleList(OrderClassifier(cfg, l)
                                   for l in range(1, cfg.k + 1))

    def head(self, l: int) -> OrderClassifier:
        return self.heads[l - 1]


def init_classifiers(cfg: GNNConfig, generator: torch.Generator,
                     device="cuda") -> Classifiers:
    """Random heads from `generator` (a CPU generator, so the weights are
    the same whatever the device), moved to `device`."""
    dev = resolve_device(device)
    cls = Classifiers(cfg)
    with torch.no_grad():
        for head in cls.heads:
            for lin in head.layers:
                fan_in = lin.in_features
                lin.weight.copy_(torch.randn(lin.weight.shape,
                                             generator=generator)
                                 / math.sqrt(fan_in))
                lin.bias.zero_()
            if cfg.base_model == "gamlp":
                head.att_w.copy_(0.02 * torch.randn(head.att_w.shape,
                                                    generator=generator))
                head.att_v.copy_(0.02 * torch.randn(head.att_v.shape,
                                                    generator=generator))
    return cls.to(dev).eval()


def classification_macs(cfg: GNNConfig, l: int) -> int:
    """MACs per node for f^(l) (Table 1 / Table 3 accounting)."""
    dims = cfg.layer_dims(l)
    macs = sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    if cfg.base_model == "gamlp":
        macs += (l + 1) * (cfg.feat_dim * cfg.att_dim + cfg.att_dim)
    return macs
