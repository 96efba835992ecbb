"""Linear-propagation scalable GNNs (paper §2.2) as per-order classifiers.

NAI needs one classifier f^(l) per propagation order l = 1..k. The base
model decides what f^(l) consumes:
    SGC   : X^(l)                      (linear/MLP head)
    S2GC  : mean(X^(0)..X^(l))
    SIGN  : concat(X^(0)..X^(l)) -> MLP
    GAMLP : node-wise attention over X^(0)..X^(l) -> MLP  (the repo's
            reduced JK-attention form)
    JK_GAMLP : GAMLP as published (Zhang et al., KDD 2022,
            arXiv:2206.04355) in its JK-attention form: `JKGAMLPHead`

The port of `repro.gnn.models` (``jk_gamlp`` has no JAX counterpart):
each head is an `nn.Module` taking the stacked series (l+1, N, f) like
the JAX `apply_classifier`, with training dropout drawn from an explicit
generator.
Initialization follows `repro.nn.params` (fan-in normal weights, zero
biases, 0.02-scaled attention) drawn from an explicit `torch.Generator`;
`repro_torch.gnn.convert.params_from_numpy` loads the JAX package's
parameters instead.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import torch
from torch import nn

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    base_model: str            # sgc | s2gc | sign | gamlp | jk_gamlp
    feat_dim: int
    num_classes: int
    k: int                     # max propagation order
    r: float = 0.5             # convolution coefficient (Eq. 1)
    hidden: int = 128
    mlp_layers: int = 2        # P in Table 1
    dropout: float = 0.2       # training only (forward's `generator`)
    att_dim: int = 32          # GAMLP attention projection
    jk_layers: int = 4         # JK_GAMLP's reference net depth (n_layers_1)
    alpha: float = 0.5         # JK_GAMLP's initial-residual weight

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

    def forward(self, feats: torch.Tensor, *,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Logits (N, num_classes) of f^(l) on the series feats. With a
        `generator` (training), inverted dropout at rate ``cfg.dropout``
        before every layer, the first included, its masks drawn from that
        generator (which must live on feats' device)."""
        x = self.combine(feats)
        p = self.cfg.dropout
        for i, layer in enumerate(self.layers):
            if generator is not None and p > 0:
                keep = torch.rand(x.shape, generator=generator,
                                  device=x.device) < 1 - p
                x = torch.where(keep, x / (1 - p), 0.0)
            x = layer(x)
            if i < len(self.layers) - 1:
                x = torch.relu(x)
        return x


def _dense(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``x W``, plus ``x`` where the layer keeps the width."""
    y = layer(x)
    return y + x if layer.in_features == layer.out_features else y


class ResidualNet(nn.Module):
    """GAMLP's ``FeedForwardNetII`` without batch norm or dropout:
    bias-free layers d_in -> hidden ... -> d_out and one PReLU q. The
    first layer gives h_1 = x W_1 (+ x where the width is kept), each
    middle layer ``((1 - alpha) q(h) + alpha h_1) W_i + q(h)`` (GCNII's
    initial residual), the last ``q(h) W_last`` (+ q(h) likewise)."""

    def __init__(self, d_in: int, hidden: int, d_out: int, n_layers: int,
                 alpha: float):
        super().__init__()
        dims = [d_in] + [hidden] * (n_layers - 1) + [d_out]
        self.layers = nn.ModuleList(nn.Linear(a, b, bias=False)
                                    for a, b in zip(dims[:-1], dims[1:]))
        self.prelu = nn.PReLU(init=0.25)
        self.alpha = alpha

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h0 = x = _dense(self.layers[0], x)
        last = len(self.layers) - 1
        for i in range(1, last + 1):
            x = self.prelu(x)
            if i < last:
                x = self.layers[i]((1 - self.alpha) * x + self.alpha * h0) + x
            else:
                x = _dense(self.layers[i], x)
        return x


class JKGAMLPHead(nn.Module):
    """f^(l) of GAMLP as published (PKU-DAIR/GAMLP ``JK_GAMLP``), for
    inference: no dropout, no batch norm, no label reuse (unseen nodes
    have no labels), sigmoid hop scores as in the paper.

    On X^(0..l): per hop j a 2-layer net ``Z_j = p_j(X^(j) A_j + a_j) B_j
    + b_j``; the JK reference ``E = g(ResidualNet([Z_0 || ... || Z_l]))``;
    hop scores ``sigmoid([E || Z_j] u + c)``, softmax over the hops, ``R =
    sum_j w_j Z_j``; ``R' = g(R + X^(0) V + v)``; logits
    ``ResidualNet(R')`` to the classes. g is the head's own PReLU."""

    def __init__(self, cfg: GNNConfig, l: int):
        super().__init__()
        f, h = cfg.feat_dim, cfg.hidden
        self.cfg, self.order = cfg, l
        self.process = nn.ModuleList(
            nn.Sequential(nn.Linear(f, h), nn.PReLU(init=0.25),
                          nn.Linear(h, h)) for _ in range(l + 1))
        self.jk = ResidualNet((l + 1) * h, h, h, cfg.jk_layers, cfg.alpha)
        self.att = nn.Linear(2 * h, 1)
        self.res = nn.Linear(f, h)
        self.prelu = nn.PReLU(init=0.25)
        self.out = ResidualNet(h, h, cfg.num_classes, cfg.mlp_layers,
                               cfg.alpha)

    def forward(self, feats: torch.Tensor, *,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Logits (N, num_classes) of f^(l) on the series feats (>= l+1,
        N, f)."""
        if generator is not None:
            raise NotImplementedError(
                "jk_gamlp heads are served only: training them (dropout, "
                "train_nai) is not implemented")
        z = [hop(feats[j]) for j, hop in enumerate(self.process)]
        e = self.prelu(self.jk(torch.cat(z, dim=1)))
        scores = torch.cat([torch.sigmoid(self.att(torch.cat((e, zj), dim=1)))
                            for zj in z], dim=1)
        w = torch.softmax(scores, dim=1)
        r = sum(w[:, j:j + 1] * zj for j, zj in enumerate(z))
        return self.out(self.prelu(r + self.res(feats[0])))


class Classifiers(nn.Module):
    """The per-order heads f^(1..k); `head(l)` is f^(l). `ens_s` is the
    (C, 1) projection s of the self-attention ensemble (Eq. 5): None until
    `train_nai`'s online stage trains it beside the heads; inference does
    not use it."""

    def __init__(self, cfg: GNNConfig):
        super().__init__()
        self.cfg = cfg
        head = JKGAMLPHead if cfg.base_model == "jk_gamlp" \
            else OrderClassifier
        self.heads = nn.ModuleList(head(cfg, l) for l in range(1, cfg.k + 1))
        self.register_parameter("ens_s", None)

    def head(self, l: int) -> nn.Module:
        return self.heads[l - 1]


def init_classifiers(cfg: GNNConfig, generator: torch.Generator,
                     device="cuda") -> Classifiers:
    """Random heads from `generator` (a CPU generator, so the weights are
    the same whatever the device), moved to `device`."""
    dev = resolve_device(device)
    if cfg.base_model == "jk_gamlp":
        raise NotImplementedError(
            "jk_gamlp heads are served only: load their weights with "
            "repro_torch.gnn.convert.params_from_numpy")
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
    if cfg.base_model == "jk_gamlp":
        f, h = cfg.feat_dim, cfg.hidden

        def net(d_in, d_out, n):
            dims = [d_in] + [h] * (n - 1) + [d_out]
            return sum(a * b for a, b in zip(dims[:-1], dims[1:]))
        # hop nets, JK net, hop scores and weighted sum, residual, output
        return ((l + 1) * (f * h + h * h) + net((l + 1) * h, h, cfg.jk_layers)
                + (l + 1) * (2 * h + h) + f * h
                + net(h, cfg.num_classes, cfg.mlp_layers))
    dims = cfg.layer_dims(l)
    macs = sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    if cfg.base_model == "gamlp":
        macs += (l + 1) * (cfg.feat_dim * cfg.att_dim + cfg.att_dim)
    return macs
