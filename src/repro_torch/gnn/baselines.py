"""Paper baselines (§4.1): GLNN, TinyGNN (lite), INT8 quantization and the
vanilla base model; the port of `repro.gnn.baselines` (the rows of the
paper's Table 3).

All baselines share the NAI evaluation harness: ACC + per-node MACs split
into feature processing and classification + wall time. They run on the
device of the heads they are given. On CUDA every time is read after
`torch.cuda.synchronize()`, so it includes the device's work, as the
reference's clock includes it through `np.asarray`.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.common import TrainConfig
from repro_torch.core.inception_distill import hard_ce, offline_loss
from repro_torch.gnn.convert import params_from_numpy, params_to_numpy
from repro_torch.gnn.distill import _fit as _fit_module
from repro_torch.gnn.graph import Graph, propagated_series
from repro_torch.gnn.models import Classifiers, GNNConfig, OrderClassifier
from repro_torch.gnn.nai import NAIConfig, infer_all

Defs = Dict[str, Tuple[Tuple[int, ...], str]]


def _mlp_defs(dims) -> Defs:
    out = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        out[f"w{i}"] = ((a, b), "fan_in")
        out[f"b{i}"] = ((b,), "zeros")
    return out


def init_params(defs: Defs, generator: torch.Generator,
                device) -> Dict[str, torch.Tensor]:
    """name -> (shape, "fan_in" | "zeros") as tensors on `device`, drawn
    from the CPU `generator` in the order of `defs`: fan-in normal weights
    (std 1/sqrt(shape[-2]), as `repro.nn.params`), zero biases."""
    out = {}
    for name, (shape, kind) in defs.items():
        if kind == "zeros":
            out[name] = torch.zeros(shape)
        else:
            out[name] = (torch.randn(shape, generator=generator)
                         / math.sqrt(shape[-2]))
    return {k: v.to(device) for k, v in out.items()}


def _mlp_apply(p, x, n_layers):
    for i in range(n_layers):
        x = x @ p[f"w{i}"] + p[f"b{i}"]
        if i < n_layers - 1:
            x = torch.relu(x)
    return x


def _fit(loss_fn, params: Dict[str, torch.Tensor], steps: int, lr=0.01,
         wd=1e-4) -> Dict[str, torch.Tensor]:
    tc = TrainConfig(learning_rate=lr, weight_decay=wd, grad_clip=0.0,
                     schedule="constant")
    pd = nn.ParameterDict({k: nn.Parameter(v.clone())
                           for k, v in params.items()})
    _fit_module(lambda m, _: loss_fn(m), pd, steps, tc, None)
    return {k: v.detach() for k, v in pd.items()}


def _device_of(module: nn.Module) -> torch.device:
    return next(module.parameters()).device


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _teacher_logits(cfg: GNNConfig, g: Graph, teacher: OrderClassifier,
                    dev: torch.device):
    """(series of the training subgraph on `dev`, V_train ids, f^(k)'s
    logits on V_train)."""
    g_train = g.train_subgraph()
    series = propagated_series(g_train, g.features, cfg.k, cfg.r)
    feats = torch.from_numpy(np.stack(series)).to(dev)
    vtrain = np.concatenate([g.train_idx, g.unlabeled_idx])
    with torch.no_grad():
        teacher_vt = teacher(feats[:, torch.from_numpy(vtrain).long()
                                   .to(dev)])
    return feats, vtrain, teacher_vt


# ----------------------------------------------------------------- GLNN [39]
@dataclasses.dataclass
class BaselineResult:
    acc: float
    macs: float          # per node, total
    fp_macs: float       # per node, feature processing
    time_s: float
    fp_time_s: float


def run_glnn(cfg: GNNConfig, g: Graph, teacher: OrderClassifier, *,
             width_mult: int = 4, epochs: int = 300,
             temperature: float = 1.2, lam: float = 0.9,
             seed: int = 0) -> BaselineResult:
    """Distill f^(k) (`teacher`, the trained head of order k) into a plain
    MLP over raw features; inference touches NO edges (the paper's
    extreme case of NAI with order 0)."""
    dev = _device_of(teacher)
    _, vtrain, teacher_vt = _teacher_logits(cfg, g, teacher, dev)

    def on(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    dims = [cfg.feat_dim, cfg.hidden * width_mult, cfg.num_classes]
    params = init_params(_mlp_defs(dims), torch.Generator().manual_seed(seed),
                         dev)
    x_train = on(g.features[vtrain])
    y_l = on(g.labels[g.train_idx]).long()
    x_l = on(g.features[g.train_idx])
    labels_vt = on(g.labels[vtrain]).long()

    def loss(p):
        z = _mlp_apply(p, x_train, 2)
        kd = offline_loss(z, teacher_vt, labels_vt, temperature=temperature,
                          lam=1.0)
        ce = hard_ce(_mlp_apply(p, x_l, 2), y_l)
        return lam * kd + (1 - lam) * ce

    params = _fit(loss, params, epochs)

    t0 = time.perf_counter()
    with torch.inference_mode():
        z = _mlp_apply(params, on(g.features[g.test_idx]), 2).cpu().numpy()
    _sync(dev)
    dt = time.perf_counter() - t0
    acc = float((z.argmax(-1) == g.labels[g.test_idx]).mean())
    macs = sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    return BaselineResult(acc=acc, macs=macs, fp_macs=0.0, time_s=dt,
                          fp_time_s=0.0)


# ------------------------------------------------------------- TinyGNN [34]
def run_tinygnn(cfg: GNNConfig, g: Graph, teacher: OrderClassifier, *,
                epochs: int = 300, temperature: float = 1.2,
                lam: float = 0.9, seed: int = 0) -> BaselineResult:
    """Single-hop GNN student with a peer-aware self-attention module,
    distilled from f^(k). Captures the paper's trade-off: 1-hop propagation
    + an attention module whose extra MACs dominate on high-dim features.
    The full graph's 1-hop propagation at inference runs on the host."""
    dev = _device_of(teacher)
    feats, vtrain, teacher_vt = _teacher_logits(cfg, g, teacher, dev)

    f, h, c = cfg.feat_dim, cfg.hidden, cfg.num_classes
    defs = {"att_q": ((f, h), "fan_in"), "att_k": ((f, h), "fan_in"),
            "att_v": ((f, f), "fan_in"), **_mlp_defs([f, h, c])}
    params = init_params(defs, torch.Generator().manual_seed(seed), dev)

    def peer_aware(p, x1, x0):
        """x1: 1-hop propagated; x0: raw. Peer attention between the two
        views (the PAM module, reduced to the 2-view case)."""
        q = x0 @ p["att_q"]
        kk = x1 @ p["att_k"]
        a = torch.sigmoid(torch.sum(q * kk, -1, keepdim=True)
                          / math.sqrt(float(q.shape[-1])))
        return a * (x1 @ p["att_v"]) + (1 - a) * x0

    def forward(p, x1, x0):
        return _mlp_apply(p, peer_aware(p, x1, x0), 2)

    vt = torch.from_numpy(vtrain).long().to(dev)
    x1_t, x0_t = feats[1][vt], feats[0][vt]
    del feats
    labels_vt = torch.from_numpy(g.labels[vtrain]).long().to(dev)

    def loss(p):
        z = forward(p, x1_t, x0_t)
        kd = offline_loss(z, teacher_vt, labels_vt, temperature=temperature,
                          lam=1.0)
        return lam * kd + (1 - lam) * hard_ce(z, labels_vt)

    params = _fit(loss, params, epochs)

    # inference: 1-hop propagation for test nodes + PAM + MLP
    t0 = time.perf_counter()
    series_full = propagated_series(g, g.features, 1, cfg.r)
    fp_dt = time.perf_counter() - t0
    x1 = torch.from_numpy(series_full[1][g.test_idx]).to(dev)
    x0 = torch.from_numpy(g.features[g.test_idx]).to(dev)
    with torch.inference_mode():
        z = forward(params, x1, x0).cpu().numpy()
    _sync(dev)
    dt = time.perf_counter() - t0
    acc = float((z.argmax(-1) == g.labels[g.test_idx]).mean())

    deg = float(g.degrees.mean() + 1)
    fp_macs = deg * f + 2 * (f * h) + f * f          # 1-hop spmm + PAM
    cls_macs = f * h + h * c
    return BaselineResult(acc=acc, macs=fp_macs + cls_macs, fp_macs=fp_macs,
                          time_s=dt, fp_time_s=fp_dt)


# --------------------------------------------------------- quantization [25]
def _fixed_order_inference(cfg: GNNConfig, g: Graph,
                           classifiers: Classifiers,
                           batch_size: int = 500) -> BaselineResult:
    """Fixed k-order propagation through the SAME inductive batched pipeline
    as NAI (support sampling per batch): NAP with T_s=0 degenerates to
    exactly this, so MAC/time accounting is apples-to-apples (paper §4.1).
    The host path reads each batch's predictions back from the device
    before it reads the clock."""
    nai = NAIConfig(t_s=0.0, t_min=1, t_max=cfg.k, batch_size=batch_size)
    res = infer_all(cfg, nai, classifiers, g)
    acc = float((res.predictions == g.labels[g.test_idx]).mean())
    return BaselineResult(acc=acc, macs=res.total_macs, fp_macs=res.fp_macs,
                          time_s=res.wall_time_s, fp_time_s=res.fp_time_s)


def run_quantized(cfg: GNNConfig, g: Graph, classifiers: Classifiers, *,
                  seed: int = 0) -> BaselineResult:
    """Post-training INT8 quantization of the classifiers: weights are
    fake-quantized per-tensor; feature propagation stays FP32 (the paper's
    point: quantization cannot touch feature-processing cost, so fp_macs
    equal vanilla's)."""
    def q(x):
        x = np.asarray(x)
        s = np.abs(x).max() / 127.0 + 1e-12
        return (np.round(x / s).clip(-127, 127) * s).astype(np.float32)

    tree = params_to_numpy(classifiers)["cls"]
    qcls = params_from_numpy(
        cfg, {l: {k: q(v) for k, v in p.items()} for l, p in tree.items()},
        device=_device_of(classifiers))
    return _fixed_order_inference(cfg, g, qcls)


def run_vanilla(cfg: GNNConfig, g: Graph,
                classifiers: Classifiers) -> BaselineResult:
    """The vanilla base model: full k-order propagation for every node."""
    return _fixed_order_inference(cfg, g, classifiers)
