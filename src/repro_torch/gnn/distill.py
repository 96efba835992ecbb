"""NAI training procedure (paper Fig. 1 left), the port of
`repro.gnn.distill`: base-model training followed by Inception
Distillation (offline Eqs. 2-4, then online Eqs. 5-6).

Training is full-batch on the host-propagated series of the training
subgraph (`propagated_series`, numpy), which goes to the device once.
The heads' matmuls and their backward run on that device in IEEE f32
(TF32 off on CUDA). Dropout masks come from an explicit
`torch.Generator` on the device; they cannot equal the JAX package's
(another generator), so the two agree in distribution, and exactly only
at dropout 0.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.common import TrainConfig
from repro_torch.core.inception_distill import (ensemble_teacher, hard_ce,
                                                offline_loss, soft_ce)
from repro_torch.device import resolve_device
from repro_torch.gnn.graph import Graph, propagated_series
from repro_torch.gnn.models import Classifiers, GNNConfig, init_classifiers
from repro_torch.optim import adamw_init, adamw_update


@dataclasses.dataclass(frozen=True)
class DistillConfig:
    epochs_base: int = 300
    epochs_offline: int = 200
    epochs_online: int = 200
    lr: float = 0.01
    weight_decay: float = 1e-4
    temperature: float = 1.2      # T   (paper: [1, 2])
    lam: float = 0.9              # λ   (paper: online best in [0.8, 1])
    lam_off: float = 0.5          # λ for offline (paper: balance carefully)
    ensemble_r: int = 2           # r
    seed: int = 0


def _tc(dc: DistillConfig) -> TrainConfig:
    return TrainConfig(learning_rate=dc.lr, weight_decay=dc.weight_decay,
                       grad_clip=0.0, warmup_steps=0,
                       total_steps=max(dc.epochs_base, 1), schedule="constant")


def _fit(loss_fn: Callable[[nn.Module, torch.Generator], torch.Tensor],
         module: nn.Module, steps: int, tc: TrainConfig,
         generator: torch.Generator) -> Tuple[nn.Module, float]:
    """`steps` full-batch AdamW steps on every parameter of `module`, in
    place: each step takes ``loss_fn(module, generator)`` and its
    gradients (a parameter the loss does not reach gets a zero gradient
    and is still decayed, as in the reference). Returns (module, the last
    step's loss, taken before its update)."""
    params = dict(module.named_parameters())
    state = adamw_init(params, tc)
    loss = torch.tensor(float("inf"))
    for _ in range(steps):
        loss = loss_fn(module, generator)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
        grads = {k: torch.zeros_like(p) if gr is None else gr
                 for (k, p), gr in zip(params.items(), grads)}
        new, state, _ = adamw_update(grads, state, params, tc,
                                     tc.learning_rate)
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(new[k])
        loss = loss.detach()
    return module, float(loss)


def init_ensemble(cfg: GNNConfig, generator: torch.Generator,
                  device) -> torch.Tensor:
    """The ensemble projection s (C, 1) of Eq. 5, N(0, 0.02²) from the CPU
    `generator` (the reference's "small" init), on `device`."""
    return (0.02 * torch.randn((cfg.num_classes, 1), generator=generator)
            ).to(device)


def train_nai(cfg: GNNConfig, g: Graph, dc: DistillConfig = DistillConfig(),
              device="cuda", timings: Optional[Dict[str, float]] = None
              ) -> Tuple[Classifiers, Dict[str, float]]:
    """Train the heads f^(1..k) on `device` (``"cuda"`` unless asked;
    raises without a GPU). Returns (model, info): `model` is the
    `Classifiers` with its ensemble projection ``model.ens_s`` set, which
    `NAIServingEngine`, `infer_all` and `evaluate_classifier` take as it
    is; `info` holds each stage's last
    loss: ``base_loss``, ``offline_loss_{l}`` for l < k and
    ``online_loss``. `timings`, if given, receives the seconds of
    ``series`` (host propagation and the copy), ``base``, ``offline`` and
    ``online``, each read after synchronising the device."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def lap(name, t0):
        if timings is not None:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            timings[name] = time.perf_counter() - t0
        return time.perf_counter()

    t0 = time.perf_counter()
    g_train = g.train_subgraph()
    series = propagated_series(g_train, g.features, cfg.k, cfg.r)
    feats = torch.from_numpy(np.stack(series)).to(dev)      # (k+1, n, f)
    labels = torch.from_numpy(g.labels).long().to(dev)
    vl = torch.from_numpy(g.train_idx).long().to(dev)      # labeled V_l
    vtrain = torch.from_numpy(
        np.concatenate([g.train_idx, g.unlabeled_idx])).long().to(dev)
    feats_vl, feats_vt = feats[:, vl], feats[:, vtrain]
    y_vl, y_vt = labels[vl], labels[vtrain]
    del feats
    tc = _tc(dc)
    gen_init = torch.Generator().manual_seed(dc.seed)
    gen = torch.Generator(dev).manual_seed(dc.seed)
    cls = init_classifiers(cfg, gen_init, device=dev)
    info: Dict[str, float] = {}
    t0 = lap("series", t0)

    # ---- 1. base model f^(k) (Eq. 2)
    def base_loss(head, rng):
        return hard_ce(head(feats_vl, generator=rng), y_vl)

    _, info["base_loss"] = _fit(base_loss, cls.head(cfg.k), dc.epochs_base,
                                tc, gen)
    t0 = lap("base", t0)

    # ---- 2. offline distillation into f^(l), l < k (Eqs. 3-4)
    with torch.no_grad():
        teacher_vt = cls.head(cfg.k)(feats_vt)
    for l in range(1, cfg.k):
        def off_loss(head, rng):
            kd = offline_loss(head(feats_vt, generator=rng), teacher_vt,
                              y_vt, temperature=dc.temperature, lam=1.0)
            ce = hard_ce(head(feats_vl), y_vl)
            return (1 - dc.lam_off) * ce + dc.lam_off * kd

        _, info[f"offline_loss_{l}"] = _fit(off_loss, cls.head(l),
                                            dc.epochs_offline, tc, gen)
    t0 = lap("offline", t0)

    # ---- 3. online distillation with the self-attention ensemble (Eqs. 5-6)
    cls.ens_s = nn.Parameter(init_ensemble(cfg, gen_init, dev))
    r = min(dc.ensemble_r, cfg.k)

    def on_loss(m, rng):
        zs = {l: m.head(l)(feats_vt) for l in range(1, cfg.k + 1)}
        ens = ensemble_teacher([zs[l] for l in range(cfg.k - r + 1,
                                                     cfg.k + 1)], m.ens_s)
        total = 0.0
        for l in range(1, cfg.k):
            # L_on = (1-λ)·L_c(V_l, hard labels) + λ·T²·L_e(V_train, ensemble)
            kd = soft_ce(zs[l], ens, dc.temperature)
            z_vl = m.head(l)(feats_vl, generator=rng)
            total = total + dc.lam * dc.temperature ** 2 * kd \
                + (1 - dc.lam) * hard_ce(z_vl, y_vl)
        return total / max(cfg.k - 1, 1)

    _, info["online_loss"] = _fit(on_loss, cls, dc.epochs_online, tc, gen)
    lap("online", t0)
    return cls.eval(), info


def evaluate_classifier(cfg: GNNConfig, classifiers: Classifiers, feats,
                        labels, idx, l: int) -> float:
    """Accuracy of f^(l) on the nodes `idx` of the series `feats` ((k+1,
    N, f), numpy or tensor), on the heads' device."""
    dev = next(classifiers.parameters()).device
    x = torch.as_tensor(feats)[:, torch.as_tensor(idx).long()].to(dev)
    with torch.inference_mode():
        pred = classifiers.head(l)(x).argmax(dim=-1).cpu().numpy()
    return float((pred == np.asarray(labels)[idx]).mean())
