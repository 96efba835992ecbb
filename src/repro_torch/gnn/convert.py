"""Load the JAX package's classifier parameters into the port's heads."""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.gnn.models import Classifiers, GNNConfig


def params_from_numpy(cfg: GNNConfig, tree: Mapping[int, Dict[str, np.ndarray]],
                      device="cuda") -> Classifiers:
    """`tree` is the JAX package's ``params["cls"]`` as numpy arrays:
    ``{l: {"w0": (in, out), "b0": (out,), ..., "att_w", "att_v"}}``. JAX
    computes ``x @ w + b``; `nn.Linear` stores its weight as (out, in), so
    each ``w{i}`` is transposed on the way in."""
    dev = resolve_device(device)
    cls = Classifiers(cfg)
    with torch.no_grad():
        for l in range(1, cfg.k + 1):
            p, head = tree[l], cls.head(l)
            for i, lin in enumerate(head.layers):
                w = np.asarray(p[f"w{i}"], np.float32)
                if w.shape != (lin.in_features, lin.out_features):
                    raise ValueError(f"order {l} w{i}: shape {w.shape}, "
                                     f"expected {(lin.in_features, lin.out_features)}")
                lin.weight.copy_(torch.tensor(w.T))
                lin.bias.copy_(torch.tensor(
                    np.asarray(p[f"b{i}"], np.float32)))
            if cfg.base_model == "gamlp":
                head.att_w.copy_(torch.tensor(
                    np.asarray(p["att_w"], np.float32)))
                head.att_v.copy_(torch.tensor(
                    np.asarray(p["att_v"], np.float32)))
    return cls.to(dev).eval()
