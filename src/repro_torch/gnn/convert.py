"""Carry classifier parameters between the JAX package's trees and the
port's heads, both ways. A ``jk_gamlp`` head has no JAX counterpart:
its tree's keys are the ones `_jk_gamlp_leaves` names."""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.gnn.models import Classifiers, GNNConfig, JKGAMLPHead


def _jk_gamlp_leaves(head: JKGAMLPHead) -> Dict[str, torch.Tensor]:
    """A ``jk_gamlp`` head's tree keys and the tensors they fill: per hop j
    ``hop{j}_w0 / _b0 / _prelu / _w1 / _b1``; ``jk_w{i}``, ``jk_prelu``;
    ``att_u`` (2 hidden, 1), ``att_c``; ``res_w``, ``res_b``; ``prelu``
    (the head's own); ``out_w{i}``, ``out_prelu``. A matrix is (in, out)
    in the tree, the transpose of `nn.Linear`'s weight. ``alpha`` is the
    configuration's (`GNNConfig.alpha`), not a leaf: a tree's other keys
    are not read."""
    out = {}
    for j, (a, act, b) in enumerate(head.process):
        out.update({f"hop{j}_w0": a.weight, f"hop{j}_b0": a.bias,
                    f"hop{j}_prelu": act.weight, f"hop{j}_w1": b.weight,
                    f"hop{j}_b1": b.bias})
    for name, net in (("jk", head.jk), ("out", head.out)):
        out.update({f"{name}_w{i}": lin.weight
                    for i, lin in enumerate(net.layers)})
        out[f"{name}_prelu"] = net.prelu.weight
    out.update(att_u=head.att.weight, att_c=head.att.bias,
               res_w=head.res.weight, res_b=head.res.bias,
               prelu=head.prelu.weight)
    return out


def _load_jk_gamlp(l: int, p, head: JKGAMLPHead) -> None:
    for key, t in _jk_gamlp_leaves(head).items():
        v = np.asarray(p[key], np.float32)
        v = v.T if t.dim() == 2 else v
        if v.shape != tuple(t.shape):
            raise ValueError(f"order {l} {key}: shape {np.shape(p[key])}, "
                             f"expected {tuple(t.shape)[::-1]}")
        t.copy_(torch.from_numpy(np.ascontiguousarray(v)))


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
            if cfg.base_model == "jk_gamlp":
                _load_jk_gamlp(l, p, head)
                continue
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


def params_to_numpy(classifiers: Classifiers) -> Dict:
    """The heads as the JAX package's params: ``{"cls": {l: {"w0": (in,
    out), "b0": (out,), ...}}}``, each ``w{i}`` transposed back, plus
    ``"ens_s"`` (C, 1) once training has set it; ``["cls"]`` is what
    `params_from_numpy` takes. The JAX engine and `infer_all` take the
    result as it is."""
    cfg = classifiers.cfg
    cls = {}
    for l in range(1, cfg.k + 1):
        head = classifiers.head(l)
        if cfg.base_model == "jk_gamlp":
            cls[l] = {k: (t.detach().cpu().numpy().T if t.dim() == 2
                          else t.detach().cpu().numpy()).copy()
                      for k, t in _jk_gamlp_leaves(head).items()}
            continue
        p = {}
        for i, lin in enumerate(head.layers):
            p[f"w{i}"] = lin.weight.detach().cpu().numpy().T.copy()
            p[f"b{i}"] = lin.bias.detach().cpu().numpy().copy()
        if cfg.base_model == "gamlp":
            p["att_w"] = head.att_w.detach().cpu().numpy().copy()
            p["att_v"] = head.att_v.detach().cpu().numpy().copy()
        cls[l] = p
    out = {"cls": cls}
    if classifiers.ens_s is not None:
        out["ens_s"] = classifiers.ens_s.detach().cpu().numpy().copy()
    return out
