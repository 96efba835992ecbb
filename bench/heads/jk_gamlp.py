"""GAMLP as published, in its JK-attention form (Zhang et al., KDD 2022,
arXiv:2206.04355; PKU-DAIR/GAMLP ``model.py``, class ``JK_GAMLP`` with
``FeedForwardNet`` and ``FeedForwardNetII``), for inference.

Head f^(l) on X^(0..l), with H = ``hidden``, alpha = ``alpha`` and P_m
a PReLU with one slope per module m:

* per hop j = 0..l, ``FeedForwardNet(f, H, H, 2)``:
  ``Z_j = P_hop{j}(X^(j) A_j + a_j) B_j + b_j``;
* the JK reference, ``FeedForwardNetII((l+1) H, H, H, jk_layers)``
  (bias-free layers, PReLU q): ``h_1 = [Z_0 || ... || Z_l] W_1``, each
  middle layer ``((1 - alpha) q(h) + alpha h_1) W_i + q(h)``, the last
  ``q(h) W_last + q(h)``; ``E = g(h_last)`` with the head's own PReLU g;
* hop attention: ``s_j = sigmoid([E || Z_j] u + c)``, ``w =
  softmax_j(s)``, ``R = sum_j w_j Z_j``;
* the residual: ``R' = g(R + X^(0) V + v)``;
* the output, ``FeedForwardNetII(H, H, C, mlp_layers)`` (PReLU o):
  ``y_1 = R' O_1 + R'``, middle layers as above with y_1 in h_1's place,
  logits ``o(y) O_last`` (no residual: H != C).

Departures from the published model, each a setting of its code:

* no label reuse (RLU, ``label_fc``): NAI's unseen nodes have no labels;
* no dropout: this is evaluation;
* batch norm off (``bns``, the code's default);
* delta = sigmoid, as in the paper (the code's ``--act`` also offers
  ReLU and leaky ReLU);
* ``pre_process`` and ``residual`` on: the architecture's full form.

Weights per order (a matrix stored (in, out), as ``x @ w``): per hop
``hop{j}_w0 / _b0 / _prelu / _w1 / _b1``; ``jk_w{i}``, ``jk_prelu``;
``att_u`` (2H, 1), ``att_c`` (1,); ``res_w``, ``res_b``; ``prelu``;
``out_w{i}``, ``out_prelu``: the port's tree for the head
(`repro_torch.gnn.convert`). Besides, ``alpha`` (1,), the
configuration's, which the port takes from its configuration: `logits`
sees only the order's weights, so it reads alpha there. Matrices fan-in
normal, biases normal draws scaled by 0 (as `mlp_draws`), slopes 0.25
(the published init).
"""
import math

import torch


def _net_dims(d_in: int, hidden: int, d_out: int, n: int) -> list:
    return [d_in] + [hidden] * (n - 1) + [d_out]


def _matrix(l: int, key: str, a: int, b: int) -> tuple:
    return (l, key, (a, b), ("normal", 1.0 / math.sqrt(a)))


def _bias(l: int, key: str, b: int) -> tuple:
    return (l, key, (b,), ("normal", 0.0))


def _slope(l: int, key: str) -> tuple:
    return (l, key, (1,), ("const", 0.25))


def _net_draws(l: int, name: str, dims: list) -> list:
    out = [_matrix(l, f"{name}_w{i}", a, b)
           for i, (a, b) in enumerate(zip(dims[:-1], dims[1:]))]
    return out + [_slope(l, f"{name}_prelu")]


def draws(gcfg: dict) -> list:
    f, h, c = gcfg["feat_dim"], gcfg["hidden"], gcfg["num_classes"]
    out = []
    for l in range(1, gcfg["k"] + 1):
        for j in range(l + 1):
            out += [_matrix(l, f"hop{j}_w0", f, h), _bias(l, f"hop{j}_b0", h),
                    _slope(l, f"hop{j}_prelu"),
                    _matrix(l, f"hop{j}_w1", h, h), _bias(l, f"hop{j}_b1", h)]
        out += _net_draws(l, "jk", _net_dims((l + 1) * h, h, h,
                                             gcfg["jk_layers"]))
        out += [_matrix(l, "att_u", 2 * h, 1), _bias(l, "att_c", 1),
                _matrix(l, "res_w", f, h), _bias(l, "res_b", h),
                _slope(l, "prelu")]
        out += _net_draws(l, "out", _net_dims(h, h, c, gcfg["mlp_layers"]))
        out.append((l, "alpha", (1,), ("const", gcfg["alpha"])))
    return out


def _prelu(x, a):
    return torch.where(x >= 0, x, a * x)


def _residual_net(p, name, x, mm):
    """``FeedForwardNetII`` without batch norm or dropout."""
    alpha, n = p["alpha"], 0
    while f"{name}_w{n}" in p:
        n += 1

    def dense(w, x):
        y = mm(x, w)
        return y + x if w.shape[0] == w.shape[1] else y
    h0 = x = dense(p[f"{name}_w0"], x)
    for i in range(1, n):
        x = _prelu(x, p[f"{name}_prelu"])
        w = p[f"{name}_w{i}"]
        if i < n - 1:
            x = mm((1 - alpha) * x + alpha * h0, w) + x
        else:
            x = dense(w, x)
    return x


def logits(p, series, l, mm):
    z = [mm(_prelu(mm(series[j], p[f"hop{j}_w0"]) + p[f"hop{j}_b0"],
                   p[f"hop{j}_prelu"]), p[f"hop{j}_w1"]) + p[f"hop{j}_b1"]
         for j in range(l + 1)]
    e = _prelu(_residual_net(p, "jk", torch.cat(z, dim=1), mm), p["prelu"])
    s = torch.cat([torch.sigmoid(mm(torch.cat([e, zj], dim=1), p["att_u"])
                                 + p["att_c"]) for zj in z], dim=1)
    w = torch.softmax(s, dim=1)
    r = sum(w[:, j:j + 1] * zj for j, zj in enumerate(z))
    r = _prelu(r + mm(series[0], p["res_w"]) + p["res_b"], p["prelu"])
    return _residual_net(p, "out", r, mm)


def macs(gcfg: dict, l: int) -> int:
    """Every product above per node: the l+1 hop nets, the JK net, each
    hop's score ([E || Z_j] u, 2H) and its share of the weighted sum (H),
    the residual projection and the output net."""
    f, h, c = gcfg["feat_dim"], gcfg["hidden"], gcfg["num_classes"]

    def net(dims):
        return sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    return ((l + 1) * (f * h + h * h)
            + net(_net_dims((l + 1) * h, h, h, gcfg["jk_layers"]))
            + (l + 1) * 3 * h + f * h
            + net(_net_dims(h, h, c, gcfg["mlp_layers"])))
