"""The benchmark's head architectures, one file each.

`load(base_model)` returns the module ``bench/heads/<base_model>.py``,
found by the name a configuration's ``gnn.base_model`` gives, so that a
new head architecture is one new file. A head module imports nothing of
the program or of JAX, reads only the configuration's ``gnn`` dict, and
defines:

* ``draws(gcfg)``: a list of ``(order, key, shape, init)``, ``init``
  either ``("normal", scale)`` or ``("const", value)``. The normal
  entries take consecutive slices of one flat ``torch.randn`` draw, in
  the list's order (`bench.harness.make_heads`); constants take none;
* ``logits(p, series, l, mm)``: the logits of head f^(l), with order l's
  weights ``p``, on the series X^(0..l) (>= l+1, N, f), every matrix
  product through ``mm`` (the reference's plain or TF32 product);
* ``macs(gcfg, l)``: the multiply-adds per node of f^(l)
  (`bench.metrics._counting.head_flops`).

The helpers below are the MLP that the heads end in.
"""
from __future__ import annotations

import importlib.util
import math
from pathlib import Path
from typing import List

import torch

HEADS = Path(__file__).resolve().parent


def load(base_model: str):
    """The head module of `base_model`."""
    path = HEADS / f"{base_model}.py"
    if not path.is_file():
        raise FileNotFoundError(
            f"no head architecture {base_model!r}: {path} does not exist")
    spec = importlib.util.spec_from_file_location(
        f"bench.heads.{base_model}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def mlp_dims(gcfg: dict, d_in: int) -> List[int]:
    """Widths of an MLP from `d_in` to the classes, ``mlp_layers`` deep."""
    n = gcfg["mlp_layers"]
    hidden = [gcfg["hidden"]] * (n - 1) if n > 1 else []
    return [d_in] + hidden + [gcfg["num_classes"]]


def mlp_draws(dims: List[int], l: int) -> list:
    """Order l's MLP weights, fan-in normal, and zero biases. The biases
    are normal draws scaled by 0, not constants, so that they keep their
    slices of the draw and each seed gives the weights it always gave."""
    out = []
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        out.append((l, f"w{i}", (a, b), ("normal", 1.0 / math.sqrt(a))))
        out.append((l, f"b{i}", (b,), ("normal", 0.0)))
    return out


def mlp(p: dict, h: torch.Tensor, mm) -> torch.Tensor:
    """``h @ w0 + b0``, ReLU, ... through the last layer ``w{i}`` in `p`."""
    i = 0
    while f"w{i}" in p:
        h = mm(h, p[f"w{i}"]) + p[f"b{i}"]
        i += 1
        if f"w{i}" in p:
            h = torch.relu(h)
    return h


def mlp_macs(dims: List[int]) -> int:
    return sum(a * b for a, b in zip(dims[:-1], dims[1:]))
