"""The comparison that decides `correct`.

For each compared batch the reference (`bench.reference.nai`) works out
again, from the generated graph and weights, every node's distance at
each decision order, its exit order and every head's logits. The
program's answer for a node is its exit order and its class. Two
numbers, each the widest over the compared nodes:

* ``order_gap``: for a node whose exit order differs from the
  reference's, how far the reference's squared distance lies from T_s^2
  at the first order where they disagree, as a share of T_s^2. A sound
  float32 program differs only where the distance lies within rounding
  of the threshold.
* ``logit_gap``: how far the reference logit of the class the program
  returned lies below the reference's best, at the program's exit order,
  as a share of that node's logit range (largest minus smallest).

An answer out of range reads infinity. Requests that failed or never
completed are counted apart (``missing``, limit 0).
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np


def gaps(ref_orders: np.ndarray, ref_dist: np.ndarray, ref_logits: np.ndarray,
         orders: np.ndarray, preds: np.ndarray, *, t_min: int, t_max: int,
         t_s: float) -> Dict[str, float]:
    """Widest ``order_gap`` and ``logit_gap`` of one batch's answers
    (``ref_dist`` (nb, t_max - t_min), ``ref_logits`` (t_max, nb, C))."""
    orders = np.asarray(orders, np.int64)
    preds = np.asarray(preds, np.int64)
    nb, n_cls = ref_logits.shape[1], ref_logits.shape[2]
    bad = (orders < 1) | (orders > t_max) | (preds < 0) | (preds >= n_cls)
    if bad.any():
        return {"order_gap": math.inf, "logit_gap": math.inf}
    ts2 = t_s * t_s
    order_gap = 0.0
    for i in np.flatnonzero(orders != ref_orders):
        l = int(min(orders[i], ref_orders[i]))
        if l < t_min:
            return {"order_gap": math.inf, "logit_gap": math.inf}
        d2 = float(ref_dist[i, l - t_min]) ** 2
        order_gap = max(order_gap, abs(d2 - ts2) / ts2)
    z = ref_logits[orders - 1, np.arange(nb)]
    span = z.max(axis=1) - z.min(axis=1)
    lg = (z.max(axis=1) - z[np.arange(nb), preds]) / np.maximum(span, 1e-300)
    return {"order_gap": order_gap, "logit_gap": float(lg.max(initial=0.0))}


def merge(a: Dict[str, float], b: Dict[str, float]) -> Dict[str, float]:
    return {k: max(a.get(k, 0.0), b.get(k, 0.0)) for k in set(a) | set(b)}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number at or under its limit."""
    return all(numbers[k] <= limits[k] for k in limits)
