"""The benchmark's frozen graph generator.

A copy of the port's degree-corrected stochastic block model
(`repro_torch.gnn.datasets.make_sbm`) with the same numpy call sequence,
so that a seed gives the same arrays as the port's `load_dataset` does
today, and a later change to the program cannot change the benchmark's
inputs. It returns plain numpy arrays: the harness wraps them for the
program, and the reference reads them as they are.

The preset's whole-number mean degree falls short of a published edge
count, and self loops and repeated pairs are dropped after the draw. With
``edges`` (the published count of undirected edges at scale 1.0) the
graph is topped up to exactly that count, scaled with the nodes, by
further draws of the same model from a second stream of the seed; the
labels, features and splits are those of the draw without it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

# name -> (nodes, mean degree, feature width, classes): the sizes of the
# paper's Table 2 (ogbn-arxiv, Flickr, ...) at scale 1.0
PRESETS = {
    "pubmed-like": (19_717, 4, 500, 3),
    "flickr-like": (89_250, 20, 500, 7),
    "arxiv-like": (169_343, 13, 128, 40),
    "products-like": (2_449_029, 100, 100, 47),
}


@dataclasses.dataclass
class GraphArrays:
    n: int
    src: np.ndarray          # (E,) int32, self loops last
    dst: np.ndarray          # (E,) int32
    features: np.ndarray     # (n, f) float32
    labels: np.ndarray       # (n,) int32
    num_classes: int
    train_idx: np.ndarray
    unlabeled_idx: np.ndarray
    test_idx: np.ndarray
    name: str


def make_sbm(name: str, *, scale: float = 1.0, seed: int,
             homophily: float = 0.9, power_law: float = 1.6,
             feature_noise: float = 1.8,
             edges: Optional[int] = None) -> GraphArrays:
    n_full, avg_deg, f, c = PRESETS[name]
    n = max(int(n_full * scale), 50 * c)
    rng = np.random.default_rng(seed)

    labels = rng.integers(0, c, n).astype(np.int32)
    theta = rng.pareto(power_law, n) + 1.0
    theta = np.clip(theta / theta.mean(), 0.05, 50.0)
    target_edges = n * avg_deg // 2

    def sample_endpoints(k, same_class, rng=rng):
        u = np.empty(k, np.int64)
        v = np.empty(k, np.int64)
        p = theta / theta.sum()
        u[:] = rng.choice(n, size=k, p=p)
        if same_class:
            order = np.argsort(labels, kind="stable")
            sorted_theta = theta[order]
            bounds = np.searchsorted(labels[order], np.arange(c + 1))
            for cls in range(c):
                m = labels[u] == cls
                lo, hi = bounds[cls], bounds[cls + 1]
                if hi <= lo or not m.any():
                    continue
                pc = sorted_theta[lo:hi] / sorted_theta[lo:hi].sum()
                v[m] = order[lo + rng.choice(hi - lo, size=m.sum(), p=pc)]
        else:
            v[:] = rng.choice(n, size=k, p=p)
        return u, v

    k_same = int(target_edges * homophily)
    u1, v1 = sample_endpoints(k_same, True)
    u2, v2 = sample_endpoints(target_edges - k_same, False)
    u = np.concatenate([u1, u2])
    v = np.concatenate([v1, v2])
    keep = u != v
    u, v = u[keep], v[keep]
    eid = np.unique(np.minimum(u, v) * n + np.maximum(u, v))
    if edges is not None:
        eid = _top_up(eid, (edges * n + n_full // 2) // n_full, n, homophily,
                      sample_endpoints, np.random.default_rng([seed, 1]))
    u, v = (eid // n).astype(np.int32), (eid % n).astype(np.int32)
    loop = np.arange(n, dtype=np.int32)
    src = np.concatenate([u, v, loop])
    dst = np.concatenate([v, u, loop])

    protos = rng.standard_normal((c, f)).astype(np.float32)
    feats = protos[labels] + feature_noise * rng.standard_normal(
        (n, f)).astype(np.float32)

    perm = rng.permutation(n)
    n_test = n // 5
    test_idx = perm[:n_test]
    rest = perm[n_test:]
    n_labeled = max(c * 20, int(0.05 * len(rest)))
    return GraphArrays(
        n=n, src=src, dst=dst, features=feats, labels=labels, num_classes=c,
        train_idx=rest[:n_labeled].astype(np.int32),
        unlabeled_idx=rest[n_labeled:].astype(np.int32),
        test_idx=test_idx.astype(np.int32), name=name)


def _top_up(eid: np.ndarray, target: int, n: int, homophily: float,
            sample_endpoints, rng: np.random.Generator) -> np.ndarray:
    """Sorted pair keys `eid` (u * n + v, u < v) with new pairs of the same
    model added until there are exactly `target`."""
    while len(eid) < target:
        need = target - len(eid)
        k = need + need // 4 + 64
        k_same = int(k * homophily)
        u1, v1 = sample_endpoints(k_same, True, rng)
        u2, v2 = sample_endpoints(k - k_same, False, rng)
        u = np.concatenate([u1, u2])
        v = np.concatenate([v1, v2])
        keep = u != v
        new = np.setdiff1d(np.minimum(u, v)[keep] * n + np.maximum(u, v)[keep],
                           eid)
        if len(new) > need:
            new = rng.choice(new, size=need, replace=False)
        eid = np.union1d(eid, new)
    return eid
