"""Synthetic graph datasets: the paper's OGB/Planetoid datasets are
replaced by deterministic generators with matched scale knobs.

The port's copy of `repro.gnn.datasets`: the same numpy call sequence, so
`load_dataset(name, scale, seed)` gives graphs array-equal to the JAX
package's for every seed.

Generator: degree-corrected stochastic block model. Classes are SBM blocks;
node features are noisy class prototypes, so feature propagation over the
homophilous graph genuinely improves classification — the same mechanism the
paper's technique exploits (nodes deep inside a block smooth quickly -> exit
early; boundary/high-degree nodes need more hops).

Reproducibility contract: every
generator takes an EXPLICIT seed — no module-level RNG, no default — and
routes all randomness through the one `np.random.Generator` seeded from
it, so the same (name, scale, seed) triple yields the same graph in every
process. Bench and test graphs are reproducible across machines because
of this; do not add `np.random.*` module calls here.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.gnn.graph import Graph, add_self_loops

# name -> (nodes, avg_degree, feat_dim, classes) — shaped after Table 2,
# cut to smaller sizes by `scale` (1.0 is the published size).
PRESETS: Dict[str, tuple] = {
    "pubmed-like":   (19_717, 4,  500, 3),
    "flickr-like":   (89_250, 20, 500, 7),
    "arxiv-like":    (169_343, 13, 128, 40),
    "products-like": (2_449_029, 100, 100, 47),
}


def make_sbm(name: str, *, scale: float = 1.0, seed: int,
             homophily: float = 0.9, power_law: float = 1.6,
             feature_noise: float = 1.8) -> Graph:
    if seed is None:
        raise ValueError("make_sbm requires an explicit integer seed "
                         "(graphs must be reproducible across processes)")
    n_full, avg_deg, f, c = PRESETS[name]
    n = max(int(n_full * scale), 50 * c)
    rng = np.random.default_rng(seed)

    labels = rng.integers(0, c, n).astype(np.int32)

    # degree-corrected: power-law degree propensities
    theta = rng.pareto(power_law, n) + 1.0
    theta = np.clip(theta / theta.mean(), 0.05, 50.0)
    target_edges = n * avg_deg // 2

    # sample edges: with prob `homophily` endpoints share a class
    def sample_endpoints(k, same_class):
        u = np.empty(k, np.int64)
        v = np.empty(k, np.int64)
        p = theta / theta.sum()
        u[:] = rng.choice(n, size=k, p=p)
        if same_class:
            # choose v from u's class, degree-weighted
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
    # symmetrize + dedupe
    eid = np.unique(np.minimum(u, v) * n + np.maximum(u, v))
    u, v = (eid // n).astype(np.int32), (eid % n).astype(np.int32)
    src = np.concatenate([u, v])
    dst = np.concatenate([v, u])
    src, dst = add_self_loops(src, dst, n)

    # features: class prototypes + noise
    protos = rng.standard_normal((c, f)).astype(np.float32)
    feats = protos[labels] + feature_noise * rng.standard_normal((n, f)).astype(np.float32)

    # inductive split: ~80% train region (small labeled core), 20% test
    perm = rng.permutation(n)
    n_test = n // 5
    test_idx = perm[:n_test]
    rest = perm[n_test:]
    n_labeled = max(c * 20, int(0.05 * len(rest)))
    train_idx = rest[:n_labeled]
    unlabeled_idx = rest[n_labeled:]

    return Graph(n=n, src=src, dst=dst, features=feats, labels=labels,
                 num_classes=c, train_idx=train_idx.astype(np.int32),
                 unlabeled_idx=unlabeled_idx.astype(np.int32),
                 test_idx=test_idx.astype(np.int32), name=name)


def load_dataset(name: str, scale: float = 1.0, seed: int = None,
                 hard: bool = False) -> Graph:
    """`hard=True`: noisier features + weaker homophily — used by the
    sensitivity benchmark (fig3) where the default generator saturates.
    `seed` is required (explicit-seed contract, module docstring)."""
    if seed is None:
        raise ValueError("load_dataset requires an explicit integer seed "
                         "(graphs must be reproducible across processes)")
    if hard:
        return make_sbm(name, scale=scale, seed=seed, homophily=0.65,
                        feature_noise=6.0)
    return make_sbm(name, scale=scale, seed=seed)
