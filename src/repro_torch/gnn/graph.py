"""Graph container + normalized adjacency utilities (numpy, host side).

Graphs are stored as COO edge lists with CSR indptr for neighborhood
queries. The propagation operator Â = D̃^{r-1} Ã D̃^{-r} (paper Eq. 1) is
materialized as per-edge coefficients; self-loops are explicit edges.

The port keeps its own copy of the JAX package's `repro.gnn.graph` so it
imports nothing of that package; the arithmetic is identical, so graphs,
coefficients and propagated series are array-equal between the two.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass
class Graph:
    n: int
    src: np.ndarray            # (E,) int32 — edge source (col j)
    dst: np.ndarray            # (E,) int32 — edge destination (row i)
    features: np.ndarray       # (n, f) float32
    labels: np.ndarray         # (n,) int32
    num_classes: int
    train_idx: np.ndarray      # labeled training nodes (V_l)
    unlabeled_idx: np.ndarray  # unlabeled training nodes (V_u)
    test_idx: np.ndarray       # V_test (unseen during training)
    name: str = "graph"

    # -- caches
    _indptr: Optional[np.ndarray] = None
    _neighbors: Optional[np.ndarray] = None
    _order: Optional[np.ndarray] = None

    @property
    def num_self_loops(self) -> int:
        """Count of explicitly stored self loops. The full graph carries
        one per node (`add_self_loops`), but `train_subgraph()` keeps
        only the loops of retained nodes — so this is counted, never
        assumed to equal n."""
        return int((self.src == self.dst).sum())

    @property
    def num_edges(self) -> int:
        """Undirected edge count m (each stored twice; self loops stored
        once and excluded). Counts actual self loops rather than assuming
        one per node: after `train_subgraph()` only kept nodes retain
        theirs, and the old `(E - n) // 2` undercounted by
        (n - n_train) / 2 — going negative on small splits and poisoning
        the `stationary_weights` denominator 2m + n."""
        return (len(self.src) - self.num_self_loops) // 2

    @property
    def degrees(self) -> np.ndarray:
        """Degree WITHOUT self loop (d_i in the paper). Subtracts each
        node's actual stored self loops, so nodes whose loop was dropped
        by `train_subgraph()` report 0, not -1."""
        deg = np.bincount(self.dst, minlength=self.n)
        loops = np.bincount(self.dst[self.src == self.dst],
                            minlength=self.n)
        return (deg - loops).astype(np.int64)

    def csr(self) -> Tuple[np.ndarray, np.ndarray]:
        """(indptr, neighbors) sorted by dst: in-neighbors of each node."""
        if self._indptr is None:
            self._order = np.argsort(self.dst, kind="stable")
            self._neighbors = self.src[self._order].astype(np.int32)
            counts = np.bincount(self.dst, minlength=self.n)
            self._indptr = np.concatenate(
                [[0], np.cumsum(counts)]).astype(np.int64)
        return self._indptr, self._neighbors

    def train_subgraph(self) -> "Graph":
        """G_train: induced on V_train (paper §2.1 inductive setting)."""
        keep = np.zeros(self.n, bool)
        train_all = np.concatenate([self.train_idx, self.unlabeled_idx])
        keep[train_all] = True
        emask = keep[self.src] & keep[self.dst]
        return dataclasses.replace(
            self, src=self.src[emask], dst=self.dst[emask],
            _indptr=None, _neighbors=None, name=self.name + "-train")


def add_self_loops(src: np.ndarray, dst: np.ndarray, n: int):
    loop = np.arange(n, dtype=np.int32)
    return (np.concatenate([src.astype(np.int32), loop]),
            np.concatenate([dst.astype(np.int32), loop]))


def edge_coefficients(g: Graph, r: float = 0.5) -> np.ndarray:
    """Per-edge weight of Â = D̃^{r-1} Ã D̃^{-r}:
    coef(j->i) = (d_i+1)^{r-1} (d_j+1)^{-r}."""
    dt = (g.degrees + 1).astype(np.float64)
    return (dt[g.dst] ** (r - 1.0) * dt[g.src] ** (-r)).astype(np.float32)


def stationary_weights(g: Graph, r: float = 0.5):
    """Rank-1 factors of Â^∞ (paper Eq. 7):
    X∞[i] = a[i] * (b @ X) with a[i]=(d_i+1)^r/(2m+n), b[j]=(d_j+1)^{1-r}.
    Never materializes the n×n matrix."""
    dt = (g.degrees + 1).astype(np.float64)
    denom = 2.0 * g.num_edges + g.n
    a = (dt ** r / denom).astype(np.float32)
    b = (dt ** (1.0 - r)).astype(np.float32)
    return a, b


def spmm(g: Graph, coef: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Host SpMM: out[i] = sum_j coef(j->i) x[j]. CSR segment-reduce;
    robust to isolated nodes (empty segments, e.g. after train_subgraph)."""
    indptr, nbr = g.csr()
    vals = coef[g._order, None] * x[nbr]
    out = np.zeros_like(x)
    counts = np.diff(indptr)
    nz = counts > 0
    starts = indptr[:-1][nz]
    if len(starts):
        out[nz] = np.add.reduceat(vals, starts, axis=0)
    return out.astype(x.dtype)


def propagated_series(g: Graph, x: np.ndarray, k: int, r: float = 0.5):
    """[X^(0), X^(1), ..., X^(k)] with X^(l) = Â^l X."""
    coef = edge_coefficients(g, r)
    out = [x.astype(np.float32)]
    for _ in range(k):
        out.append(spmm(g, coef, out[-1]))
    return out
