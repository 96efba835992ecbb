"""Supporting-node sampling for inductive batches (Algorithm 1 line 3).

BFS from the batch nodes over the in-neighbor CSR up to `hops`, returning
the supporting set partitioned into hop layers plus the induced subgraph
(local ids, per-edge coefficients using GLOBAL degrees, per the paper).

The port's copy of `repro.gnn.sampler.sample_support` without the
propagated-feature cache: the same numpy passes in the same order, so a
`Support` is array-equal to the JAX package's for the same store and
batch. The sampler is store-first — it walks a `GraphStore`'s CSR views,
and a raw `Graph` is a TypeError (wrap it with `as_store`).

Per-batch cost is O(support), not O(n): the visited-set and local-id
maps are epoch-stamped scratch arrays cached on the store. Batch ids must
be duplicate-free (the serving engine dedupes per batch).
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from repro_torch.gnn.store import GraphStore


@dataclasses.dataclass
class Support:
    nodes: np.ndarray          # (S,) global ids; nodes[:n_batch] == batch
    hop: np.ndarray            # (S,) BFS layer of each supporting node
    n_batch: int
    src: np.ndarray            # (Es,) LOCAL ids
    dst: np.ndarray            # (Es,) LOCAL ids
    coef: np.ndarray           # (Es,) propagation coefficients
    sub_edges: int             # undirected edge count of the subgraph

    def __len__(self):
        return len(self.nodes)


class _SamplerScratch:
    """Epoch-stamped visited/local-id maps, cached per store.

    `seen_stamp[v] == epoch` means v was discovered during the current
    call; bumping `epoch` invalidates everything in O(1) instead of an
    O(n) memset."""

    def __init__(self, n: int):
        self.seen_stamp = np.zeros(n, np.int64)
        self.local_stamp = np.zeros(n, np.int64)
        self.local_id = np.zeros(n, np.int64)
        self.epoch = 0


def _scratch(store: GraphStore) -> _SamplerScratch:
    s = store.__dict__.get("_sampler_scratch")
    if s is None or len(s.seen_stamp) != store.n:
        s = _SamplerScratch(store.n)
        store.__dict__["_sampler_scratch"] = s
    return s


def _flat_neighbors(row_ptr: np.ndarray, col_idx: np.ndarray,
                    nodes: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Concatenated CSR neighbor lists of `nodes`, in `nodes` order.
    Returns (neighbors, counts)."""
    starts = np.asarray(row_ptr[nodes], np.int64)
    counts = np.asarray(row_ptr[nodes + 1], np.int64) - starts
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, col_idx.dtype), counts
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
    idx = np.arange(total, dtype=np.int64) + np.repeat(starts - offsets,
                                                       counts)
    return np.asarray(col_idx[idx]), counts


def _first_occurrence(a: np.ndarray) -> np.ndarray:
    """Unique values of `a` ordered by first occurrence (stable dedupe)."""
    _, first = np.unique(a, return_index=True)
    return a[np.sort(first)]


def sample_support(store, batch: np.ndarray, hops: int, r: float
                   ) -> Support:
    """Vectorized frontier expansion (numpy repeat/unique, no dicts) over
    a `GraphStore`'s CSR views."""
    if not isinstance(store, GraphStore):
        raise TypeError(
            f"sample_support is store-first: expected a GraphStore, got "
            f"{type(store).__name__} (wrap an in-RAM Graph with "
            f"repro_torch.gnn.store.as_store)")
    row_ptr, col_idx = store.csr()
    scratch = _scratch(store)
    scratch.epoch += 1
    epoch, seen = scratch.epoch, scratch.seen_stamp
    batch = np.asarray(batch, np.int64)
    seen[batch] = epoch
    node_parts: List[np.ndarray] = [batch]
    hop_parts: List[np.ndarray] = [np.zeros(len(batch), np.int32)]
    frontier = batch
    for h in range(1, hops + 1):
        if len(frontier) == 0:
            break
        neigh, _ = _flat_neighbors(row_ptr, col_idx, frontier)
        cand = neigh[seen[neigh] != epoch].astype(np.int64)
        new = _first_occurrence(cand)
        seen[new] = epoch
        node_parts.append(new)
        hop_parts.append(np.full(len(new), h, np.int32))
        frontier = new
    nodes = np.concatenate(node_parts)
    hop = np.concatenate(hop_parts)

    # induced edges (j -> i), ordered by destination's local id then CSR
    lstamp, lid = scratch.local_stamp, scratch.local_id
    lstamp[nodes] = epoch
    lid[nodes] = np.arange(len(nodes))
    neigh, counts = _flat_neighbors(row_ptr, col_idx, nodes)
    dst_all = np.repeat(np.arange(len(nodes), dtype=np.int64), counts)
    keep = lstamp[neigh] == epoch
    src = lid[neigh[keep]].astype(np.int32)
    dst = dst_all[keep].astype(np.int32)

    coef = _edge_coefs(store, nodes, src, dst, r)
    # count actual self loops (graphs whose loops were dropped, e.g. a
    # train subgraph, would undercount otherwise)
    sub_edges = (len(src) - int((src == dst).sum())) // 2
    return Support(nodes=nodes, hop=hop, n_batch=len(batch), src=src,
                   dst=dst, coef=coef, sub_edges=max(sub_edges, 0))


def _edge_coefs(store: GraphStore, nodes: np.ndarray, src: np.ndarray,
                dst: np.ndarray, r: float) -> np.ndarray:
    # GLOBAL degrees (known at store build), gathered at support rows
    dt = (np.asarray(store.degrees[nodes]) + 1).astype(np.float64)
    return (dt[dst] ** (r - 1.0) * dt[src] ** (-r)).astype(np.float32)
