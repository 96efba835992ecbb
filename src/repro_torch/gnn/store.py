"""GraphStore — the narrow storage interface behind the sampler.

The port's copy of the in-RAM half of `repro.gnn.store`: the
`GraphStore` protocol (zero-copy ``row_ptr`` / ``col_idx`` / ``features``
/ ``degrees`` views plus build-time scalars), `InMemoryStore` and
`as_store`. The sampler, packer and engine read the graph only through
this interface, so a disk-backed store can slot in later without them
noticing.

* ``row_ptr`` (n+1,) int64 / ``col_idx`` (E,) int32 — the in-neighbor
  CSR the frontier sampler walks (row i lists the sources j of edges
  j -> i; each node's self loop is stored in its row);
* ``features`` (n, f) float32 — gathered row-wise (`gather_features`);
* ``degrees`` (n,) int64 and ``num_edges`` / ``num_self_loops`` —
  computed once when the store is built.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from repro_torch.gnn.graph import Graph


class GraphStore:
    """The storage interface the sampler/packer/engine consume.

    Subclasses provide ``row_ptr`` / ``col_idx`` / ``features`` /
    ``degrees`` properties returning array views plus the build-time
    scalars. Nothing here may copy an O(n) or O(E) array: views in, row
    gathers out.
    """

    name: str = "store"
    n: int = 0
    feat_dim: int = 0
    num_classes: int = 0
    num_edges: int = 0        # undirected count m (paper's 2m+n uses it)
    num_self_loops: int = 0

    @property
    def row_ptr(self) -> np.ndarray:
        raise NotImplementedError

    @property
    def col_idx(self) -> np.ndarray:
        raise NotImplementedError

    @property
    def features(self) -> np.ndarray:
        raise NotImplementedError

    @property
    def degrees(self) -> np.ndarray:
        raise NotImplementedError

    @property
    def labels(self) -> Optional[np.ndarray]:
        return None

    def csr(self) -> Tuple[np.ndarray, np.ndarray]:
        """(row_ptr, col_idx) — the view pair the frontier sampler walks."""
        return self.row_ptr, self.col_idx

    def gather_features(self, nodes: np.ndarray) -> np.ndarray:
        """Features at `nodes`, materialized as a fresh (len(nodes), f)
        ndarray."""
        return np.asarray(self.features[nodes])

    def __len__(self) -> int:
        return self.n

    def __repr__(self) -> str:
        return (f"{type(self).__name__}(name={self.name!r}, n={self.n}, "
                f"edges={self.num_edges}, f={self.feat_dim})")


class InMemoryStore(GraphStore):
    """Zero-copy wrap of an in-RAM `Graph`: `row_ptr` / `col_idx` ARE
    `Graph.csr()`'s arrays and `features` IS `graph.features`. The
    degree/self-loop accounting runs once here instead of per batch."""

    def __init__(self, graph: Graph):
        self.graph = graph
        self.name = graph.name
        self.n = graph.n
        self.feat_dim = int(graph.features.shape[1])
        self.num_classes = graph.num_classes
        self.num_self_loops = graph.num_self_loops
        self.num_edges = graph.num_edges
        self._degrees = graph.degrees

    @property
    def row_ptr(self) -> np.ndarray:
        return self.graph.csr()[0]

    @property
    def col_idx(self) -> np.ndarray:
        return self.graph.csr()[1]

    @property
    def features(self) -> np.ndarray:
        return self.graph.features

    @property
    def degrees(self) -> np.ndarray:
        return self._degrees

    @property
    def labels(self) -> Optional[np.ndarray]:
        return self.graph.labels


def as_store(obj) -> GraphStore:
    """Normalize a `GraphStore` | `Graph` argument to a store. A raw
    `Graph` is wrapped in an `InMemoryStore` memoized on the graph
    object, so repeated calls (one per served batch) reuse the cached
    degree metadata and sampler scratch."""
    if isinstance(obj, GraphStore):
        return obj
    if isinstance(obj, Graph):
        store = obj.__dict__.get("_store_cache")
        if store is None:
            store = InMemoryStore(obj)
            obj.__dict__["_store_cache"] = store
        return store
    raise TypeError(f"expected a GraphStore or Graph, got "
                    f"{type(obj).__name__}")
