"""Per-node propagated-feature cache with graph-delta invalidation (the
port's copy of `repro.gnn.propcache`, host-side numpy).

Caches the full propagation series ``X^(1..t_max)[v]`` per node, filled
from the batch-row series the engine already carries (those rows are
hop 0 in their own batch, so every stored step is the exact global
value).  The sampler consults the cache during frontier expansion
(`probe`), and hit rows are *seeded* into the NAP loop at their stored
values instead of being re-propagated from x0 — see
``packing.pack_support(seeds=...)`` and ``backends._masked_loop``.

Invalidation is block-granular: every cache entry records the store's
``mutation_clock`` at sample time (``gv``) plus the set of
``VERSION_BLOCK`` superblocks its value depends on (all support nodes of
the batch that produced it — a conservative superset of the true l-hop
dependency cone).  ``GraphStore.add_edges`` stamps only the endpoint
blocks, so an entry survives mutations that touch unrelated blocks and
goes stale exactly when a dependency block is stamped after ``gv``.

Thread-safety: none — the cache lives in the engine's host stage, which
is single-threaded by construction.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List

import numpy as np

from repro_torch.gnn.store import VERSION_BLOCK, GraphStore

__all__ = ["PropCache"]


class _FillEvent:
    """Shared validity record for every entry inserted by one fill.

    All rows filled from one batch share the same ``gv`` (mutation clock
    at sample time) and the same dependency-block set, so staleness is
    checked once per event per mutation-clock value and memoized.
    """

    __slots__ = ("gv", "dep_blocks", "_checked_clock", "_valid")

    def __init__(self, gv: int, dep_blocks: np.ndarray):
        self.gv = gv
        self.dep_blocks = dep_blocks  # sorted unique int64 block ids
        self._checked_clock = -1
        self._valid = True

    def valid(self, block_versions: np.ndarray, clock: int) -> bool:
        if not self._valid:
            return False
        if clock == self._checked_clock:
            return True
        # A block id past the end of `block_versions` can only belong to
        # nodes added after this fill — those rows were never sources
        # for it, and add_nodes stamps only the new blocks, so treat
        # missing blocks as unstamped.
        blocks = self.dep_blocks
        if len(blocks) and blocks[-1] >= len(block_versions):
            blocks = blocks[blocks < len(block_versions)]
        ok = bool(np.all(block_versions[blocks] <= self.gv))
        if ok:
            self._checked_clock = clock
        else:
            self._valid = False
        return ok


class PropCache:
    """LRU cache of propagated-feature series, partitioned by shard.

    Parameters
    ----------
    capacity:
        Maximum number of cached nodes (across all partitions).
    t_max:
        Propagation depth of the stored series; ``gather`` returns
        arrays of shape ``(k, t_max, f)``.
    n_shards:
        Number of shard-local partitions.  Each node belongs to
        partition ``(node // VERSION_BLOCK) % n_shards`` — the same
        CB-superblock round-robin the packer uses to assign row
        ownership, so at D>1 each partition caches (approximately) the
        rows its shard owns.  Capacity is split evenly.
    """

    def __init__(self, capacity: int, t_max: int, *, n_shards: int = 1):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        if t_max < 1:
            raise ValueError(f"t_max must be >= 1, got {t_max}")
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.capacity = int(capacity)
        self.t_max = int(t_max)
        self.n_shards = int(n_shards)
        self._cap_per = max(1, self.capacity // self.n_shards)
        # node -> (event, vals (t_max, f));  OrderedDict == LRU order
        self._parts: List[OrderedDict] = [OrderedDict() for _ in range(self.n_shards)]
        self.hits = 0
        self.misses = 0
        self.stale = 0
        self.fills = 0
        self.evictions = 0

    # ------------------------------------------------------------------
    def __len__(self) -> int:
        return sum(len(p) for p in self._parts)

    def _part_of(self, node: int) -> OrderedDict:
        return self._parts[(node // VERSION_BLOCK) % self.n_shards]

    # ------------------------------------------------------------------
    def probe(self, store: GraphStore, nodes: np.ndarray) -> np.ndarray:
        """Mark hits among ``nodes``; returns a boolean hit mask.

        Bumps LRU recency for hits, evicts entries discovered stale, and
        updates hit/miss/stale counters.  Never inserts, so a later
        ``gather`` on the hit subset cannot race an eviction.
        """
        bv = store.block_versions
        clock = store.mutation_clock
        mask = np.zeros(len(nodes), dtype=bool)
        if len(self) == 0:          # empty (e.g. fills disabled): skip
            self.misses += len(nodes)   # the per-node lookup loop
            return mask
        for i, node in enumerate(nodes):
            node = int(node)
            part = self._part_of(node)
            entry = part.get(node)
            if entry is None:
                self.misses += 1
                continue
            if not entry[0].valid(bv, clock):
                del part[node]
                self.stale += 1
                self.misses += 1
                continue
            part.move_to_end(node)
            self.hits += 1
            mask[i] = True
        return mask

    def gather(self, nodes: np.ndarray) -> np.ndarray:
        """Stack cached series for ``nodes`` -> ``(k, t_max, f)``.

        Every node must have hit in a preceding ``probe`` with no
        intervening ``fill`` or mutation (the engine's host stage
        guarantees this ordering).
        """
        if len(nodes) == 0:
            return np.zeros((0, self.t_max, 0), dtype=np.float32)
        return np.stack([self._part_of(int(n))[int(n)][1] for n in nodes])

    def fill(
        self,
        store: GraphStore,
        nodes: np.ndarray,
        series: np.ndarray,
        dep_nodes: np.ndarray,
        gv: int,
    ) -> None:
        """Insert series rows for ``nodes`` (shape ``(k, t_max, f)``).

        ``dep_nodes`` is the full support node set of the batch that
        produced the series (a conservative superset of each row's true
        dependency cone); ``gv`` is the store's mutation clock at
        *sample* time.  If the graph mutated between sampling and fill,
        the entries are inserted with the older ``gv`` and go stale on
        their first probe — sound, just wasted work.
        """
        if series.shape[:2] != (len(nodes), self.t_max):
            raise ValueError(
                f"series shape {series.shape} != ({len(nodes)}, {self.t_max}, f)"
            )
        event = _FillEvent(
            int(gv), np.unique(np.asarray(dep_nodes, dtype=np.int64) // VERSION_BLOCK)
        )
        for i, node in enumerate(nodes):
            node = int(node)
            part = self._part_of(node)
            if node in part:
                del part[node]
            # copy: `series` is a view into a reused host buffer — holding
            # it would pin the whole base array
            part[node] = (event, np.ascontiguousarray(series[i]))
            self.fills += 1
            while len(part) > self._cap_per:
                part.popitem(last=False)
                self.evictions += 1

    # ------------------------------------------------------------------
    def stats(self) -> Dict[str, float]:
        probes = self.hits + self.misses
        return {
            "size": len(self),
            "capacity": self.capacity,
            "hits": self.hits,
            "misses": self.misses,
            "stale": self.stale,
            "fills": self.fills,
            "evictions": self.evictions,
            "hit_rate": (self.hits / probes) if probes else 0.0,
        }

    def reset_stats(self) -> None:
        """Zero the counters; cached entries are kept."""
        self.hits = self.misses = self.stale = self.fills = self.evictions = 0

    def clear(self) -> None:
        for p in self._parts:
            p.clear()
