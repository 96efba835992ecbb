"""Supporting-node sampling on the device: the serving engine's sampler on
the card.

`DeviceSampler(store, r, device)` keeps a device copy of a `GraphStore`'s
CSR and of the per-node coefficient factors, and `sample(batch, hops)`
returns the same `Support` as `repro_torch.gnn.sampler.sample_support`
(without a cache), array for array: the same frontier expansion, the
same first-occurrence order of each hop's new nodes, the same induced
edges in the same order and the same float32 coefficients bit for bit.
It shares no code with the numpy sampler, which stays the path held
array-equal to the JAX package and the one the propagated-feature cache
probes.

Each step is a handful of tensor ops over O(support) elements:

1. frontier expansion: ``row_ptr`` gathered at the frontier, the offsets
   by ``cumsum``, the neighbour slots by ``repeat_interleave``;
2. the seen filter: candidates whose ``seen`` stamp is this call's epoch
   are dropped;
3. the first-occurrence dedupe without a sort: each candidate's position
   is ``scatter_reduce``-d (``amin``) into an n-long buffer at its node,
   and a candidate is new where the buffer holds its own position; a
   boolean compaction keeps the order, so the result is the numpy
   sampler's ``_first_occurrence`` exactly;
4. the new nodes are stamped seen;
5. the induced edges: the same expansion over every support node in
   local order, kept where the source carries this call's local stamp,
   the source mapped through ``local_id``;
6. the coefficients ``a[dst] * b[src]`` in float64, cast to float32, with
   ``a = (deg + 1) ** (r - 1)`` and ``b = (deg + 1) ** -r`` computed once
   per store version by numpy on the host with the numpy sampler's own
   expression: a product and a cast are correctly rounded on both sides,
   so the result equals ``_edge_coefs`` bit for bit.

The host reads only sizes (one total per expansion, one count of new
nodes per hop, one count of kept edges, the self-loop count).
`sample_device` stops there and returns a `DeviceSupport`, the five
arrays as device tensors handed to the caller's current stream, for the
device packer (`repro_torch.gnn.device_packing`); `sample` adds one copy
of the five arrays into page-locked memory from the caching host
allocator, after which it synchronises, and returns a `Support` that owns
its memory. On a CUDA device the work runs on the sampler's own stream,
so it never queues behind propagation on the compute stream. The device
copy is refreshed whenever the store's `mutation_clock` or `n` differs
from the copy's.

`feature_tables()` keeps, under the same version key, what the device
packer reads beside the support: the store's features as float32 and two
float64 tables per node, ``w = (deg + 1) ** (1 - r)`` and ``cr = (deg +
1) ** r``, computed once per version by numpy on the host with the host
path's own expressions (`support_stationary_factors`), so that the
factors gathered from them equal the host path's bit for bit (CUDA's
``pow`` would not). They are made only on request, on the caller's
stream, and kept only when they take at most half of the device memory
free at the refresh (counting the caching allocator's unused blocks);
otherwise `feature_tables()` returns None until the next version, and
the engine packs on the host. A mutation (`add_nodes`, `add_edges`)
refreshes them at the next call.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.gnn.sampler import Support
from repro_torch.gnn.store import GraphStore


@dataclasses.dataclass
class DeviceSupport:
    """A sampled support whose arrays are device tensors: `nodes` (S,)
    int64, `hop` (S,) int32, `src` / `dst` (E,) int32 local ids and `coef`
    (E,) float32, as `Support` holds them, with the sizes the host read."""
    nodes: torch.Tensor
    hop: torch.Tensor
    src: torch.Tensor
    dst: torch.Tensor
    coef: torch.Tensor
    n_batch: int
    sub_edges: int
    graph_version: int

    def __len__(self) -> int:
        return len(self.nodes)

    @property
    def n_edges(self) -> int:
        return len(self.src)


class FeatureTables(NamedTuple):
    """Per-node tables of a store version on the device: the features as
    float32, and the stationary factors' float64 weights ``w = (deg + 1)
    ** (1 - r)`` and ``cr = (deg + 1) ** r``."""
    features: torch.Tensor
    w: torch.Tensor
    cr: torch.Tensor


class DeviceSampler:
    """The `Support` of a batch, sampled on `device` from `store`'s CSR
    with coefficient exponent `r`. Batch ids must be duplicate-free."""

    def __init__(self, store: GraphStore, r: float, device):
        if not isinstance(store, GraphStore):
            raise TypeError(
                f"DeviceSampler is store-first: expected a GraphStore, got "
                f"{type(store).__name__} (wrap an in-RAM Graph with "
                f"repro_torch.gnn.store.as_store)")
        self.store = store
        self.r = float(r)
        self.device = torch.device(device)
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)
        self._version = None     # (mutation_clock, n) of the device copy
        self._tables: Optional[FeatureTables] = None
        self._tables_version = None

    def _refresh(self) -> None:
        """Upload the CSR, the coefficient factors and fresh stamp maps
        when the store changed since the last upload."""
        store = self.store
        version = (store.mutation_clock, store.n)
        if version == self._version:
            return
        dev, r, n = self.device, self.r, store.n
        row_ptr, col_idx = store.csr()
        # copies (np.array): a mutation writes the store's arrays in place
        self.row_ptr = torch.from_numpy(np.array(row_ptr, np.int64)).to(dev)
        self.col_idx = torch.from_numpy(np.array(col_idx, np.int64)).to(dev)
        dt = (np.asarray(store.degrees) + 1).astype(np.float64)
        self.a = torch.from_numpy(dt ** (r - 1.0)).to(dev)
        self.b = torch.from_numpy(dt ** (-r)).to(dev)
        # epoch-stamped maps: `seen[v] == epoch` means v was discovered in
        # the current call, `local_stamp[v] == epoch` that v is in its
        # support at `local_id[v]`; `first` is the dedupe's scratch
        self.seen = torch.zeros(n, dtype=torch.int64, device=dev)
        self.local_stamp = torch.zeros(n, dtype=torch.int64, device=dev)
        self.local_id = torch.zeros(n, dtype=torch.int64, device=dev)
        self.first = torch.zeros(n, dtype=torch.int64, device=dev)
        self.epoch = 0
        self._version = version

    def _expand(self, nodes: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, int]:
        """The concatenated CSR neighbour lists of `nodes`, in `nodes`
        order, with the per-node counts and their total (a host read)."""
        starts = self.row_ptr[nodes]
        counts = self.row_ptr[nodes + 1] - starts
        total = int(counts.sum())
        if total == 0:
            return self.col_idx[:0], counts, 0
        offsets = torch.cumsum(counts, 0) - counts
        idx = torch.repeat_interleave(starts - offsets, counts,
                                      output_size=total)
        idx += torch.arange(total, device=self.device)
        return self.col_idx[idx], counts, total

    def _first_new(self, neigh: torch.Tensor) -> torch.Tensor:
        """The neighbours not seen in this call, each once, in the order of
        its first occurrence in `neigh`."""
        pos = torch.arange(len(neigh), device=self.device)
        fresh = self.seen[neigh] != self.epoch
        # a seen candidate's key is past every position: it never matches
        key = torch.where(fresh, pos, len(neigh))
        self.first.scatter_reduce_(0, neigh, key, "amin", include_self=False)
        return neigh[fresh & (self.first[neigh] == pos)]

    def feature_tables(self) -> Optional[FeatureTables]:
        """The store's features and stationary-factor tables on the device
        for its current version (refreshed, as the CSR is, when
        `mutation_clock` or `n` moved), or None where they would take more
        than half of a CUDA device's memory free at the refresh. Made on
        the caller's current stream, which is the stream that reads
        them."""
        store = self.store
        version = (store.mutation_clock, store.n)
        if version == self._tables_version:
            return self._tables
        self._tables = None      # the old tables count as free below
        n, f, dev = store.n, store.feat_dim, self.device
        need = n * (4 * f + 16)
        if dev.type == "cuda":
            free, _ = torch.cuda.mem_get_info(dev)
            free += (torch.cuda.memory_reserved(dev)
                     - torch.cuda.memory_allocated(dev))
            if need > free // 2:
                self._tables_version = version
                return None
        feats = torch.empty((n, f), dtype=torch.float32, device=dev)
        rows = max(1, (32 << 20) // max(4 * f, 1))
        for a in range(0, n, rows):
            ids = np.arange(a, min(n, a + rows), dtype=np.int64)
            feats[a:a + len(ids)] = torch.from_numpy(
                store.gather_features(ids).astype(np.float32, copy=False))
        # the host path's expressions (`support_stationary_factors`), per
        # node: numpy's power of the same float64 gives the same bits
        dt = (np.asarray(store.degrees) + 1).astype(np.float64)
        r = self.r
        self._tables = FeatureTables(
            features=feats, w=torch.from_numpy(dt ** (1.0 - r)).to(dev),
            cr=torch.from_numpy(dt ** r).to(dev))
        self._tables_version = version
        return self._tables

    def _sample(self, batch: np.ndarray, hops: int) -> DeviceSupport:
        """The support of `batch` up to `hops` hops as tensors made on the
        sampler's stream."""
        batch = np.asarray(batch, np.int64)
        stream = (torch.cuda.stream(self.stream) if self.stream is not None
                  else contextlib.nullcontext())
        with stream:
            self._refresh()
            graph_version = self.store.mutation_clock
            self.epoch += 1
            epoch, dev = self.epoch, self.device
            frontier = torch.from_numpy(batch).to(dev)
            self.seen[frontier] = epoch
            parts: List[torch.Tensor] = [frontier]
            for _ in range(hops):
                if len(frontier) == 0:
                    break
                neigh, _, _ = self._expand(frontier)
                frontier = self._first_new(neigh)
                self.seen[frontier] = epoch
                parts.append(frontier)
            nodes = torch.cat(parts)
            S = len(nodes)
            hop = torch.repeat_interleave(
                torch.arange(len(parts), dtype=torch.int32, device=dev),
                torch.tensor([len(p) for p in parts], device=dev),
                output_size=S)

            # induced edges (j -> i), by the destination's local id, then
            # CSR order
            self.local_stamp[nodes] = epoch
            self.local_id[nodes] = torch.arange(S, device=dev)
            neigh, counts, total = self._expand(nodes)
            kept = (self.local_stamp[neigh] == epoch).nonzero().squeeze(1)
            src_g = neigh[kept]
            dst = torch.repeat_interleave(
                torch.arange(S, device=dev), counts, output_size=total)[kept]
            src = self.local_id[src_g]
            coef = (self.a[nodes[dst]] * self.b[src_g]).to(torch.float32)
            # actual self loops (a graph whose loops were dropped would
            # undercount otherwise)
            n_loops = int((src == dst).sum())
            return DeviceSupport(
                nodes=nodes, hop=hop, src=src.to(torch.int32),
                dst=dst.to(torch.int32), coef=coef, n_batch=len(batch),
                sub_edges=max((len(kept) - n_loops) // 2, 0),
                graph_version=graph_version)

    def sample_device(self, batch: np.ndarray, hops: int) -> DeviceSupport:
        """The support of `batch` up to `hops` hops, left on the device and
        handed to the caller's current stream: it waits for the sampler's
        stream, and the tensors are marked as used by it, so that their
        memory is not handed out again under its work."""
        sup = self._sample(batch, hops)
        if self.stream is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_stream(self.stream)
            for t in (sup.nodes, sup.hop, sup.src, sup.dst, sup.coef):
                t.record_stream(cur)
        return sup

    def sample(self, batch: np.ndarray, hops: int) -> Support:
        """The `Support` of `batch` up to `hops` hops (no cache fields): the
        device support and one copy of its five arrays back."""
        sup = self._sample(batch, hops)
        stream = (torch.cuda.stream(self.stream) if self.stream is not None
                  else contextlib.nullcontext())
        with stream:
            flat = torch.cat([t.view(torch.uint8) for t in (
                sup.nodes, sup.hop, sup.src, sup.dst, sup.coef)])
            if self.stream is not None:
                host = torch.empty(flat.shape, dtype=torch.uint8,
                                   pin_memory=True)
                host.copy_(flat, non_blocking=True)
                self.stream.synchronize()
            else:
                host = flat
        buf = host.numpy()
        S, Es = len(sup), sup.n_edges
        cut = np.cumsum([0, 8 * S, 4 * S, 4 * Es, 4 * Es, 4 * Es])
        return Support(nodes=buf[cut[0]:cut[1]].view(np.int64),
                       hop=buf[cut[1]:cut[2]].view(np.int32),
                       n_batch=sup.n_batch,
                       src=buf[cut[2]:cut[3]].view(np.int32),
                       dst=buf[cut[3]:cut[4]].view(np.int32),
                       coef=buf[cut[4]:cut[5]].view(np.float32),
                       sub_edges=sup.sub_edges,
                       graph_version=sup.graph_version)
