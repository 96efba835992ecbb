"""GraphStore — the narrow storage interface behind the sampler.

The port's copy of `repro.gnn.store`. The sampler, packer and engine read
the graph only through this interface (zero-copy array views plus
build-time metadata), so an in-RAM graph and a memory-mapped directory
serve alike:

* ``row_ptr`` (n+1,) int64 / ``col_idx`` (E,) int32 — the in-neighbor
  CSR the frontier sampler walks (row i lists the sources j of edges
  j -> i; each node's self loop is stored in its row);
* ``features`` (n, f) float32 — gathered row-wise (`gather_features`), so
  only the rows a batch's support touches are materialized;
* ``degrees`` (n,) int64 and ``num_edges`` / ``num_self_loops`` —
  computed once when the store is built.

Two implementations: `InMemoryStore` wraps a `Graph` (the same arrays),
and `MmapStore` opens a store directory, with the CSR views memory-mapped
and feature rows gathered by ``os.preadv`` straight into the output (the
page cache, not the process, holds the file), so host residency follows
the supports sampled, not the graph. Both take mutations (`add_edges`,
`add_nodes`) copy-on-write and stamp `block_versions`, which the
propagated-feature cache (`repro_torch.gnn.propcache`) validates against.

`make_graph(n, avg_deg, alpha, seed)` generates a power-law graph in
fixed-size chunks from one `np.random.Generator`, so the same seed gives
array-equal graphs in RAM and on disk, and equal to the JAX package's.
The module runs as a program, so a graph can be generated in a process
of its own:

    python -m repro_torch.gnn.store --n 1000000 --seed 7 --out DIR

On-disk layout (format ``repro-graphstore-v1``, shared with the JAX
package: a directory written by either reads array-equal in the other)::

    store_dir/
      meta.json       n, feat_dim, num_classes, num_edges,
                      num_self_loops, name, generator params, checksums
      row_ptr.npy     (n+1,) int64   CSR row pointers
      col_idx.npy     (E,)   int32   in-neighbor ids (self loop in-row)
      features.npy    (n, f) float32
      degrees.npy     (n,)   int64   degree WITHOUT self loop
      labels.npy      (n,)   int32   optional
"""
from __future__ import annotations

import json
import mmap as _mmap
import os
import time
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.gnn.graph import Graph

# madvise is Linux-only; elsewhere MmapStore works without the bounded
# residency (RSS then includes readahead pages)
_HAVE_MADVISE = hasattr(_mmap, "MADV_RANDOM") and hasattr(_mmap,
                                                          "MADV_DONTNEED")

FORMAT = "repro-graphstore-v1"

_ARRAYS = ("row_ptr", "col_idx", "features", "degrees", "labels")

# Granularity of mutation versioning: one version counter per
# VERSION_BLOCK consecutive node ids, equal to the SpMM kernel's CB (the
# column-block granularity of the packer), so cache invalidation is
# block-granular in the serving stack's own units.
VERSION_BLOCK = 128


class StoreError(Exception):
    """Base class of typed storage failures, so upstream layers can tell
    "the storage tier failed" from their own bugs."""


class StoreIOError(StoreError, OSError):
    """A read against the backing files failed (short read / OS error)
    and did not recover within the bounded retry budget."""


class StoreCorruption(StoreError, ValueError):
    """The bytes on disk do not match the build-time metadata (checksum
    or shape mismatch); the store must be rebuilt."""


def _file_crc32(path: str, chunk: int = 8 << 20) -> str:
    """crc32 of a whole file, read in chunks; zero-padded hex."""
    crc = 0
    with open(path, "rb") as fh:
        while True:
            buf = fh.read(chunk)
            if not buf:
                break
            crc = zlib.crc32(buf, crc)
    return f"{crc & 0xFFFFFFFF:08x}"


def _store_checksums(path: str) -> Dict[str, str]:
    """Checksums of every array file present in a store directory,
    computed at build time and kept in meta.json."""
    out = {}
    for key in _ARRAYS:
        p = os.path.join(path, f"{key}.npy")
        if os.path.exists(p):
            out[f"{key}.npy"] = _file_crc32(p)
    return out


class GraphStore:
    """The storage interface the sampler/packer/engine consume.

    Subclasses provide ``row_ptr`` / ``col_idx`` / ``features`` /
    ``degrees`` properties returning array views plus the build-time
    scalars. Nothing here may copy an O(n) or O(E) array on a read: views
    in, row gathers out.
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

    def coo(self) -> Tuple[np.ndarray, np.ndarray]:
        """(src, dst) int32 edge list in CSR order (dst-major)."""
        counts = np.diff(self.row_ptr).astype(np.int64)
        dst = np.repeat(np.arange(self.n, dtype=np.int64),
                        counts).astype(np.int32)
        return np.asarray(self.col_idx, np.int32), dst

    def edge_coefficients(self, r: float = 0.5) -> np.ndarray:
        """Per-edge Â weight in CSR order: coef(j->i) =
        (d_i+1)^{r-1} (d_j+1)^{-r}, from the persisted degrees."""
        src, dst = self.coo()
        dt = (np.asarray(self.degrees) + 1).astype(np.float64)
        return (dt[dst] ** (r - 1.0) * dt[src] ** (-r)).astype(np.float32)

    def drop_resident(self) -> int:
        """Release resident file-backed pages (no-op in RAM). Returns the
        estimated bytes released."""
        return 0

    # -- mutation (the inductive setting: the graph grows while the
    # engine serves). Copy-on-write: the first mutation materializes
    # private CSR/degree arrays (`_materialize_mutable`); every mutation
    # bumps the monotone `mutation_clock` and stamps the VERSION_BLOCK
    # `block_versions` of exactly the touched node blocks.
    @property
    def mutation_clock(self) -> int:
        """Monotone store-wide mutation counter (0 = never mutated)."""
        return self.__dict__.get("_mut_clock", 0)

    @property
    def block_versions(self) -> np.ndarray:
        """(ceil(n / VERSION_BLOCK),) int64 — the mutation_clock value at
        which each node block was last touched (0 = never). Grows with
        `add_nodes`; node ids are append-only."""
        bv = self.__dict__.get("_block_versions")
        n_blocks = max(-(-self.n // VERSION_BLOCK), 1)
        if bv is None or len(bv) < n_blocks:
            grown = np.zeros(n_blocks, np.int64)
            if bv is not None:
                grown[:len(bv)] = bv
            self.__dict__["_block_versions"] = bv = grown
        return bv

    def _stamp_blocks(self, nodes: np.ndarray) -> int:
        """Bump the clock and stamp the blocks containing `nodes`. A
        cached value depends only on rows of its fill's support, whose
        blocks the cache records, so stamping the touched endpoints'
        blocks is enough to invalidate every affected entry."""
        clock = self.mutation_clock + 1
        self.__dict__["_mut_clock"] = clock
        blocks = np.unique(np.asarray(nodes, np.int64) // VERSION_BLOCK)
        self.block_versions[blocks] = clock
        return clock

    def _mutable(self) -> Dict[str, Optional[np.ndarray]]:
        own = self.__dict__.get("_own")
        if own is None:
            own = self._materialize_mutable()
            self.__dict__["_own"] = own
        return own

    def _materialize_mutable(self) -> Dict[str, Optional[np.ndarray]]:
        raise NotImplementedError(
            f"{type(self).__name__} does not support mutation")

    def _append_features(self, feats: np.ndarray,
                         labels: np.ndarray) -> None:
        raise NotImplementedError(
            f"{type(self).__name__} does not support add_nodes")

    def add_edges(self, src, dst) -> int:
        """Add undirected edges (src[i], dst[i]): each endpoint is
        appended to the other's in-neighbor CSR row (after its existing
        entries, in call order), degrees and `num_edges` are updated, and
        the endpoints' version blocks are stamped. Self pairs are
        rejected (each row carries exactly one self loop). Returns the
        number of undirected edges added. Reads through the store see the
        new topology at once; a wrapped `Graph` and the files on disk
        keep the old one."""
        src = np.atleast_1d(np.asarray(src, np.int64))
        dst = np.atleast_1d(np.asarray(dst, np.int64))
        if src.shape != dst.shape or src.ndim != 1:
            raise ValueError(f"src/dst must be equal-length 1-D id "
                             f"arrays, got {src.shape} and {dst.shape}")
        if len(src) == 0:
            return 0
        both = np.concatenate([src, dst])
        if both.min() < 0 or both.max() >= self.n:
            raise ValueError(f"edge endpoint out of range for n={self.n}")
        if np.any(src == dst):
            raise ValueError("self pairs are not addable edges (each row "
                             "already carries exactly one self loop)")
        own = self._mutable()
        # u->v lands in row v, v->u in row u (undirected: both rows grow)
        rows = np.concatenate([dst, src])
        vals = np.concatenate([src, dst]).astype(own["col_idx"].dtype)
        pos = own["row_ptr"][rows + 1]      # end of each row, old coords
        own["col_idx"] = np.insert(own["col_idx"], pos, vals)
        counts = np.bincount(rows, minlength=self.n)
        own["row_ptr"][1:] += np.cumsum(counts)
        np.add.at(own["degrees"], rows, 1)
        self.num_edges += len(src)
        self._stamp_blocks(both)
        return len(src)

    def add_nodes(self, features, labels=None) -> np.ndarray:
        """Append new nodes, each with its self loop and no other edges
        (connect them with `add_edges`). `features` is (k, feat_dim);
        `labels` optional (k,), default -1. Returns the new node ids.
        Bumps the clock and stamps only the blocks holding no old node:
        an isolated new node changes no existing propagated value."""
        feats = np.atleast_2d(np.asarray(features, np.float32))
        k = len(feats)
        if k == 0:
            return np.empty(0, np.int64)
        if feats.shape[1] != self.feat_dim:
            raise ValueError(f"features must be (k, {self.feat_dim}), "
                             f"got {feats.shape}")
        labs = (np.full(k, -1, np.int32) if labels is None
                else np.atleast_1d(np.asarray(labels, np.int32)))
        if labs.shape != (k,):
            raise ValueError(f"labels must be ({k},), got {labs.shape}")
        own = self._mutable()
        n0 = self.n
        new_ids = np.arange(n0, n0 + k, dtype=np.int64)
        own["row_ptr"] = np.concatenate(
            [own["row_ptr"],
             own["row_ptr"][-1] + np.arange(1, k + 1, dtype=np.int64)])
        own["col_idx"] = np.concatenate(
            [own["col_idx"], new_ids.astype(own["col_idx"].dtype)])
        own["degrees"] = np.concatenate(
            [own["degrees"], np.zeros(k, own["degrees"].dtype)])
        self._append_features(feats, labs)
        self.n = n0 + k
        self.num_self_loops += k
        n_old_blocks = -(-n0 // VERSION_BLOCK)
        fresh = new_ids[new_ids // VERSION_BLOCK >= n_old_blocks]
        if len(fresh):
            self._stamp_blocks(fresh)
        else:
            self.__dict__["_mut_clock"] = self.mutation_clock + 1
        return new_ids

    # -- lifecycle: stores are context managers, so file descriptors and
    # maps are released deterministically
    def close(self) -> None:
        """Release OS resources held by the store (idempotent)."""

    def __enter__(self) -> "GraphStore":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    def __len__(self) -> int:
        return self.n

    def __repr__(self) -> str:
        return (f"{type(self).__name__}(name={self.name!r}, n={self.n}, "
                f"edges={self.num_edges}, f={self.feat_dim})")


class InMemoryStore(GraphStore):
    """Zero-copy wrap of an in-RAM `Graph`: `row_ptr` / `col_idx` ARE
    `Graph.csr()`'s arrays and `features` IS `graph.features` until the
    first mutation, which copies them. The degree/self-loop accounting
    runs once here instead of per batch."""

    def __init__(self, graph: Graph):
        self.graph = graph
        self.name = graph.name
        self.n = graph.n
        self.feat_dim = int(graph.features.shape[1])
        self.num_classes = graph.num_classes
        self.num_self_loops = graph.num_self_loops
        self.num_edges = graph.num_edges
        self._degrees = graph.degrees

    def _materialize_mutable(self):
        """First mutation: private copies of every view (the wrapped Graph
        keeps its old topology; `as_store` memoizes one store per Graph,
        so serving consumers read through here)."""
        rp, ci = self.graph.csr()
        labels = self.graph.labels
        return {"row_ptr": np.array(rp, np.int64),
                "col_idx": np.array(ci, np.int32),
                "degrees": np.array(self._degrees, np.int64),
                "features": np.array(self.graph.features, np.float32),
                "labels": (None if labels is None
                           else np.array(labels, np.int32))}

    def _append_features(self, feats, labs):
        own = self._mutable()
        own["features"] = np.concatenate([own["features"], feats])
        if own["labels"] is not None:
            own["labels"] = np.concatenate([own["labels"], labs])

    def _view(self, key: str, unmutated):
        own = self.__dict__.get("_own")
        return own[key] if own is not None else unmutated

    @property
    def row_ptr(self) -> np.ndarray:
        return self._view("row_ptr", self.graph.csr()[0])

    @property
    def col_idx(self) -> np.ndarray:
        return self._view("col_idx", self.graph.csr()[1])

    @property
    def features(self) -> np.ndarray:
        return self._view("features", self.graph.features)

    @property
    def degrees(self) -> np.ndarray:
        return self._view("degrees", self._degrees)

    @property
    def labels(self) -> Optional[np.ndarray]:
        return self._view("labels", self.graph.labels)


class MmapStore(GraphStore):
    """Graph storage memory-mapped from a store directory.

    Arrays open lazily with ``np.load(mmap_mode="r")`` and stay
    file-backed. `gather_features` reads rows with ``os.preadv`` (runs of
    consecutive ids coalesced) straight into the output array, so feature
    gathers add no mapped residency; the CSR views stay mapped
    (``MADV_RANDOM``) and their resident pages are dropped every
    ``resident_budget`` bytes of gather traffic. ``mmap=False`` loads
    everything into RAM instead. Mutations keep the CSR in RAM and
    appended nodes' feature rows in an in-RAM overlay: the files on disk
    never change, and `verify()` still checks them."""

    def __init__(self, path: str, *, mmap: bool = True,
                 resident_budget: int = 128 << 20,
                 verify: bool = False, io_retries: int = 2,
                 io_backoff_s: float = 0.005):
        self.path = os.fspath(path)
        self._mmap_mode = "r" if mmap else None
        self.resident_budget = int(resident_budget)
        self.io_retries = int(io_retries)
        self.io_backoff_s = float(io_backoff_s)
        self._touched_est = 0
        self._feat_fd = -1
        self._feat_off = 0
        self._closed = False
        meta_path = os.path.join(self.path, "meta.json")
        with open(meta_path) as fh:
            meta = json.load(fh)
        if meta.get("format") != FORMAT:
            raise ValueError(f"{meta_path}: unknown store format "
                             f"{meta.get('format')!r} (expected {FORMAT})")
        self.meta = meta
        self.name = meta.get("name", os.path.basename(self.path))
        self.n = int(meta["n"])
        self._base_n = self.n       # node count on disk (mutations overlay)
        self.feat_dim = int(meta["feat_dim"])
        self.num_classes = int(meta.get("num_classes", 0))
        self.num_edges = int(meta["num_edges"])
        self.num_self_loops = int(meta["num_self_loops"])
        self._views = {}
        if verify:
            self.verify()

    def _check_open(self) -> None:
        if self._closed:
            raise ValueError(f"MmapStore({self.path!r}) is closed")

    def verify(self, arrays: Optional[Tuple[str, ...]] = None) -> List[str]:
        """Recompute the files' checksums and compare them with meta.json.
        Raises `StoreCorruption` on the first mismatch; returns the names
        of the arrays verified (arrays without a recorded checksum are
        skipped)."""
        self._check_open()
        recorded = self.meta.get("checksums", {})
        verified = []
        for key in (arrays if arrays is not None else _ARRAYS):
            fname = f"{key}.npy"
            want = recorded.get(fname)
            p = os.path.join(self.path, fname)
            if want is None or not os.path.exists(p):
                continue
            got = _file_crc32(p)
            if got != want:
                raise StoreCorruption(
                    f"{p}: checksum mismatch (stored {want}, file {got})"
                    f" — store is corrupt, rebuild it")
            verified.append(key)
        return verified

    def _expected_shape(self, key: str) -> Optional[Tuple[int, ...]]:
        """Build-time shape of an array, from meta.json's scalars."""
        if key == "row_ptr":
            return (self._base_n + 1,)
        if key == "features":
            return (self._base_n, self.feat_dim)
        if key in ("degrees", "labels"):
            return (self._base_n,)
        if key == "col_idx":
            return (int(self._load("row_ptr")[-1]),)
        return None

    def _load(self, key: str) -> Optional[np.ndarray]:
        self._check_open()
        if key not in self._views:
            p = os.path.join(self.path, f"{key}.npy")
            if not os.path.exists(p):
                if key == "labels":
                    self._views[key] = None
                    return None
                raise FileNotFoundError(f"store {self.path} missing {p}")
            arr = np.load(p, mmap_mode=self._mmap_mode)
            self._views[key] = arr
            want = self._expected_shape(key)
            if want is not None and tuple(arr.shape) != want:
                del self._views[key]
                raise StoreCorruption(
                    f"{p}: shape {tuple(arr.shape)} does not match "
                    f"meta.json (expected {want}) — store is corrupt")
            mm = getattr(arr, "_mmap", None)
            if _HAVE_MADVISE and mm is not None:
                # random-access views: no readahead cluster per touched row
                mm.madvise(_mmap.MADV_RANDOM)
        return self._views[key]

    def _feat_file(self) -> Tuple[int, int]:
        """(fd, data offset) of features.npy for the preadv gathers."""
        self._check_open()
        if self._feat_fd < 0:
            p = os.path.join(self.path, "features.npy")
            nbytes = self._base_n * self.feat_dim * 4
            off = os.path.getsize(p) - nbytes
            if off <= 0:
                raise ValueError(f"{p}: expected {nbytes} bytes of "
                                 f"float32 data after the .npy header")
            self._feat_fd = os.open(p, os.O_RDONLY)
            self._feat_off = off
        return self._feat_fd, self._feat_off

    def _materialize_mutable(self):
        """First mutation: the CSR/degree/label views move to RAM copies;
        features stay on disk (appended rows go to an overlay)."""
        own = {"row_ptr": np.array(self._load("row_ptr"), np.int64),
               "col_idx": np.array(self._load("col_idx"), np.int32),
               "degrees": np.array(self._load("degrees"), np.int64)}
        lab = self._load("labels")
        own["labels"] = None if lab is None else np.array(lab, np.int32)
        return own

    def _append_features(self, feats, labs):
        own = self._mutable()
        extra = self.__dict__.get("_extra_feat")
        self.__dict__["_extra_feat"] = (
            feats if extra is None else np.concatenate([extra, feats]))
        if own["labels"] is not None:
            own["labels"] = np.concatenate([own["labels"], labs])

    def gather_features(self, nodes: np.ndarray) -> np.ndarray:
        nodes = np.atleast_1d(np.asarray(nodes)).astype(np.int64,
                                                        copy=False)
        if self.n > self._base_n:
            # appended nodes: base rows from disk, overlay rows from RAM,
            # reassembled in `nodes` order
            is_new = nodes >= self._base_n
            if is_new.any():
                out = np.empty((len(nodes), self.feat_dim), np.float32)
                out[is_new] = \
                    self._extra_feat[nodes[is_new] - self._base_n]
                old = ~is_new
                if old.any():
                    out[old] = self._gather_base(nodes[old])
                return out
        return self._gather_base(nodes)

    def _gather_base(self, nodes: np.ndarray) -> np.ndarray:
        if self._mmap_mode is None:
            return np.asarray(self._load("features")[nodes])
        out = np.empty((len(nodes), self.feat_dim), np.float32)
        if len(nodes) == 0:
            return out   # (the reference's memoryview cast raises here)
        row = self.feat_dim * 4
        fd, base = self._feat_file()
        flat = memoryview(out).cast("B")
        # one preadv per run of consecutive node ids
        k = len(nodes)
        bounds = np.nonzero(np.diff(nodes) != 1)[0] + 1
        edges = np.concatenate(([0], bounds, [k]))
        for b in range(len(edges) - 1):
            i, j = int(edges[b]), int(edges[b + 1])
            self._pread_full(fd, flat[i * row:j * row],
                             base + int(nodes[i]) * row, int(nodes[i]))
        self._touched_est += k * row
        if self._touched_est >= self.resident_budget:
            self.drop_resident()
        return out

    def _pread_full(self, fd: int, view, offset: int, first_row: int) -> None:
        """Fill `view` from `offset`, retrying short reads and OS errors
        with bounded exponential backoff; then a typed `StoreIOError`."""
        want, got = len(view), 0
        attempts, backoff = self.io_retries, self.io_backoff_s
        last_err: Optional[OSError] = None
        while True:
            try:
                nread = os.preadv(fd, [view[got:]], offset + got)
            except OSError as e:
                nread, last_err = 0, e
            if nread > 0:
                got += nread
            if got >= want:
                return
            if attempts <= 0:
                raise StoreIOError(
                    f"{self.path}/features.npy: short read at row "
                    f"{first_row} ({got}/{want} bytes) after "
                    f"{self.io_retries} retries") from last_err
            attempts -= 1
            time.sleep(backoff)
            backoff *= 2.0

    def drop_resident(self) -> int:
        """Drop the mapped views' resident pages (``MADV_DONTNEED``): RSS
        shrinks, and the next walk faults the pages back from the page
        cache. Returns the gathered-bytes estimate outstanding."""
        est, self._touched_est = self._touched_est, 0
        if not _HAVE_MADVISE or self._mmap_mode is None:
            return 0
        for arr in self._views.values():
            mm = getattr(arr, "_mmap", None)
            if mm is not None:
                mm.madvise(_mmap.MADV_DONTNEED)
        return est

    def close(self) -> None:
        """Close the feature fd and drop the mapped views. Idempotent; a
        later array access raises."""
        if getattr(self, "_closed", False):
            return
        self._closed = True
        fd, self._feat_fd = getattr(self, "_feat_fd", -1), -1
        if fd >= 0:
            try:
                os.close(fd)
            except OSError:
                pass
        self._views.clear()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def _view(self, key: str) -> Optional[np.ndarray]:
        own = self.__dict__.get("_own")
        return own[key] if own is not None else self._load(key)

    @property
    def row_ptr(self) -> np.ndarray:
        return self._view("row_ptr")

    @property
    def col_idx(self) -> np.ndarray:
        return self._view("col_idx")

    @property
    def features(self) -> np.ndarray:
        """The on-disk feature view; appended nodes' rows are not in it
        (`gather_features` reads them)."""
        return self._load("features")

    @property
    def degrees(self) -> np.ndarray:
        return self._view("degrees")

    @property
    def labels(self) -> Optional[np.ndarray]:
        return self._view("labels")


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


def _write_meta(path: str, meta: dict) -> None:
    meta["checksums"] = _store_checksums(path)
    with open(os.path.join(path, "meta.json"), "w") as fh:
        json.dump(meta, fh, indent=1)
        fh.write("\n")


def save_graph_store(g: Graph, path: str) -> str:
    """Persist a `Graph` as a store directory; an `MmapStore` of it reads
    array-equal to `InMemoryStore(g)`."""
    os.makedirs(path, exist_ok=True)
    row_ptr, col_idx = g.csr()
    np.save(os.path.join(path, "row_ptr.npy"),
            np.asarray(row_ptr, np.int64))
    np.save(os.path.join(path, "col_idx.npy"),
            np.asarray(col_idx, np.int32))
    np.save(os.path.join(path, "features.npy"),
            np.asarray(g.features, np.float32))
    np.save(os.path.join(path, "degrees.npy"), np.asarray(g.degrees))
    np.save(os.path.join(path, "labels.npy"), np.asarray(g.labels, np.int32))
    _write_meta(path, {"format": FORMAT, "name": g.name, "n": int(g.n),
                       "feat_dim": int(g.features.shape[1]),
                       "num_classes": int(g.num_classes),
                       "num_edges": int(g.num_edges),
                       "num_self_loops": int(g.num_self_loops)})
    return path


# ------------------------------------------------------------ generator
_CHUNK_ROWS = 1 << 17      # fixed chunk size: chunked and in-RAM
                           # generation are array-equal under one seed


def _powerlaw_degrees(rng: np.random.Generator, n: int, avg_deg: float,
                      alpha: float, max_deg: int) -> np.ndarray:
    """In-degree sequence: Pareto(alpha - 1) tail rescaled to `avg_deg` in
    expectation, clipped to [1, max_deg]."""
    w = rng.pareto(max(alpha - 1.0, 0.05), n) + 1.0
    deg = np.maximum(np.rint(w * (avg_deg / w.mean())), 1.0)
    return np.minimum(deg, max_deg).astype(np.int64)


def make_graph(n: int, avg_deg: float = 16.0, alpha: float = 2.2,
               seed: int = 0, *, path: Optional[str] = None,
               feat_dim: int = 64, num_classes: int = 16,
               max_deg: Optional[int] = None,
               name: Optional[str] = None) -> GraphStore:
    """Synthetic power-law graph, deterministic under `seed` (one
    `np.random.Generator`, fixed chunk boundaries).

    In-degrees follow a clipped Pareto tail of exponent `alpha` (capped at
    `max_deg`, default ``32 * avg_deg``); neighbor ids are uniform, each
    row carries its self loop stored last, and features are class
    prototypes plus noise. ``path=None`` builds in RAM and returns an
    `InMemoryStore`; with ``path`` every O(n)/O(E) array streams to
    ``.npy`` in fixed-size chunks (peak memory O(n) int64 scratch plus
    one chunk) and the result is the `MmapStore` of that directory."""
    if n < 2:
        raise ValueError(f"need n >= 2 nodes, got {n}")
    if seed is None:
        raise ValueError("make_graph requires an explicit integer seed")
    rng = np.random.default_rng(seed)
    max_deg = int(max_deg if max_deg is not None
                  else max(64, 32 * avg_deg))
    max_deg = min(max_deg, n - 1)
    deg = _powerlaw_degrees(rng, n, avg_deg, alpha, max_deg)
    counts = deg + 1                        # + the self loop, stored last
    row_ptr = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=row_ptr[1:])
    total = int(row_ptr[-1])

    if path is not None:
        os.makedirs(path, exist_ok=True)

        def _open(key, shape, dtype):
            return np.lib.format.open_memmap(
                os.path.join(path, f"{key}.npy"), mode="w+",
                dtype=dtype, shape=shape)
    else:
        def _open(key, shape, dtype):
            return np.zeros(shape, dtype)

    col_idx = _open("col_idx", (total,), np.int32)
    # neighbors by node range: uniform sources from [0, n-1) shifted past
    # the row's own id (exactly one self loop per row, stored last),
    # duplicates allowed
    for lo in range(0, n, _CHUNK_ROWS):
        hi = min(lo + _CHUNK_ROWS, n)
        k = int(row_ptr[hi] - row_ptr[lo])
        rows = np.repeat(np.arange(lo, hi, dtype=np.int64),
                         counts[lo:hi])
        span = rng.integers(0, n - 1, size=k, dtype=np.int64)
        span += span >= rows
        ends = (row_ptr[lo + 1:hi + 1] - row_ptr[lo] - 1).astype(np.int64)
        span[ends] = np.arange(lo, hi, dtype=np.int64)
        col_idx[int(row_ptr[lo]):int(row_ptr[hi])] = \
            span.astype(np.int32)

    labels = _open("labels", (n,), np.int32)
    protos = rng.standard_normal((num_classes, feat_dim)).astype(np.float32)
    features = _open("features", (n, feat_dim), np.float32)
    for lo in range(0, n, _CHUNK_ROWS):
        hi = min(lo + _CHUNK_ROWS, n)
        lab = rng.integers(0, num_classes, size=hi - lo).astype(np.int32)
        labels[lo:hi] = lab
        noise = rng.standard_normal((hi - lo, feat_dim)).astype(np.float32)
        features[lo:hi] = protos[lab] + 1.5 * noise

    degrees = _open("degrees", (n,), np.int64)
    degrees[:] = deg
    name = name or f"powerlaw-n{n}-d{avg_deg:g}-a{alpha:g}-s{seed}"
    num_edges = (total - n) // 2   # undirected m: (stored - loops) // 2

    if path is None:
        src = np.asarray(col_idx, np.int32)
        dst = np.repeat(np.arange(n, dtype=np.int64),
                        counts).astype(np.int32)
        g = Graph(n=n, src=src, dst=dst, features=features, labels=labels,
                  num_classes=num_classes,
                  train_idx=np.empty(0, np.int32),
                  unlabeled_idx=np.empty(0, np.int32),
                  test_idx=np.arange(n, dtype=np.int32), name=name)
        return as_store(g)

    np.save(os.path.join(path, "row_ptr.npy"), row_ptr)
    for arr in (col_idx, labels, features, degrees):
        arr.flush()
    del col_idx, labels, features, degrees
    _write_meta(path, {"format": FORMAT, "name": name, "n": int(n),
                       "feat_dim": int(feat_dim),
                       "num_classes": int(num_classes),
                       "num_edges": int(num_edges), "num_self_loops": int(n),
                       "generator": {"avg_deg": float(avg_deg),
                                     "alpha": float(alpha),
                                     "seed": int(seed),
                                     "max_deg": int(max_deg)}})
    return MmapStore(path)


def _main(argv=None) -> None:
    import argparse
    ap = argparse.ArgumentParser(
        description="Generate a power-law graph store on disk (in a "
                    "process of its own, so that a serving process's peak "
                    "RSS measures serving alone).")
    ap.add_argument("--n", type=int, required=True)
    ap.add_argument("--avg-deg", type=float, default=16.0)
    ap.add_argument("--alpha", type=float, default=2.2)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--feat-dim", type=int, default=64)
    ap.add_argument("--num-classes", type=int, default=16)
    ap.add_argument("--max-deg", type=int, default=None)
    ap.add_argument("--out", required=True, help="store directory")
    args = ap.parse_args(argv)
    store = make_graph(args.n, args.avg_deg, args.alpha, args.seed,
                       path=args.out, feat_dim=args.feat_dim,
                       num_classes=args.num_classes, max_deg=args.max_deg)
    print(f"wrote {store!r} -> {args.out}")


if __name__ == "__main__":
    _main()
