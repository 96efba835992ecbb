"""Node-Adaptive Inference — Algorithm 1 of the paper (the port of
`repro.gnn.nai`).

Two execution paths:

* `infer_batch_host` — the faithful serving path in numpy: real frontier
  shrinking (exited nodes drop out of the supporting set, later steps
  touch fewer edges) and MAC counters for the paper's four procedures
  (stationary state, feature propagation, distance computation,
  classification). Only the per-order classifiers run in PyTorch, on the
  classifiers' device.

* `make_compiled_infer` / `infer_batch_masked` — the device path: static
  shapes, a loop over orders with per-node active masks, compute saving at
  tile granularity through the kernels' row-block predication
  (`repro_torch.gnn.backends`), on one device or over the shards of a
  mesh. PyTorch runs eagerly, so "compiled" names the path, not a jit:
  each call launches its kernels directly.

Distances in the host path are float64 norms against T_s; the device path
compares squared float32 distances against the squared threshold. Nodes
whose distance lies within rounding of T_s may exit one order apart across
the two paths (`decision_distances` finds them).
"""
from __future__ import annotations

import copy
import dataclasses
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.gnn.backends import (get_backend, mesh_devices,
                                      normalize_mesh, run_propagation)
from repro_torch.gnn.graph import Graph
from repro_torch.gnn.models import Classifiers, GNNConfig, classification_macs
from repro_torch.gnn.packing import shard_batch_perm
from repro_torch.gnn.sampler import Support, sample_support
from repro_torch.gnn.store import as_store


@dataclasses.dataclass(frozen=True)
class NAIConfig:
    t_s: float = 0.1        # smoothness threshold T_s
    t_min: int = 1          # minimum propagation order
    t_max: int = 2          # maximum propagation order (<= k)
    batch_size: int = 500   # paper evaluates with batch 500

    def __post_init__(self):
        if self.t_min < 1:
            raise ValueError(f"t_min must be >= 1, got {self.t_min}")
        if self.t_min > self.t_max:
            raise ValueError(
                f"t_min ({self.t_min}) > t_max ({self.t_max}): no "
                f"propagation order would ever classify, every "
                f"prediction would be -1")
        if self.t_s < 0:
            raise ValueError(f"t_s must be >= 0, got {self.t_s}")
        if self.batch_size < 1:
            raise ValueError(
                f"batch_size must be >= 1, got {self.batch_size}")


@dataclasses.dataclass
class NAIResult:
    predictions: np.ndarray      # (n_test,) argmax class
    orders: np.ndarray           # (n_test,) exit order per node (Table 4)
    macs: Dict[str, float]       # per-node averaged MACs by procedure
    fp_macs: float               # feature-processing MACs per node
    total_macs: float
    wall_time_s: float
    fp_time_s: float


def _subgraph_spmm(sup: Support, x: np.ndarray, active_nodes: np.ndarray
                   ) -> Tuple[np.ndarray, int]:
    """One propagation step restricted to edges whose destination is in
    `active_nodes` (bool mask over support). Returns (new_x, edges_used).
    The edges' rows are summed on torch's CPU `index_add_`, in the edge
    list's order as `np.add.at` sums them: the same bits, several times
    faster."""
    emask = active_nodes[sup.dst]
    src, dst, coef = sup.src[emask], sup.dst[emask], sup.coef[emask]
    out = x.copy()
    rows = torch.from_numpy(coef[:, None] * x[src])
    acc = torch.zeros(x.shape, dtype=rows.dtype).index_add_(
        0, torch.from_numpy(dst).long(), rows).numpy()
    out[active_nodes] = acc[active_nodes]
    return out, int(emask.sum())


def support_stationary_factors(g, sup: Support, x0: np.ndarray,
                               r: float) -> Tuple[np.ndarray, np.ndarray]:
    """Rank-1 factors (c (n_batch,), s (f,)) of the stationary state
    Â^∞ X at the batch rows (Eq. 7), float64, so x_inf = c ⊗ s. `g` is a
    `GraphStore` or a raw `Graph`."""
    store = as_store(g)
    dt = (np.asarray(store.degrees[sup.nodes]) + 1).astype(np.float64)
    denom = 2.0 * sup.sub_edges + len(sup)
    s = _weighted_row_sum(dt ** (1.0 - r), x0)
    c = (dt[:sup.n_batch] ** r) / denom
    return c, s


def _weighted_row_sum(w: np.ndarray, x: np.ndarray) -> np.ndarray:
    """``(w[:, None] * x).sum(axis=0)`` in float64, bit for bit, without
    its (S, f) float64 temporary: a support's fresh pages cost more than
    the arithmetic on them. numpy adds the rows of an axis-0 sum in
    order, so each block of rows continues the sum from the previous
    block's result, held in the buffer's first row."""
    rows = 1024
    buf = np.empty((rows + 1, x.shape[1]), np.float64)
    acc = np.zeros(x.shape[1], np.float64)
    for a in range(0, len(x), rows):
        n = min(rows, len(x) - a)
        first = int(a > 0)
        if first:
            buf[0] = acc
        np.multiply(w[a:a + n, None], x[a:a + n], out=buf[first:first + n])
        acc = buf[:first + n].sum(axis=0)
    return acc


def support_stationary_state(g, sup: Support, x0: np.ndarray,
                             r: float) -> np.ndarray:
    """Rank-1 stationary state Â^∞ X at the batch rows, float64."""
    c, s = support_stationary_factors(g, sup, x0, r)
    return c[:, None] * s[None, :]


def _needed_mask(sup: Support, active_batch: np.ndarray, remaining_hops: int
                 ) -> np.ndarray:
    """Support nodes within `remaining_hops` of any active batch node —
    the only values the next propagation step must produce."""
    S = len(sup)
    dist = np.full(S, np.iinfo(np.int32).max, np.int32)
    dist[:sup.n_batch][active_batch] = 0
    in_frontier = np.zeros(S, bool)
    in_frontier[:sup.n_batch][active_batch] = True
    for h in range(1, remaining_hops + 1):
        if not in_frontier.any():
            break
        cand = sup.src[in_frontier[sup.dst]]
        new = cand[dist[cand] > h]
        dist[new] = h
        in_frontier[:] = False
        in_frontier[new] = True
    return dist <= remaining_hops


def _classifier_device(classifiers: Classifiers) -> torch.device:
    return next(classifiers.parameters()).device


def infer_batch_host(cfg: GNNConfig, nai: NAIConfig,
                     classifiers: Classifiers, g, batch_nodes: np.ndarray):
    """Algorithm 1 for one batch over a `GraphStore` (or raw `Graph`).
    Returns (preds, orders, macs, fp_time_s, wall_s)."""
    store = as_store(g)
    dev = _classifier_device(classifiers)
    f = store.feat_dim
    t0 = time.perf_counter()
    sup = sample_support(store, batch_nodes, nai.t_max, cfg.r)
    nb = sup.n_batch
    x = store.gather_features(sup.nodes).astype(np.float32)
    macs = {"stationary": 0.0, "propagation": 0.0, "distance": 0.0,
            "classification": 0.0}

    # line 2: stationary state over the sampled subgraph (Eq. 7, rank-1)
    x_inf = support_stationary_state(g, sup, x, cfg.r)
    macs["stationary"] += len(sup) * f + nb * f

    preds = np.full(nb, -1, np.int64)
    orders = np.zeros(nb, np.int64)
    active = np.ones(nb, bool)
    fp_elapsed = 0.0

    series = [x]                                           # X^(0..l) at support
    for l in range(1, nai.t_max + 1):
        t_fp = time.perf_counter()
        needed = _needed_mask(sup, active, nai.t_max - l)
        x, edges = _subgraph_spmm(sup, series[-1], needed)
        series.append(x)
        macs["propagation"] += edges * f
        fp_elapsed += time.perf_counter() - t_fp

        if l < nai.t_min:
            continue
        exit_now = np.zeros(nb, bool)
        if l < nai.t_max:
            t_fp = time.perf_counter()
            d = np.linalg.norm(x[:nb][active] - x_inf[active], axis=1)
            macs["distance"] += active.sum() * f
            fp_elapsed += time.perf_counter() - t_fp
            idx = np.flatnonzero(active)
            exit_now[idx[d < nai.t_s]] = True
        else:
            exit_now = active.copy()
        if exit_now.any():
            feats_l = np.stack([s[:nb][exit_now] for s in series])  # (l+1,e,f)
            with torch.inference_mode():
                z = classifiers.head(l)(torch.from_numpy(feats_l).to(dev))
                preds[exit_now] = z.argmax(dim=-1).cpu().numpy()
            orders[exit_now] = l
            macs["classification"] += exit_now.sum() * classification_macs(cfg, l)
            active &= ~exit_now
        if not active.any():
            break
    wall = time.perf_counter() - t0
    macs = {k: v / nb for k, v in macs.items()}
    return preds, orders, macs, fp_elapsed, wall


def infer_all(cfg: GNNConfig, nai: NAIConfig, classifiers: Classifiers,
              g: Graph, nodes: Optional[np.ndarray] = None) -> NAIResult:
    nodes = g.test_idx if nodes is None else nodes
    preds = np.empty(len(nodes), np.int64)
    orders = np.empty(len(nodes), np.int64)
    macs_sum: Dict[str, float] = {}
    fp_time = 0.0
    wall = 0.0
    for i in range(0, len(nodes), nai.batch_size):
        b = nodes[i:i + nai.batch_size]
        p, o, m, fp, w = infer_batch_host(cfg, nai, classifiers, g, b)
        preds[i:i + len(b)] = p
        orders[i:i + len(b)] = o
        for k, v in m.items():
            macs_sum[k] = macs_sum.get(k, 0.0) + v * len(b)
        fp_time += fp
        wall += w
    n = len(nodes)
    macs = {k: v / n for k, v in macs_sum.items()}
    fp_macs = macs["propagation"] + macs["distance"]
    return NAIResult(
        predictions=preds, orders=orders, macs=macs, fp_macs=fp_macs,
        total_macs=sum(macs.values()), wall_time_s=wall, fp_time_s=fp_time)


def accuracy(result: NAIResult, g: Graph,
             nodes: Optional[np.ndarray] = None) -> float:
    nodes = g.test_idx if nodes is None else nodes
    return float((result.predictions == g.labels[nodes]).mean())


def order_distribution(result: NAIResult, k: int) -> np.ndarray:
    """Node count per exit order 1..k (paper Table 4)."""
    return np.bincount(result.orders, minlength=k + 1)[1:k + 1]


def decision_distances(cfg: GNNConfig, nai: NAIConfig, g,
                       batch_nodes: np.ndarray) -> np.ndarray:
    """(n_batch, t_max - t_min) float64: each batch node's distance to the
    stationary state at the decision steps l = t_min .. t_max-1, under full
    propagation. An active node's value equals this in every path (host
    and device), so this is what each path tests against T_s — the tool to
    find nodes whose exit order may legitimately differ by rounding."""
    store = as_store(g)
    sup = sample_support(store, batch_nodes, nai.t_max, cfg.r)
    x = store.gather_features(sup.nodes).astype(np.float32)
    x_inf = support_stationary_state(store, sup, x, cfg.r)
    everyone = np.ones(len(sup), bool)
    out = []
    for l in range(1, nai.t_max):
        x, _ = _subgraph_spmm(sup, x, everyone)
        if l >= nai.t_min:
            out.append(np.linalg.norm(x[:sup.n_batch] - x_inf, axis=1))
    return (np.stack(out, axis=1) if out
            else np.zeros((sup.n_batch, 0)))


# ------------------------------------------------------------ device path
def infer_batch_masked(cfg: GNNConfig, nai: NAIConfig, sup_src, sup_dst,
                       sup_coef, x0, x_inf, n_batch: int, *,
                       spmm_impl: str = "segment", ell=None,
                       step_active=None, x_inf_factors=None,
                       device=None, mesh=None, halo_operands=None,
                       gather_mode: str = "dense"):
    """Masked NAP over packed operands: returns (exit_order (n_batch,),
    batch-row series (T_max+1, n_batch, f)). `spmm_impl` names a
    registered backend — ``segment`` (edge list sup_src/sup_dst/sup_coef),
    ``block_ell`` (``ell=(tiles, tile_col, valid)`` + `step_active` from
    `repro_torch.gnn.packing.step_active_blocks`), or ``fused`` (the same
    plus `x_inf_factors=(c, s)`).

    `mesh` (a mesh with a ``data`` axis; operands packed with
    ``pack_support(n_shards=D)``) runs the same loop over the D shards;
    results come back in the packed shard-major batch order (undo with
    `repro_torch.gnn.packing.shard_batch_perm`). `gather_mode` picks the
    per-step frontier exchange: ``dense``, or ``halo`` / ``alltoall``,
    which need `halo_operands`, the ``halo_*`` arrays of a
    ``pack_support(halo=True)`` pack (see `repro_torch.gnn.backends`)."""
    backend = get_backend(spmm_impl)
    ops = dict(halo_operands or {})
    if backend.uses_tiles:
        if ell is None:
            raise ValueError(f"{spmm_impl} path needs ell="
                             f"(tiles, tile_col, valid)")
        ops["tiles"], ops["tile_col"], ops["valid"] = ell
        ops["step_active"] = step_active
    if backend.uses_edges:
        ops["src"], ops["dst"], ops["coef"] = sup_src, sup_dst, sup_coef
    if backend.uses_factors:
        if x_inf_factors is None:
            raise ValueError("fused path needs x_inf_factors=(c, s), the "
                             "rank-1 stationary-state factors")
        ops["c_inf"], ops["s_inf"] = x_inf_factors
    if backend.uses_dense_x_inf:
        ops["x_inf"] = x_inf
    return run_propagation(backend, nai, ops, x0, n_batch, device=device,
                           mesh=mesh, gather_mode=gather_mode)


def classify_by_order(cfg: GNNConfig, t_max: int, classifiers: Classifiers,
                      exit_order: torch.Tensor,
                      series: torch.Tensor) -> torch.Tensor:
    """Per-order classification selected by exit order: row i takes head
    f^(exit_order[i]) of its own series (``series`` (>= t_max+1, N, f),
    features beyond ``cfg.feat_dim`` are padding). Row-wise, so a caller
    may classify in row chunks."""
    preds = torch.zeros(exit_order.shape, dtype=torch.int64,
                        device=exit_order.device)
    for l in range(1, t_max + 1):
        z = classifiers.head(l)(series[:l + 1, :, :cfg.feat_dim])
        preds = torch.where(exit_order == l, z.argmax(dim=-1), preds)
    return preds


def make_compiled_infer(cfg: GNNConfig, nai: NAIConfig, *,
                        spmm_impl: str = "block_ell", device=None,
                        mesh=None, gather_mode: str = "dense",
                        return_series: bool = False):
    """Masked NAP propagation + per-order classification as one callable
    ``run(classifiers, operands, x0, x_inf) -> (predictions (nb,),
    exit_order (nb,))``, device tensors, returned without synchronising.
    `operands` is keyed as `repro_torch.gnn.backends.pack_operands` builds
    it; `x_inf` is the dense stationary state (its row count is the
    padded batch size; a zero-column placeholder for ``fused``). `device`
    defaults to ``"cuda"``.

    `return_series=True` makes it return ``(predictions, exit_order,
    series (T_max+1, nb, f))``, the batch rows' propagation history that
    the propagated-feature cache fills from (steps 1..T_max of a batch row
    are exact global values: batch rows always propagate at full
    budget).

    `mesh` (a mesh with a ``data`` axis of size D > 1; operands from
    ``pack_support(n_shards=D)``, with halo metadata unless `gather_mode`
    is ``dense``) runs the loop over the D shards (`run_propagation`);
    ``operands``, ``x0`` and ``x_inf`` may then also be the per-shard
    dicts and row blocks of `shard_operands` (the serving engine places
    them itself). Each shard classifies its own batch rows with a copy of
    the heads on its device; predictions, exit orders and the series are
    gathered on the mesh's first device and un-permuted back to the
    original batch order, so they equal single-device serving's. At D = 1
    every gather mode is the single-device path."""
    backend = get_backend(spmm_impl)
    devs = mesh_devices(mesh, device)
    mesh = normalize_mesh(mesh)
    n_shards = len(devs)
    if mesh is None:
        gather_mode = "dense"
    tmax = nai.t_max
    replicas: Dict[torch.device, Tuple[Classifiers, Classifiers]] = {}

    def heads_on(classifiers: Classifiers):
        """The heads on every shard's device: the module itself where it
        lies there, else a copy made once per device (kept while the
        engine passes the same module)."""
        own = _classifier_device(classifiers)
        out = []
        for dev in devs:
            if dev == own:
                out.append(classifiers)
                continue
            src, rep = replicas.get(dev, (None, None))
            if src is not classifiers:
                rep = copy.deepcopy(classifiers).to(dev)
                replicas[dev] = (classifiers, rep)
            out.append(rep)
        return out

    def classify(classifiers, exit_order, series):
        return classify_by_order(cfg, tmax, classifiers, exit_order, series)

    def run(classifiers, operands, x0, x_inf):
        parts = isinstance(x_inf, (list, tuple))
        nb = sum(t.shape[0] for t in x_inf) if parts else x_inf.shape[0]
        if parts:
            ops = [dict(o) for o in operands]
            if backend.uses_dense_x_inf:
                for o, xi in zip(ops, x_inf):
                    o["x_inf"] = xi
        else:
            ops = dict(operands)
            if backend.uses_dense_x_inf:
                ops["x_inf"] = x_inf
        heads = classifiers if mesh is None else heads_on(classifiers)
        out = run_propagation(
            backend, nai, ops, x0, nb, device=devs[0], mesh=mesh,
            gather_mode=gather_mode, classify=classify, classifiers=heads,
            return_series=return_series)
        exit_order, preds = out[0], out[1]
        series = out[2] if return_series else None
        if n_shards > 1:
            # shard-major packed order -> original batch order
            unperm = torch.from_numpy(shard_batch_perm(nb, n_shards)).to(
                devs[0])
            exit_order, preds = exit_order[unperm], preds[unperm]
            if series is not None:
                series = series[:, unperm]
        return (preds, exit_order) + ((series,) if return_series else ())

    return run
