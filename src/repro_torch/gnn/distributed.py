"""Full-graph propagation on the serving stack (the port of
`repro.gnn.distributed`).

`graph_as_support` views a graph as its own support: every node is a
batch node at hop 0 and the induced subgraph is the graph itself, so that
`pack_graph` turns full-graph propagation into the serving engine's
operand problem — the same packer (``n_shards=D`` for a mesh), operands
and backends serving uses. The offline full-graph job
(`repro_torch.launch.full_graph_infer`) runs on it, and
`distributed_series` propagates the whole graph with any backend over the
shards of a mesh's ``data`` axis, the path that serves batches.

`distributed_nap_distances` shows how a feature-sharded deployment would
reduce Eq. 8: per-node ||x - x_inf|| with rows over ``data`` and features
over ``model``, a partial sum of squares per block, added on one device
per row block.
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from repro_torch.gnn.backends import (get_backend, mesh_devices,
                                      normalize_mesh, pack_operands,
                                      run_propagation)
from repro_torch.gnn.nai import support_stationary_factors
from repro_torch.gnn.packing import (pack_support, shard_batch_perm,
                                     step_active_blocks)
from repro_torch.gnn.sampler import Support
from repro_torch.gnn.store import as_store


def graph_as_support(g, r: float = 0.5) -> Support:
    """The whole graph viewed as its own support: every node is a batch
    node at hop 0 and the induced subgraph is the graph itself. `g` is a
    `GraphStore` (or a raw `Graph`, wrapped): the edge list and
    coefficients come from the store's CSR views in CSR (dst-major) order,
    with degrees from the store's metadata."""
    store = as_store(g)
    n = store.n
    src, dst = store.coo()
    return Support(nodes=np.arange(n, dtype=np.int64),
                   hop=np.zeros(n, np.int32), n_batch=n,
                   src=src, dst=dst,
                   coef=store.edge_coefficients(r),
                   sub_edges=store.num_edges)


def pack_graph(g, n_shards: int = 1, r: float = 0.5,
               spmm_impl: str = "segment", *, nb_bucket=None,
               s_bucket=None, tb_bucket=None, halo: bool = False,
               stationary: bool = False):
    """(backend, PackedSupport) for full-graph propagation.

    Default (``stationary=False``, propagation only): the stationary
    operands are inert — zero rank-1 factors for the fused backend, an
    all-zero dense x_inf otherwise. ``stationary=True`` (the offline
    job) packs the real Eq. 7 stationary state of the whole graph — the
    factors `support_stationary_factors` computes, cast to f32 as the
    serving path casts them — so that the Eq. 8 exit decision runs with
    serving's arithmetic. Explicit buckets pin the padding geometry, so
    runs at different shard counts are bit-comparable. ``n_shards=D``
    packs for a mesh of D shards; ``halo=True`` adds the halo-frame
    metadata of the non-dense gather modes (a full-graph partition of a
    well-mixed graph reads most blocks, so expect a halo fraction near
    1: batch serving is where the halo pays)."""
    be = get_backend(spmm_impl)
    store = as_store(g)
    sup = graph_as_support(store, r)
    x0 = np.asarray(store.features, np.float32)
    f = x0.shape[1]
    if stationary:
        c64, s64 = support_stationary_factors(store, sup, x0, r)
        factors = ((c64.astype(np.float32), s64.astype(np.float32))
                   if be.uses_factors else None)
        x_inf = (np.zeros((sup.n_batch, 0), np.float32)
                 if be.uses_factors
                 else (c64[:, None] * s64[None, :]).astype(np.float32))
    else:
        factors = ((np.zeros(sup.n_batch, np.float32),
                    np.zeros(f, np.float32)) if be.uses_factors else None)
        x_inf = np.zeros((sup.n_batch, 0 if be.uses_factors else f),
                         np.float32)
    packed = pack_support(sup, x0, x_inf, nb_bucket=nb_bucket,
                          s_bucket=s_bucket, tb_bucket=tb_bucket,
                          build_tiles=be.uses_tiles,
                          build_edges=be.uses_edges,
                          x_inf_factors=factors, n_shards=n_shards,
                          halo=halo)
    return be, packed


def distributed_series(mesh, g, k: int, r: float = 0.5,
                       spmm_impl: str = "segment", *, device=None,
                       nb_bucket=None, s_bucket=None, tb_bucket=None,
                       gather_mode: str = "dense"):
    """[X^(0..k)] of the whole graph, computed by the backend's step over
    the shards of the mesh's ``data`` axis (1 shard, or no mesh: one
    device, `device`, default ``"cuda"``); each (n, f) tensor on the first
    device, in node order. Checkable against
    `repro_torch.gnn.graph.propagated_series`. `gather_mode` picks the
    per-step frontier exchange (`repro_torch.gnn.backends`)."""
    store = as_store(g)
    devs = mesh_devices(mesh, device)
    mesh = normalize_mesh(mesh)
    D = len(devs)
    halo = gather_mode != "dense" and D > 1
    be, packed = pack_graph(store, D, r, spmm_impl, nb_bucket=nb_bucket,
                            s_bucket=s_bucket, tb_bucket=tb_bucket,
                            halo=halo)
    # t_min > t_max keeps the threshold sentinel negative on every step,
    # so no node ever exits and the loop is pure propagation. NAIConfig
    # rejects that combination (a serving config with it would return -1
    # predictions), so this propagation-only use hands the loop the raw
    # attributes instead of a validated config.
    nai = SimpleNamespace(t_s=0.0, t_min=k + 1, t_max=k)
    sa = step_active_blocks(packed.hop_rb, k) if be.uses_tiles else None
    ops = pack_operands(be, packed, sa)
    if be.uses_dense_x_inf:
        ops["x_inf"] = packed.x_inf
    _, series = run_propagation(be, nai, ops, packed.x0, packed.n_batch,
                                device=devs[0], mesh=mesh,
                                gather_mode=gather_mode if halo
                                else "dense")
    if D > 1:
        series = series[:, torch.from_numpy(
            shard_batch_perm(packed.n_batch, D)).to(devs[0])]
    f = store.feat_dim
    return [series[ell, :store.n, :f] for ell in range(k + 1)]


def distributed_nap_distances(mesh, x, x_inf) -> torch.Tensor:
    """Per-node ||x - x_inf|| with rows split over the mesh's ``data``
    axis and features over ``model``: each (row block, feature block) on
    its device gives its partial sums of squares, the ``model`` partials
    of a row block are added on that row's first device, and the square
    roots come back in row order on the mesh's first device. Rows and
    features must divide evenly."""
    if tuple(mesh.axis_names) != ("data", "model"):
        raise ValueError(f"needs a ('data', 'model') mesh, got "
                         f"{mesh.axis_names}")
    nd, nm = mesh.shape["data"], mesh.shape["model"]
    x = torch.as_tensor(x)
    x_inf = torch.as_tensor(x_inf)
    n, f = x.shape
    if n % nd or f % nm:
        raise ValueError(f"({n}, {f}) does not split over data={nd}, "
                         f"model={nm}")
    rn, fm = n // nd, f // nm
    devs = mesh.devices
    rows = []
    for i in range(nd):
        parts = []
        for j in range(nm):
            dev = devs[i * nm + j]
            a = x[i * rn:(i + 1) * rn, j * fm:(j + 1) * fm].to(dev)
            b = x_inf[i * rn:(i + 1) * rn, j * fm:(j + 1) * fm].to(dev)
            parts.append(((a - b) ** 2).sum(dim=1))
        d2 = parts[0]
        for p in parts[1:]:
            d2 = d2 + p.to(d2.device)
        rows.append(d2.to(devs[0]))
    return torch.cat(rows).sqrt()
