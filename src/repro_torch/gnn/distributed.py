"""The whole graph as one support (the single-device part of
`repro.gnn.distributed`).

`graph_as_support` views a graph as its own support: every node is a
batch node at hop 0 and the induced subgraph is the graph itself, so that
`pack_graph` turns full-graph propagation into the serving engine's
operand problem — the same packer, operands and backends serving uses.
The offline full-graph job (`repro_torch.launch.full_graph_infer`)
runs on it.

Sharded packing (``n_shards > 1``, ``halo=True``), `distributed_series`
and `distributed_nap_distances` are sharding: ROADMAP A7, not ported.
"""
from __future__ import annotations

import numpy as np

from repro_torch.gnn.backends import get_backend
from repro_torch.gnn.nai import support_stationary_factors
from repro_torch.gnn.packing import pack_support
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
    """(backend, PackedSupport) for full-graph propagation on one device.

    Default (``stationary=False``, propagation only): the stationary
    operands are inert — zero rank-1 factors for the fused backend, an
    all-zero dense x_inf otherwise. ``stationary=True`` (the offline
    job) packs the real Eq. 7 stationary state of the whole graph — the
    factors `support_stationary_factors` computes, cast to f32 as the
    serving path casts them — so that the Eq. 8 exit decision runs with
    serving's arithmetic. Explicit buckets pin the padding geometry.
    ``n_shards > 1`` and ``halo=True`` are sharding (ROADMAP A7) and
    raise `NotImplementedError`."""
    if n_shards != 1 or halo:
        raise NotImplementedError(
            f"sharded full-graph packing (n_shards={n_shards}, halo={halo})"
            f" is not ported yet: ROADMAP A7")
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
                          x_inf_factors=factors)
    return be, packed
