"""Shared helpers of the tests that hold the PyTorch port (`repro_torch`)
against the JAX package (`repro`): the small test geometry and the
threshold-margin rule for exit orders."""
import dataclasses

import numpy as np

# a node's exit order may legitimately differ between two implementations
# when one of its decision-step squared distances lies this close (relative)
# to the squared threshold: f32 sums over <= 512 features taken in another
# order differ by far less (~1e-6 relative)
D2_MARGIN = 1e-4
# ... and no more than this share of the nodes may fall in that margin, or
# the configuration is too close to the threshold to test anything
MAX_NEAR_SHARE = 0.05


def small_graph(load_dataset, features=64):
    """pubmed-like at scale 0.02 (seed 4), sliced to `features` columns
    (64: one FB feature block, the geometry of
    tests/test_engine_compiled.py)."""
    g = load_dataset("pubmed-like", scale=0.02, seed=4)
    return dataclasses.replace(
        g, features=np.ascontiguousarray(g.features[:, :features]))


def near_threshold(decision_distances, cfg, nai, g, nodes, batch_size):
    """Bool per request: does any decision-step d² of the node lie within
    D2_MARGIN of t_s²? Batches are formed as the engine forms them from a
    queue (consecutive chunks, deduped)."""
    nodes = np.asarray(nodes)
    near = np.zeros(len(nodes), bool)
    ts2 = nai.t_s ** 2
    for lo in range(0, len(nodes), batch_size):
        chunk = nodes[lo:lo + batch_size]
        uniq, inv = np.unique(chunk, return_inverse=True)
        d = decision_distances(cfg, nai, g, uniq)
        close = (np.abs(d ** 2 - ts2) <= D2_MARGIN * ts2).any(axis=1)
        near[lo:lo + len(chunk)] = close[inv]
    return near


def assert_orders_match(pa, oa, pb, ob, near):
    """Predictions and exit orders equal on every node outside the
    margin; the margin holds at most MAX_NEAR_SHARE of the nodes."""
    assert near.mean() <= MAX_NEAR_SHARE, (
        f"{near.sum()} of {len(near)} nodes within the threshold margin")
    keep = ~near
    np.testing.assert_array_equal(oa[keep], ob[keep])
    np.testing.assert_array_equal(pa[keep], pb[keep])


def sharded_pack_pair(g, impl, D, gather_mode, batch_size=30, seed=0,
                      t_max=2):
    """(backend, single-device pack, pack for D shards) of one sampled
    batch of `g` with the same padding geometry (the single-device pack
    pins the sharded pack's buckets), so their results compare bit for
    bit through `repro_torch.gnn.packing.shard_batch_perm`."""
    from repro_torch.gnn.backends import get_backend
    from repro_torch.gnn.nai import support_stationary_factors
    from repro_torch.gnn.packing import pack_support
    from repro_torch.gnn.sampler import sample_support
    from repro_torch.gnn.store import as_store
    be = get_backend(impl)
    rng = np.random.default_rng(seed)
    store = as_store(g)
    batch = rng.choice(g.test_idx, size=batch_size, replace=False)
    sup = sample_support(store, batch, t_max, 0.5)
    x0 = store.gather_features(sup.nodes).astype(np.float32)
    c, s = support_stationary_factors(store, sup, x0, 0.5)
    c, s = c.astype(np.float32), s.astype(np.float32)
    kw = dict(build_tiles=be.uses_tiles, build_edges=True,
              x_inf_factors=(c, s))
    sh = pack_support(sup, x0, c[:, None] * s[None, :], n_shards=D,
                      halo=gather_mode != "dense", **kw)
    base = pack_support(sup, x0, c[:, None] * s[None, :],
                        nb_bucket=sh.n_batch, s_bucket=sh.n_pad,
                        tb_bucket=sh.tiles.shape[1], **kw)
    return be, base, sh


def plant_remote_nonfinite(base, sh):
    """Copies of both packs' x0 with NaN, +Inf and -Inf planted in the
    first row of shard 1 that an edge of shard 0 reads (the same row in
    both layouts)."""
    from repro_torch.gnn.packing import CB, shard_row_perm
    D = sh.n_shards
    rows_loc = sh.n_pad // D
    src = sh.src[0][sh.coef[0] != 0]
    if sh.halo_src_shard is not None:   # frame-local -> packed global
        blk = sh.halo_src_shard[0].astype(np.int64) * (rows_loc // CB) \
            + sh.halo_src_block[0]
        src = blk[src // CB] * CB + src % CB
    remote = src[src >= rows_loc]
    assert remote.size, "shard 0 reads no row of another shard"
    row = int(remote[0])
    base_row = int(np.flatnonzero(shard_row_perm(sh.n_pad, D) == row)[0])
    x_sh, x_b = sh.x0.copy(), base.x0.copy()
    for x, r in ((x_sh, row), (x_b, base_row)):
        x[r, :3] = (np.nan, np.inf, -np.inf)
    return x_b, x_sh


def step_operands(be, p, t_max):
    """The backend's operand dict for pack `p` (with the dense x_inf)."""
    from repro_torch.gnn.backends import pack_operands
    from repro_torch.gnn.packing import step_active_blocks
    sa = step_active_blocks(p.hop_rb, t_max) if be.uses_tiles else None
    ops = pack_operands(be, p, sa)
    if be.uses_dense_x_inf:
        ops["x_inf"] = p.x_inf
    return ops
