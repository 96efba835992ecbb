"""The port's sharded and halo packing (`repro_torch.gnn.packing`) against
the JAX package's (`repro.gnn.packing`, which needs no mesh): for the same
`Support`, every operand — tiles, frame-local tile_col, stacked edges and
seeds, halo metadata — is array-equal for D in {2, 4}, halo on and off;
the three shard permutations and the batch bucket agree; bucket floors,
in-place reuse of the halo buffers and the validation errors behave as
the reference's. Exact comparisons: both packers run the same numpy
passes."""
import dataclasses

import numpy as np
import pytest

from repro.gnn import packing as jpk

from repro_torch.gnn import load_dataset
from repro_torch.gnn import packing as tpk
from repro_torch.gnn.nai import support_stationary_factors
from repro_torch.gnn.sampler import sample_support
from repro_torch.gnn.store import as_store

FIELDS = ("tiles", "tile_col", "valid", "hop_rb", "x0", "x_inf", "src",
          "dst", "coef", "c_inf", "s_inf", "halo_src_shard",
          "halo_src_block", "halo_count", "halo_send_block",
          "halo_frame_src", "seed_rows", "seed_vals")
SCALARS = ("n_batch", "nb_real", "n_pad", "s_real", "n_shards",
           "n_halo_pad", "halo_send_pad", "halo_rows", "halo_frac",
           "seed_pad")


@pytest.fixture(scope="module")
def graph():
    g = load_dataset("pubmed-like", scale=0.03, seed=1)
    return dataclasses.replace(
        g, features=np.ascontiguousarray(g.features[:, :64]))


def _inputs(g, batch_size, seed, t_max=2):
    rng = np.random.default_rng(seed)
    batch = rng.choice(g.test_idx, size=batch_size, replace=False)
    store = as_store(g)
    sup = sample_support(store, batch, t_max, 0.5)
    x0 = store.gather_features(sup.nodes).astype(np.float32)
    c, s = support_stationary_factors(store, sup, x0, 0.5)
    c, s = c.astype(np.float32), s.astype(np.float32)
    return sup, x0, c[:, None] * s[None, :], (c, s)


def _assert_same(a, b):
    for k in FIELDS:
        va, vb = getattr(a, k), getattr(b, k)
        assert (va is None) == (vb is None), k
        if va is not None:
            np.testing.assert_array_equal(va, vb, err_msg=k)
    for k in SCALARS:
        assert getattr(a, k) == getattr(b, k), k
    for impl in ("block_ell", "fused", "segment"):
        assert a.shape_key(impl) == b.shape_key(impl)


def _both(sup, x0, x_inf, **kw):
    return (tpk.pack_support(sup, x0, x_inf, **kw),
            jpk.pack_support(sup, x0, x_inf, **kw))


@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("halo", [False, True])
@pytest.mark.parametrize("build", ["tiles", "edges", "both"])
def test_sharded_pack_array_equal(graph, n_shards, halo, build):
    sup, x0, x_inf, factors = _inputs(graph, 37, n_shards + 10 * halo)
    a, b = _both(sup, x0, x_inf, n_shards=n_shards, halo=halo,
                 build_tiles=build != "edges", build_edges=build != "tiles",
                 x_inf_factors=factors)
    _assert_same(a, b)
    assert a.n_shards == n_shards and a.n_batch % (128 * n_shards) == 0
    if halo:
        assert a.halo_frac < 1.0 and a.n_halo_pad > 0


def test_halo_is_ignored_at_one_shard(graph):
    """``halo=True`` with one shard is the plain pack (the reference's
    semantics), not an error."""
    sup, x0, x_inf, factors = _inputs(graph, 20, 3)
    a, b = _both(sup, x0, x_inf, n_shards=1, halo=True,
                 x_inf_factors=factors)
    _assert_same(a, b)
    assert a.halo_src_shard is None and a.n_halo_pad == 0
    _assert_same(a, tpk.pack_support(sup, x0, x_inf, x_inf_factors=factors))


def test_shard_perms_and_batch_bucket_equal():
    for n_blocks, D in ((4, 2), (12, 4), (24, 3), (8, 8)):
        np.testing.assert_array_equal(tpk.shard_block_perm(n_blocks, D),
                                      jpk.shard_block_perm(n_blocks, D))
        n = n_blocks * tpk.CB
        np.testing.assert_array_equal(tpk.shard_row_perm(n, D),
                                      jpk.shard_row_perm(n, D))
        np.testing.assert_array_equal(tpk.shard_batch_perm(n, D),
                                      jpk.shard_batch_perm(n, D))
        # a permutation: every packed position once
        assert sorted(tpk.shard_row_perm(n, D)) == list(range(n))
    for nb in (1, 8, 32, 500, 513, 1000):
        for D in (1, 2, 4):
            assert tpk.batch_bucket(nb, D) == jpk.batch_bucket(nb, D)
    assert tpk.batch_bucket(500, 4) == 512
    for fn, args in ((tpk.shard_block_perm, (5, 2)),
                     (tpk.shard_row_perm, (384, 2))):
        with pytest.raises(ValueError):
            fn(*args)


def test_bucket_floors_equal(graph):
    """Explicit buckets are floors, the halo pads included (capped at the
    block counts they index); illegal floors raise in both packers."""
    sup, x0, x_inf, factors = _inputs(graph, 24, 5)
    kw = dict(n_shards=2, halo=True, x_inf_factors=factors)
    first = tpk.pack_support(sup, x0, x_inf, **kw)
    floors = dict(nb_bucket=first.n_batch * 2, s_bucket=first.n_pad * 2,
                  tb_bucket=first.tiles.shape[1] * 2,
                  e_bucket=first.src.shape[-1] * 2,
                  h_bucket=first.n_halo_pad * 2,
                  hb_bucket=first.halo_send_pad * 2)
    a, b = _both(sup, x0, x_inf, **kw, **floors)
    _assert_same(a, b)
    assert a.n_pad == floors["s_bucket"] and a.n_batch == floors["nb_bucket"]
    assert a.n_halo_pad >= first.n_halo_pad
    for bad in (dict(s_bucket=128 * 3), dict(nb_bucket=128 * 5)):
        for pack in (tpk.pack_support, jpk.pack_support):
            with pytest.raises(ValueError):
                pack(sup, x0, x_inf, n_shards=2, **bad)


def test_reuse_refills_halo_buffers_in_place(graph):
    """``out=`` with matching shapes refills every buffer, the halo and
    stacked ones included, and equals a fresh pack."""
    sup, x0, x_inf, factors = _inputs(graph, 30, 7)
    kw = dict(n_shards=4, halo=True, x_inf_factors=factors)
    big = tpk.pack_support(sup, x0, x_inf, **kw)
    sup2, x02, x_inf2, f2 = _inputs(graph, 30, 8)
    floors = dict(nb_bucket=big.n_batch, s_bucket=big.n_pad,
                  tb_bucket=big.tiles.shape[1], e_bucket=big.src.shape[-1],
                  h_bucket=big.n_halo_pad, hb_bucket=big.halo_send_pad)
    kw2 = dict(kw, x_inf_factors=f2, **floors)
    fresh = tpk.pack_support(sup2, x02, x_inf2, **kw2)
    if fresh.n_pad != big.n_pad or fresh.n_halo_pad != big.n_halo_pad:
        pytest.skip("second batch outgrew the first one's buckets")
    buffers = {k: getattr(big, k) for k in FIELDS if getattr(big, k)
               is not None}
    again = tpk.pack_support(sup2, x02, x_inf2, out=big, **kw2)
    assert again is big and again.reused
    for k, buf in buffers.items():
        assert getattr(again, k) is buf, k
    _assert_same(again, fresh)
    _assert_same(again, jpk.pack_support(sup2, x02, x_inf2, **kw2))


def test_sharded_seed_pack_array_equal(graph):
    """Cache seeds (``seeds=``) stack per shard with shard-local row ids,
    as the reference's do."""
    sup, x0, x_inf, factors = _inputs(graph, 16, 9)
    rng = np.random.default_rng(9)
    hit = np.zeros(len(sup), bool)
    hit[sup.n_batch:] = rng.random(len(sup) - sup.n_batch) < 0.3
    vals = rng.standard_normal((int(hit.sum()), 2, 64)).astype(np.float32)
    for D, halo in ((2, False), (4, True)):
        a, b = _both(sup, x0, x_inf, n_shards=D, halo=halo,
                     seeds=(hit, vals), x_inf_factors=factors)
        _assert_same(a, b)
        assert a.seed_rows.shape[0] == D


def test_sharded_pack_hypothesis(graph):
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=8, deadline=None)
    @given(bs=st.integers(4, 48), seed=st.integers(0, 31),
           D=st.sampled_from([2, 4]), halo=st.booleans())
    def prop(bs, seed, D, halo):
        sup, x0, x_inf, factors = _inputs(graph, bs, seed)
        a, b = _both(sup, x0, x_inf, n_shards=D, halo=halo,
                     x_inf_factors=factors)
        _assert_same(a, b)

    prop()
