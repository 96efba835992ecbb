"""Host stages of the PyTorch port against the JAX package: datasets,
graph utilities, the store, the sampler and the packer are numpy in both
packages and must give ARRAY-EQUAL results on the same seeded inputs."""
import numpy as np
import pytest
import torch

import repro.gnn.graph as jgraph
from repro.gnn.datasets import PRESETS as J_PRESETS
from repro.gnn.datasets import load_dataset as j_load
from repro.gnn.nai import support_stationary_factors as j_factors
from repro.gnn.packing import batch_bucket as j_batch_bucket
from repro.gnn.packing import next_bucket as j_next_bucket
from repro.gnn.packing import pack_support as j_pack
from repro.gnn.packing import step_active_blocks as j_step_active
from repro.gnn.sampler import sample_support as j_sample
from repro.gnn.store import as_store as j_as_store

import repro_torch.gnn.graph as tgraph
from repro_torch.gnn.datasets import PRESETS as T_PRESETS
from repro_torch.gnn.datasets import load_dataset as t_load
from repro_torch.gnn.nai import support_stationary_factors as t_factors
from repro_torch.gnn.packing import batch_bucket as t_batch_bucket
from repro_torch.gnn.packing import next_bucket as t_next_bucket
from repro_torch.gnn.packing import pack_support as t_pack
from repro_torch.gnn.packing import step_active_blocks as t_step_active
from repro_torch.gnn.sampler import sample_support as t_sample
from repro_torch.gnn.store import as_store as t_as_store

torch.set_num_threads(1)

_GRAPH_ARRAYS = ("src", "dst", "features", "labels", "train_idx",
                 "unlabeled_idx", "test_idx")


def _graphs(scale=0.02, seed=4, hard=False):
    return (j_load("pubmed-like", scale, seed, hard=hard),
            t_load("pubmed-like", scale, seed, hard=hard))


@pytest.mark.parametrize("name,scale,seed,hard", [
    ("pubmed-like", 0.02, 4, False), ("pubmed-like", 0.03, 1, True),
    ("flickr-like", 0.005, 7, False), ("arxiv-like", 0.002, 0, False)])
def test_datasets_array_equal(name, scale, seed, hard):
    jg = j_load(name, scale, seed, hard=hard)
    tg = t_load(name, scale, seed, hard=hard)
    assert (jg.n, jg.num_classes, jg.name) == (tg.n, tg.num_classes, tg.name)
    for k in _GRAPH_ARRAYS:
        np.testing.assert_array_equal(getattr(jg, k), getattr(tg, k), k)
    assert J_PRESETS == T_PRESETS


def test_graph_utilities_array_equal():
    jg, tg = _graphs()
    np.testing.assert_array_equal(jgraph.edge_coefficients(jg),
                                  tgraph.edge_coefficients(tg))
    for x, y in zip(jgraph.stationary_weights(jg),
                    tgraph.stationary_weights(tg)):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(jgraph.propagated_series(jg, jg.features[:, :16], 3),
                    tgraph.propagated_series(tg, tg.features[:, :16], 3)):
        np.testing.assert_array_equal(x, y)
    sub_j, sub_t = jg.train_subgraph(), tg.train_subgraph()
    np.testing.assert_array_equal(sub_j.degrees, sub_t.degrees)
    assert sub_j.num_edges == sub_t.num_edges


def test_store_views_array_equal():
    jg, tg = _graphs()
    js, ts = j_as_store(jg), t_as_store(tg)
    assert t_as_store(tg) is ts               # memoized on the graph
    for k in ("row_ptr", "col_idx", "degrees", "features", "labels"):
        np.testing.assert_array_equal(getattr(js, k), getattr(ts, k), k)
    assert (js.n, js.feat_dim, js.num_classes, js.num_edges,
            js.num_self_loops) == (ts.n, ts.feat_dim, ts.num_classes,
                                   ts.num_edges, ts.num_self_loops)
    nodes = np.asarray(tg.test_idx[:17])
    np.testing.assert_array_equal(js.gather_features(nodes),
                                  ts.gather_features(nodes))
    with pytest.raises(TypeError):
        t_as_store(np.zeros(3))


@pytest.mark.parametrize("hops,size,seed", [(1, 32, 0), (2, 32, 1),
                                            (3, 57, 2)])
def test_sample_support_array_equal(hops, size, seed):
    jg, tg = _graphs()
    batch = np.random.default_rng(seed).choice(tg.test_idx, size=size,
                                               replace=False)
    js = j_sample(j_as_store(jg), batch, hops, 0.5)
    ts = t_sample(t_as_store(tg), batch, hops, 0.5)
    for k in ("nodes", "hop", "src", "dst", "coef"):
        np.testing.assert_array_equal(getattr(js, k), getattr(ts, k), k)
    assert (js.n_batch, js.sub_edges) == (ts.n_batch, ts.sub_edges)
    with pytest.raises(TypeError):
        t_sample(tg, batch, hops, 0.5)        # store-first


def _pack_pair(tg, jg, batch, **kw):
    js = j_sample(j_as_store(jg), batch, 2, 0.5)
    ts = t_sample(t_as_store(tg), batch, 2, 0.5)
    x0 = tg.features[ts.nodes].astype(np.float32)
    c, s = t_factors(tg, ts, x0, 0.5)
    cj, sj = j_factors(jg, js, x0, 0.5)
    np.testing.assert_array_equal(c, cj)
    np.testing.assert_array_equal(s, sj)
    c32, s32 = c.astype(np.float32), s.astype(np.float32)
    x_inf = c32[:, None] * s32[None, :]
    return (j_pack(js, x0, x_inf, x_inf_factors=(c32, s32), **kw),
            t_pack(ts, x0, x_inf, x_inf_factors=(c32, s32), **kw))


_PACK_ARRAYS = ("tiles", "tile_col", "valid", "hop_rb", "x0", "x_inf",
                "src", "dst", "coef", "c_inf", "s_inf")


@pytest.mark.parametrize("kw", [{}, {"s_bucket": 1024, "tb_bucket": 6,
                                     "e_bucket": 4096, "nb_bucket": 64}])
def test_pack_support_array_equal(kw):
    jg, tg = _graphs()
    batch = np.random.default_rng(3).choice(tg.test_idx, size=37,
                                            replace=False)
    jp, tp = _pack_pair(tg, jg, batch, **kw)
    for k in _PACK_ARRAYS:
        np.testing.assert_array_equal(getattr(jp, k), getattr(tp, k), k)
    assert (jp.n_batch, jp.nb_real, jp.n_pad, jp.s_real) == \
        (tp.n_batch, tp.nb_real, tp.n_pad, tp.s_real)
    np.testing.assert_array_equal(j_step_active(jp.hop_rb, 2),
                                  t_step_active(tp.hop_rb, 2))


def test_pack_support_reuses_buffers_in_place():
    """`out=` refills a same-shape buffer set in place and gives the same
    arrays as a fresh pack; a smaller support under the first one's
    buckets reuses it."""
    _, tg = _graphs()
    rng = np.random.default_rng(5)
    store = t_as_store(tg)
    first = second = None
    for i in range(2):
        batch = rng.choice(tg.test_idx, size=32, replace=False)
        sup = t_sample(store, batch, 2, 0.5)
        x0 = tg.features[sup.nodes].astype(np.float32)
        c, s = (a.astype(np.float32) for a in t_factors(tg, sup, x0, 0.5))
        fresh = t_pack(sup, x0, np.zeros((len(batch), 0), np.float32),
                       x_inf_factors=(c, s), s_bucket=2048, tb_bucket=24,
                       e_bucket=8192)
        if i == 0:
            first = fresh
            continue
        tiles_buf = first.tiles
        second = t_pack(sup, x0, np.zeros((len(batch), 0), np.float32),
                        x_inf_factors=(c, s), s_bucket=2048, tb_bucket=24,
                        e_bucket=8192, out=first)
        assert second is first and second.reused
        assert second.tiles is tiles_buf
        for k in _PACK_ARRAYS:
            np.testing.assert_array_equal(getattr(second, k),
                                          getattr(fresh, k), k)


def test_buckets_equal():
    for x in range(0, 3000, 7):
        for m in (1, 8, 128):
            assert t_next_bucket(x, m) == j_next_bucket(x, m)
        assert t_batch_bucket(max(x, 1)) == j_batch_bucket(max(x, 1))



@pytest.mark.parametrize("active", ["all", "half", "none"])
def test_subgraph_spmm_array_equal(active):
    """The host path's propagation step sums the edges' rows on torch's
    `index_add_`; the JAX package's uses numpy's `add.at`. Same bits, for
    every support node active, half of them, and none."""
    from repro.gnn.nai import _subgraph_spmm as j_spmm
    from repro_torch.gnn.nai import _subgraph_spmm as t_spmm
    jg, tg = _graphs(scale=0.05)
    batch = np.unique(np.random.default_rng(3).choice(tg.test_idx, 48))
    j_sup = j_sample(j_as_store(jg), batch, 3, 0.5)
    t_sup = t_sample(t_as_store(tg), batch, 3, 0.5)
    n = len(t_sup)
    mask = {"all": np.ones(n, bool), "none": np.zeros(n, bool),
            "half": np.random.default_rng(5).random(n) < 0.5}[active]
    x = t_as_store(tg).gather_features(t_sup.nodes).astype(np.float32)
    for _ in range(2):
        (jx, je), (tx, te) = j_spmm(j_sup, x, mask), t_spmm(t_sup, x, mask)
        np.testing.assert_array_equal(jx, tx)
        assert je == te
        x = tx


@pytest.mark.parametrize("rows", [0, 1, 1023, 1024, 1025, 5000])
def test_weighted_row_sum_is_numpys_bit_for_bit(rows):
    """The stationary sum in blocks equals ``(w[:, None] * x).sum(axis=0)``
    exactly, across block edges (1,024 rows a block)."""
    from repro_torch.gnn.nai import _weighted_row_sum
    rng = np.random.default_rng(rows)
    x = rng.standard_normal((rows, 37)).astype(np.float32)
    w = rng.random(rows) * 3.0
    want = (w[:, None] * x).sum(axis=0)
    got = _weighted_row_sum(w, x)
    assert got.dtype == want.dtype == np.float64
    assert got.tobytes() == want.tobytes()
