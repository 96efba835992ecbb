"""The device sampler (`repro_torch.gnn.device_sampler.DeviceSampler`) on
CPU tensors against the port's numpy sampler and the JAX package's
(`repro.gnn.sampler.sample_support`): `nodes`, `hop`, `src`, `dst` and
`coef` array-equal (dtypes included), `n_batch` and `sub_edges` equal,
over two graphs, hops 1-3, batches of 1 to 500 and two coefficient
exponents; a batch whose frontier empties before `hops`; and a store
mutated between two calls, which the sampler's device copy must follow
by `mutation_clock`. Every comparison is exact. The serving engine's
`sample_stats` and `pack_place`: a CPU engine samples and packs on the
host, and an engine given the device sampler (as a CUDA engine without
cache or mesh takes it) samples on the device and, on `segment`, packs
there too; it serves the same predictions and exit orders bit for bit,
its pools go quiet, and appended nodes reach its x0."""
import numpy as np
import pytest
import torch

from repro.gnn import store as jst
from repro.gnn.datasets import load_dataset as j_load
from repro.gnn.sampler import sample_support as j_sample

from repro_torch.gnn import GNNConfig, NAIConfig, init_classifiers
from repro_torch.gnn import store as tst
from repro_torch.gnn.datasets import load_dataset as t_load
from repro_torch.gnn.device_sampler import DeviceSampler
from repro_torch.gnn.sampler import sample_support as t_sample
from repro_torch.serving import NAIServingEngine

torch.set_num_threads(1)

GRAPHS = {"pubmed-like": 0.05, "flickr-like": 0.02}
ARRAYS = ("nodes", "hop", "src", "dst", "coef")


def _graphs(name, seed=3):
    return j_load(name, GRAPHS[name], seed), t_load(name, GRAPHS[name], seed)


@pytest.fixture(scope="module")
def graphs():
    return {name: _graphs(name) for name in GRAPHS}


def _assert_same(got, want):
    for k in ARRAYS:
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype, (k, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert (got.n_batch, got.sub_edges) == (want.n_batch, want.sub_edges)


def _check(jstore, tstore, sampler, batch, hops, r):
    got = sampler.sample(batch, hops)
    _assert_same(got, t_sample(tstore, batch, hops, r))
    _assert_same(got, j_sample(jstore, batch, hops, r))
    assert got.graph_version == tstore.mutation_clock
    return got


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("hops", [1, 2, 3])
@pytest.mark.parametrize("size", [1, 17, 128, 500])
@pytest.mark.parametrize("r", [0.5, 0.3])
def test_device_sampler_array_equal(graphs, name, hops, size, r):
    jg, tg = graphs[name]
    tstore, jstore = tst.InMemoryStore(tg), jst.InMemoryStore(jg)
    size = min(size, len(tg.test_idx))
    batch = np.random.default_rng(size + hops).choice(
        tg.test_idx, size=size, replace=False)
    sampler = DeviceSampler(tstore, r, "cpu")
    sup = _check(jstore, tstore, sampler, batch, hops, r)
    assert sup.hit is None and sup.seed_vals is None
    # a second call on the same copy (stamps of the first are stale)
    _check(jstore, tstore, sampler, batch[::-1].copy(), hops, r)


def test_device_sampler_frontier_empties(graphs):
    """Isolated nodes (a self loop each): the first hop finds nothing
    new, so the expansion stops before `hops`."""
    jg, tg = graphs["pubmed-like"]
    tstore, jstore = tst.InMemoryStore(tg), jst.InMemoryStore(jg)
    feats = np.zeros((3, tstore.feat_dim), np.float32)
    new = tstore.add_nodes(feats)
    np.testing.assert_array_equal(new, jstore.add_nodes(feats))
    sampler = DeviceSampler(tstore, 0.5, "cpu")
    sup = _check(jstore, tstore, sampler, new, 3, 0.5)
    np.testing.assert_array_equal(sup.nodes, new)
    assert (sup.hop == 0).all() and sup.sub_edges == 0
    assert len(sup.src) == 3      # the self loops
    # one isolated node beside a connected one: only the latter grows
    hub = tg.test_idx[np.argmax(tstore.degrees[tg.test_idx])]
    sup = _check(jstore, tstore, sampler, np.array([new[0], hub]), 3, 0.5)
    assert sup.hop.max() >= 2


def test_device_sampler_follows_mutations(graphs):
    """Nodes and edges appended between two calls: the copy refreshes by
    `mutation_clock` and the second call sees the new topology."""
    jg, tg = graphs["flickr-like"]
    tstore, jstore = tst.InMemoryStore(tg), jst.InMemoryStore(jg)
    rng = np.random.default_rng(11)
    batch = rng.choice(tg.test_idx, size=40, replace=False)
    sampler = DeviceSampler(tstore, 0.5, "cpu")
    before = _check(jstore, tstore, sampler, batch, 2, 0.5)
    version = sampler._version
    feats = rng.standard_normal((5, tstore.feat_dim)).astype(np.float32)
    new = tstore.add_nodes(feats)
    jstore.add_nodes(feats)
    src = np.concatenate([new, batch[:5]])
    dst = np.concatenate([batch[:5], rng.choice(tg.n, 5, replace=False)])
    tstore.add_edges(src, dst)
    jstore.add_edges(src, dst)
    after = _check(jstore, tstore, sampler, batch, 2, 0.5)
    assert sampler._version != version
    assert sampler._version == (tstore.mutation_clock, tstore.n)
    assert len(after.src) > len(before.src)
    assert np.isin(new, after.nodes).all()
    # a batch that holds the appended nodes themselves
    _check(jstore, tstore, sampler, np.concatenate([new, batch[5:9]]), 3,
           0.5)


def test_device_sampler_rejects_graph(graphs):
    with pytest.raises(TypeError):
        DeviceSampler(graphs["pubmed-like"][1], 0.5, "cpu")


def _serve(eng, nodes):
    eng.submit(nodes)
    done = []
    while eng.queue:
        done += eng.step()
    done += eng.flush()
    assert [r.status for r in done] == ["completed"] * len(nodes)
    return [r.prediction for r in done], [r.exit_order for r in done]


@pytest.mark.parametrize("impl", ["segment", "fused"])
def test_engine_with_device_sampler(graphs, impl):
    """With the device sampler a segment engine builds its operands on the
    device (`pack_place`), a fused one on the host; both serve what the
    numpy path serves, their pools go quiet over repeated passes, and a
    mutation of the store reaches the device-built x0."""
    tg = graphs["pubmed-like"][1]
    cfg = GNNConfig("sgc", tg.features.shape[1], tg.num_classes, k=2)
    nai = NAIConfig(t_s=6.0, t_min=1, t_max=2, batch_size=32)
    heads = init_classifiers(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    rng = np.random.default_rng(1)
    nodes = rng.choice(tg.test_idx, size=96, replace=False)
    feats = rng.standard_normal((4, tg.features.shape[1])).astype(np.float32)
    out = {}
    for path in ("host", "device"):
        eng = NAIServingEngine(cfg, nai, heads, tst.InMemoryStore(tg),
                               device="cpu", mode="compiled",
                               spmm_impl=impl, pipeline_depth=2,
                               max_wait_s=10.0)
        assert eng._device_sampler is None      # the CPU keeps numpy
        if path == "device":
            eng._device_sampler = DeviceSampler(eng.store, cfg.r, "cpu")
        served = [_serve(eng, nodes)]
        want = {"device": 3 if path == "device" else 0,
                "host": 0 if path == "device" else 3}
        assert eng.sample_stats == want
        on_card = path == "device" and impl == "segment"
        assert eng.pack_place == {"device": 3 * on_card,
                                  "host": 3 * (not on_card)}
        # the pools and shape keys stop growing, so a warm-up can go quiet
        served.append(_serve(eng, nodes))
        quiet = (dict(eng.pack_stats), dict(eng.jit_stats))
        served.append(_serve(eng, nodes))
        assert eng.pack_stats["allocs"] == quiet[0]["allocs"]
        assert eng.jit_stats["compiles"] == quiet[1]["compiles"]
        assert served[2] == served[1] == served[0]
        # nodes appended and joined to the batch: the device tables follow
        new = eng.store.add_nodes(feats)
        eng.store.add_edges(new, nodes[:4])
        batch = np.concatenate([nodes[:28], new])
        served.append(_serve(eng, batch))
        if on_card:
            packed = eng._device_pool[32][-1]
            rows = np.searchsorted(np.unique(batch), new)
            np.testing.assert_array_equal(
                packed.x0[rows, :feats.shape[1]].numpy(), feats)
        out[path] = served
        eng.reset_stats()
        assert eng.sample_stats == {"device": 0, "host": 0}
        assert eng.pack_place == {"device": 0, "host": 0}
    assert out["device"] == out["host"]
