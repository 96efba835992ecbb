"""The device packer (`repro_torch.gnn.device_packing.pack_support_device`)
on CPU tensors against the host path on the same support: the device
sampler's support copied back, the store's features gathered on the host,
`support_stationary_factors` and `pack_support(build_tiles=False)`, as the
serving engine's host stage runs them. `x0`, `src`, `dst`, `coef` and
`c_inf` are array-equal; `s_inf` and `x_inf` too, since the CPU sums `s`
row after row as numpy does (on the card, within one float32 ulp:
tests/test_torch_cuda.py); `n_pad`, the edge pad and `shape_key` equal.
Two graphs, batches that fill their bucket and that do not, with and
without bucket floors, a refill of the set in place, and the feature
tables following a mutation of the store."""
import numpy as np
import pytest
import torch

from repro_torch.gnn import store as tst
from repro_torch.gnn.datasets import load_dataset
from repro_torch.gnn.device_packing import pack_support_device
from repro_torch.gnn.device_sampler import DeviceSampler
from repro_torch.gnn.nai import support_stationary_factors
from repro_torch.gnn.packing import batch_bucket, pack_support

torch.set_num_threads(1)

GRAPHS = {"pubmed-like": 0.05, "flickr-like": 0.02}
EQUAL = ("x0", "src", "dst", "coef", "c_inf", "s_inf", "x_inf")


@pytest.fixture(scope="module")
def graphs():
    return {name: load_dataset(name, scale, 3)
            for name, scale in GRAPHS.items()}


def host_pack(store, sup, r, **buckets):
    """The engine's host stage on `sup` (a host `Support`), with the
    factors packed too."""
    x0 = store.gather_features(sup.nodes).astype(np.float32, copy=False)
    c, s = support_stationary_factors(store, sup, x0, r)
    c, s = c.astype(np.float32), s.astype(np.float32)
    return pack_support(sup, x0, c[:, None] * s[None, :], build_tiles=False,
                        x_inf_factors=(c, s), **buckets)


def assert_same_pack(got, want, equal=EQUAL, ulp=()):
    for k in equal + ulp:
        a, b = getattr(got, k).cpu().numpy(), getattr(want, k)
        assert a.dtype == b.dtype and a.shape == b.shape, k
        if k in ulp:
            np.testing.assert_array_max_ulp(a, b, maxulp=1)
        else:
            np.testing.assert_array_equal(a, b, err_msg=k)
    assert (got.n_batch, got.nb_real, got.n_pad, got.s_real) == \
        (want.n_batch, want.nb_real, want.n_pad, want.s_real)
    assert got.shape_key("segment") == want.shape_key("segment")


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("size", [16, 13, 100])
@pytest.mark.parametrize("floors", [False, True])
@pytest.mark.parametrize("r", [0.5, 0.3])
def test_device_pack_equals_host_pack(graphs, name, size, floors, r):
    g = graphs[name]
    store = tst.InMemoryStore(g)
    sampler = DeviceSampler(store, r, "cpu")
    tables = sampler.feature_tables()
    rng = np.random.default_rng(size)
    batch = rng.choice(g.test_idx, size=size, replace=False)
    dsup = sampler.sample_device(batch, 2)
    sup = sampler.sample(batch, 2)
    nb_bucket = batch_bucket(len(batch))
    buckets = dict(nb_bucket=nb_bucket)
    if floors:
        # the engine's high-water marks past what this support needs
        buckets.update(s_bucket=4 * 128 * -(-len(sup) // 128),
                       e_bucket=3 * len(sup.src))
    got = pack_support_device(dsup, tables, **buckets)
    want = host_pack(store, sup, r, **buckets)
    assert not got.reused
    assert_same_pack(got, want)
    assert (len(batch) == nb_bucket) == (size == 16)

    # a second batch of the same buckets refills the first's set in place
    other = rng.choice(np.setdiff1d(np.arange(g.n), batch), size=size,
                       replace=False)
    x0 = got.x0
    again = pack_support_device(sampler.sample_device(other, 2), tables,
                                out=got, nb_bucket=want.n_batch,
                                s_bucket=want.n_pad,
                                e_bucket=want.src.shape[0])
    want = host_pack(store, sampler.sample(other, 2), r,
                     nb_bucket=want.n_batch, s_bucket=want.n_pad,
                     e_bucket=want.src.shape[0])
    if again.reused:
        assert again is got and again.x0 is x0
    assert_same_pack(again, want)


def test_feature_tables_follow_mutations(graphs):
    """Nodes appended and joined to a batch: the tables refresh by
    `mutation_clock` and `n`, and the new nodes' features reach x0."""
    g = graphs["pubmed-like"]
    store = tst.InMemoryStore(g)
    sampler = DeviceSampler(store, 0.5, "cpu")
    before = sampler.feature_tables()
    rng = np.random.default_rng(7)
    batch = rng.choice(g.test_idx, size=24, replace=False)
    feats = rng.standard_normal((3, store.feat_dim)).astype(np.float32)
    new = store.add_nodes(feats)
    store.add_edges(new, batch[:3])
    tables = sampler.feature_tables()
    assert tables is not before and len(tables.features) == store.n
    np.testing.assert_array_equal(tables.features[new].numpy(), feats)
    batch = np.concatenate([batch, new[:1]])
    got = pack_support_device(sampler.sample_device(batch, 2), tables)
    sup = sampler.sample(batch, 2)
    assert np.isin(new, sup.nodes).all()
    assert_same_pack(got, host_pack(store, sup, 0.5))
    assert sampler.feature_tables() is tables    # no mutation since
