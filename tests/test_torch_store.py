"""The port's graph store (`repro_torch.gnn.store`) against the JAX
package's (`repro.gnn.store`): `make_graph` array-equal under one seed, in
RAM and on disk, across a `_CHUNK_ROWS` boundary; store directories that
either package writes read array-equal in the other; `verify()` and its
typed errors; `gather_features` through ``os.preadv`` with unsorted and
duplicate ids; and one `add_edges` / `add_nodes` sequence giving
array-equal CSR, degrees, `block_versions` and `mutation_clock`, with the
`MmapStore` overlay leaving the files untouched. Host numpy stages:
every comparison is exact."""
import hashlib
import json
import os
import shutil

import numpy as np
import pytest

from repro.gnn import load_dataset as j_load
from repro.gnn import store as jst

from repro_torch.gnn import load_dataset
from repro_torch.gnn import store as tst

# crosses the generator's fixed chunk boundary (1 << 17 rows) at a size
# whose arrays stay a few MB
N_BIG = (1 << 17) + 1000
ARRAYS = ("row_ptr", "col_idx", "features", "degrees", "labels")


def _arrays_equal(a, b):
    for k in ARRAYS:
        np.testing.assert_array_equal(np.asarray(getattr(a, k)),
                                      np.asarray(getattr(b, k)), err_msg=k)
    for k in ("n", "feat_dim", "num_classes", "num_edges",
              "num_self_loops", "name"):
        assert getattr(a, k) == getattr(b, k), k


def _digests(path):
    return {f: hashlib.sha256(open(os.path.join(path, f), "rb").read())
            .hexdigest() for f in sorted(os.listdir(path))}


@pytest.fixture(scope="module")
def graphs():
    """pubmed-like at scale 0.02, seed 4, from each package."""
    return (j_load("pubmed-like", scale=0.02, seed=4),
            load_dataset("pubmed-like", scale=0.02, seed=4))


def test_constants_match_reference():
    assert tst.FORMAT == jst.FORMAT
    assert tst.VERSION_BLOCK == jst.VERSION_BLOCK == 128
    assert tst._CHUNK_ROWS == jst._CHUNK_ROWS


@pytest.mark.parametrize("where", ["ram", "disk"])
def test_make_graph_matches_reference(tmp_path, where):
    kw = dict(feat_dim=8, num_classes=5)
    if where == "disk":
        j = jst.make_graph(N_BIG, 4.0, 2.2, 11, path=str(tmp_path / "j"),
                           **kw)
        t = tst.make_graph(N_BIG, 4.0, 2.2, 11, path=str(tmp_path / "t"),
                           **kw)
        assert isinstance(t, tst.MmapStore)
        assert t.meta == j.meta
        assert t.verify() == j.verify() == list(ARRAYS)
    else:
        j = jst.make_graph(N_BIG, 4.0, 2.2, 11, **kw)
        t = tst.make_graph(N_BIG, 4.0, 2.2, 11, **kw)
        assert isinstance(t, tst.InMemoryStore)
    _arrays_equal(t, j)
    # the in-RAM and the on-disk graph of one seed are the same graph
    if where == "disk":
        _arrays_equal(t, tst.make_graph(N_BIG, 4.0, 2.2, 11, **kw))
    t.close()
    j.close()


def test_store_cli_writes_reference_graph(tmp_path):
    tst._main(["--n", "3000", "--seed", "5", "--feat-dim", "16",
               "--out", str(tmp_path / "t")])
    j = jst.make_graph(3000, seed=5, feat_dim=16, path=str(tmp_path / "j"))
    with tst.MmapStore(str(tmp_path / "t")) as t:
        _arrays_equal(t, j)
    j.close()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_store_directory_reads_in_the_other_package(tmp_path, graphs,
                                                    writer):
    jg, tg = graphs
    path = str(tmp_path / "s")
    if writer == "jax":
        jst.save_graph_store(jg, path)
        got = tst.MmapStore(path, verify=True)
        want = jst.InMemoryStore(jg)
    else:
        tst.save_graph_store(tg, path)
        got = jst.MmapStore(path, verify=True)
        want = tst.InMemoryStore(tg)
    _arrays_equal(got, want)
    ids = np.arange(0, got.n, 7)
    np.testing.assert_array_equal(got.gather_features(ids),
                                  want.gather_features(ids))
    got.close()
    # both packages write the same bytes for the same graph
    other = str(tmp_path / "o")
    (tst if writer == "jax" else jst).save_graph_store(
        tg if writer == "jax" else jg, other)
    assert _digests(path) == _digests(other)


def test_verify_catches_a_flipped_byte(tmp_path, graphs):
    _, tg = graphs
    path = tst.save_graph_store(tg, str(tmp_path / "s"))
    with tst.MmapStore(path) as st:
        assert st.verify() == list(ARRAYS)
    for name in ("features.npy", "col_idx.npy"):
        bad = str(tmp_path / f"bad_{name}")
        shutil.copytree(path, bad)
        f = os.path.join(bad, name)
        with open(f, "r+b") as fh:
            fh.seek(os.path.getsize(f) - 5)
            b = fh.read(1)
            fh.seek(-1, os.SEEK_CUR)
            fh.write(bytes([b[0] ^ 0x10]))
        with pytest.raises(tst.StoreCorruption, match="checksum"):
            tst.MmapStore(bad).verify()
        with pytest.raises(jst.StoreCorruption, match="checksum"):
            jst.MmapStore(bad).verify()
    # a file cut short fails the shape check at open time
    cut = str(tmp_path / "cut")
    shutil.copytree(path, cut)
    meta = json.load(open(os.path.join(cut, "meta.json")))
    meta["n"] += 1
    json.dump(meta, open(os.path.join(cut, "meta.json"), "w"))
    with pytest.raises(tst.StoreCorruption, match="shape"):
        tst.MmapStore(cut).row_ptr
    assert issubclass(tst.StoreCorruption, (tst.StoreError, ValueError))
    assert issubclass(tst.StoreIOError, (tst.StoreError, OSError))


@pytest.mark.parametrize("mmap", [True, False])
def test_gather_features_matches_ram(tmp_path, graphs, mmap):
    _, tg = graphs
    path = tst.save_graph_store(tg, str(tmp_path / "s"))
    rng = np.random.default_rng(0)
    ids = np.concatenate([rng.integers(0, tg.n, 300), [5, 5, 6, 7, 3, 3],
                          np.arange(40, 90), [tg.n - 1, 0]])
    ram = tst.InMemoryStore(tg)
    # a small residency budget makes the gathers drop the mapped pages
    with tst.MmapStore(path, mmap=mmap, resident_budget=1 << 12) as st:
        for part in (ids, ids[::-1], ids[:1], ids[:0]):
            got = st.gather_features(part)
            assert got.dtype == np.float32 and got.flags.c_contiguous
            np.testing.assert_array_equal(got, ram.gather_features(part))
        with jst.MmapStore(path, mmap=mmap) as jm:
            np.testing.assert_array_equal(st.gather_features(ids),
                                          jm.gather_features(ids))
    with pytest.raises(ValueError, match="closed"):
        st.gather_features(ids)
    st.close()   # idempotent


def test_short_read_raises_typed_error(tmp_path, graphs):
    _, tg = graphs
    path = tst.save_graph_store(tg, str(tmp_path / "s"))
    st = tst.MmapStore(path, io_retries=1, io_backoff_s=0.0)
    st.gather_features([0])
    os.truncate(os.path.join(path, "features.npy"),
                os.path.getsize(os.path.join(path, "features.npy")) - 64)
    with pytest.raises(tst.StoreIOError, match="short read"):
        st.gather_features([tg.n - 1])
    st.close()


def _mutate(st, feats):
    """One mutation sequence: edges among old nodes, two new nodes, an
    edge wiring one of them in, one more node that shares a block."""
    st.add_edges([5, 7, 300], [300, 200, 9])
    new = st.add_nodes(feats[:2])
    st.add_edges([int(new[0])], [0])
    new = np.concatenate([new, st.add_nodes(feats[2:], labels=[3])])
    return new


@pytest.mark.parametrize("kind", ["ram", "mmap"])
def test_mutations_match_reference(tmp_path, graphs, kind):
    jg, tg = graphs
    feats = np.random.default_rng(1).standard_normal(
        (3, tg.features.shape[1])).astype(np.float32)
    if kind == "mmap":
        path = tst.save_graph_store(tg, str(tmp_path / "s"))
        before = _digests(path)
        t, j = tst.MmapStore(path), jst.MmapStore(path)
    else:
        t, j = tst.InMemoryStore(tg), jst.InMemoryStore(jg)
        g_before = [np.array(a) for a in tg.csr()]
    assert t.mutation_clock == 0 and not t.block_versions.any()
    new_t, new_j = _mutate(t, feats), _mutate(j, feats)
    np.testing.assert_array_equal(new_t, new_j)
    _arrays_equal(t, j)
    np.testing.assert_array_equal(t.block_versions, j.block_versions)
    assert t.mutation_clock == j.mutation_clock == 4
    assert (t.n, t.num_edges, t.num_self_loops) == \
        (j.n, j.num_edges, j.num_self_loops)
    probe = np.concatenate([new_t, [0, 5, 300], new_t[::-1]])
    np.testing.assert_array_equal(t.gather_features(probe),
                                  j.gather_features(probe))
    np.testing.assert_array_equal(t.gather_features(new_t), feats)
    np.testing.assert_array_equal(t.edge_coefficients(),
                                  j.edge_coefficients())
    for a, b in zip(t.coo(), j.coo()):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="self pairs"):
        t.add_edges([3], [3])
    with pytest.raises(ValueError, match="out of range"):
        t.add_edges([0], [t.n])
    if kind == "mmap":
        # the files never change: a fresh open sees the old graph
        assert _digests(path) == before
        with tst.MmapStore(path) as fresh:
            assert fresh.n == tg.n and fresh.verify() == list(ARRAYS)
        t.close()
        j.close()
    else:
        # copy-on-write: the wrapped Graph keeps its old topology
        for a, b in zip(tg.csr(), g_before):
            np.testing.assert_array_equal(a, b)


def test_as_store_memoizes_and_rejects(graphs):
    _, tg = graphs
    assert tst.as_store(tg) is tst.as_store(tg)
    st = tst.InMemoryStore(tg)
    assert tst.as_store(st) is st
    with st as same:
        assert same is st
    with pytest.raises(TypeError):
        tst.as_store(np.zeros(3))
