"""Host helpers of the port that the JAX package's callers use, array-equal
to the JAX functions on the same seeded inputs: `order_distribution`
(`repro.gnn.nai`) and the block-ELL converter and one-step wrapper of
`kernels/spmm/ops.py` (`spmm` takes B1's plain version on CPU tensors,
f32 sums in another order than XLA's: rtol = atol = 1e-5)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.spmm as JS
from repro.gnn.nai import NAIResult as JResult
from repro.gnn.nai import order_distribution as j_order_distribution

import repro_torch.kernels.spmm as TS
from repro_torch.gnn import NAIResult, order_distribution

torch.set_num_threads(1)


@pytest.mark.parametrize("k", [1, 3, 4])
def test_order_distribution_array_equal(k):
    orders = np.random.default_rng(k).integers(1, k + 1, 97)
    kw = dict(predictions=np.zeros(97, np.int64), orders=orders, macs={},
              fp_macs=0.0, total_macs=0.0, wall_time_s=0.0, fp_time_s=0.0)
    assert [f.name for f in dataclasses.fields(JResult)] == \
        [f.name for f in dataclasses.fields(NAIResult)]
    got = order_distribution(NAIResult(**kw), k)
    np.testing.assert_array_equal(got, j_order_distribution(JResult(**kw), k))
    assert got.sum() == 97 and len(got) == k


def _edges(seed, n, deg):
    rng = np.random.default_rng(seed)
    E = n * deg
    src = np.concatenate([rng.integers(0, n, E), np.arange(n)])
    dst = np.concatenate([rng.integers(0, n, E), np.arange(n)])
    uk = np.unique(dst.astype(np.int64) * n + src)
    dst, src = (uk // n).astype(np.int32), (uk % n).astype(np.int32)
    return src, dst, rng.random(len(src)).astype(np.float32), rng


@pytest.mark.parametrize("n,deg,f", [(150, 3, 40), (300, 6, 130)])
def test_block_ell_ops_array_equal(n, deg, f):
    src, dst, coef, rng = _edges(n, n, deg)
    je, te = (JS.build_block_ell(src, dst, coef, n),
              TS.build_block_ell(src, dst, coef, n))
    for k in ("tiles", "tile_col", "valid"):
        np.testing.assert_array_equal(getattr(te, k), getattr(je, k), k)
    assert (te.n, te.n_pad, te.density) == (je.n, je.n_pad, je.density)
    x = rng.standard_normal((n, f)).astype(np.float32)
    jx, tx = JS.pad_features(x, je.n_pad), TS.pad_features(x, te.n_pad)
    np.testing.assert_array_equal(tx, jx)
    node_active = rng.random(n) < 0.3
    ja = JS.active_blocks_from_nodes(jnp.asarray(node_active), je.n_pad)
    ta = TS.active_blocks_from_nodes(torch.from_numpy(node_active), te.n_pad)
    assert ta.dtype == torch.int32
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    for active in (None, ta):
        got = TS.spmm(te, torch.from_numpy(tx), active)
        want = JS.spmm(je, jnp.asarray(jx),
                       None if active is None else jnp.asarray(ja))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
