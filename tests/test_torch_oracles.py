"""The port's independent oracles of kernels B1 and B5 against the JAX
package's: `ref_spmm_dense` (a dense Â built from the edge list, not from
the packed tiles) and `ref_wkv6_sequential` (the per-step recurrence in
f64, not the chunked factorization). The port's packed-tile and chunked
plain versions are then held against them, so that a fault shared by a
kernel and its plain version still shows.

Tolerances: the port's oracles against the JAX package's 1e-6 (the dense
product in f64 against XLA's f32, the recurrence f64 in both); the chunked
`ref_wkv6` against the recurrence 2e-4, the JAX package's own kernel test
tolerance; the packed-tile SpMM against the dense one 1e-5 (f32 sums
against f64)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.spmm import build_block_ell as j_build_block_ell
from repro.kernels.spmm import pad_features as j_pad_features
from repro.kernels.spmm import ref_spmm_dense as j_ref_spmm_dense
from repro.kernels.wkv6 import ref_wkv6_sequential as j_ref_wkv6_sequential

from repro_torch.kernels.spmm import (RB, build_block_ell, pad_features,
                                      ref_spmm_block_ell, ref_spmm_dense)
from repro_torch.kernels.wkv6 import CHUNK, ref_wkv6, ref_wkv6_sequential

torch.set_num_threads(1)

WKV_SHAPES = [(32, 16, 2), (40, 16, 3), (64, 32, 1)]      # (T, hd, H)
SPMM_CASES = [(0, 192, 5, 200, 1.0), (1, 300, 3, 130, 0.5),
              (2, 64, 8, 64, 0.0)]                 # seed, n, deg, F, active


def _wkv_operands(seed, T, hd, H, B=2):
    """Flat (B * H, T, hd) operands as the JAX kernel test draws them."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B * H, T, hd)).astype(np.float32)
               for _ in range(3))
    logw = np.maximum(-np.exp(rng.standard_normal((B * H, T, hd)) * 0.5),
                      -5.0).astype(np.float32)
    u = np.tile((rng.standard_normal((H, hd)) * 0.1).astype(np.float32),
                (B, 1))
    return r, k, v, logw, u


@pytest.mark.parametrize("T,hd,H", WKV_SHAPES)
def test_wkv6_sequential_matches_jax(T, hd, H):
    ops = _wkv_operands(0, T, hd, H)
    got = ref_wkv6_sequential(*map(torch.from_numpy, ops))
    assert got.dtype == torch.float32 and got.shape == ops[0].shape
    np.testing.assert_allclose(got.numpy(), j_ref_wkv6_sequential(*ops),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("T,hd,H", WKV_SHAPES)
def test_wkv6_chunked_matches_sequential(T, hd, H):
    """`ref_wkv6` needs T % CHUNK == 0: the steps past T (zero k, v and
    log-decay) leave the first T outputs as they are."""
    r, k, v, logw, u = map(torch.from_numpy, _wkv_operands(1, T, hd, H))
    pad = (0, 0, 0, -T % CHUNK)
    out, _ = ref_wkv6(*(torch.nn.functional.pad(a, pad)
                        for a in (r, k, v, logw)), u)
    want = ref_wkv6_sequential(r, k, v, logw, u)
    np.testing.assert_allclose(out[:, :T].numpy(), want.numpy(),
                               rtol=2e-4, atol=2e-4)


def _graph(seed, n, deg):
    rng = np.random.default_rng(seed)
    E = n * deg
    src = np.concatenate([rng.integers(0, n, E),
                          np.arange(n)]).astype(np.int32)
    dst = np.concatenate([rng.integers(0, n, E),
                          np.arange(n)]).astype(np.int32)
    uk = np.unique(dst.astype(np.int64) * n + src)
    dst, src = (uk // n).astype(np.int32), (uk % n).astype(np.int32)
    return rng, src, dst, rng.random(len(src)).astype(np.float32)


def _spmm_operands(seed, n, deg, f, frac_active):
    rng, src, dst, coef = _graph(seed, n, deg)
    ell = build_block_ell(src, dst, coef, n)
    x = rng.standard_normal((n, f)).astype(np.float32)
    n_rb = ell.tile_col.shape[0]
    active = (rng.random(n_rb) < frac_active).astype(np.int32)
    if frac_active < 1.0:          # active and inactive blocks both
        active[0], active[-1] = 1, 0
    return src, dst, coef, ell, x, active


@pytest.mark.parametrize("seed,n,deg,f,frac_active", SPMM_CASES)
def test_spmm_dense_matches_jax(seed, n, deg, f, frac_active):
    src, dst, coef, _, x, active = _spmm_operands(seed, n, deg, f,
                                                  frac_active)
    jell = j_build_block_ell(src, dst, coef, n)
    xp = j_pad_features(x, jell.n_pad)
    want = np.asarray(j_ref_spmm_dense(src, dst, coef, jell.n_pad,
                                       jnp.asarray(xp), active))
    got = ref_spmm_dense(src, dst, coef, jell.n_pad,
                         torch.from_numpy(np.ascontiguousarray(xp)), active)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed,n,deg,f,frac_active", SPMM_CASES)
def test_spmm_tiles_match_dense(seed, n, deg, f, frac_active):
    src, dst, coef, ell, x, active = _spmm_operands(seed, n, deg, f,
                                                    frac_active)
    xp = torch.from_numpy(pad_features(x, ell.n_pad))
    act = torch.from_numpy(active)
    got = ref_spmm_block_ell(*map(torch.from_numpy, (
        ell.tiles, ell.tile_col, ell.valid)), act, xp)
    want = ref_spmm_dense(src, dst, coef, ell.n_pad, xp, act)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    dead = np.repeat(active == 0, RB)
    assert dead.any() == (frac_active < 1.0)
    assert not want.numpy()[dead].any() and got.numpy()[~dead].any()
