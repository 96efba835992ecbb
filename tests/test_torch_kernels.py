"""Kernels B1-B3 of the PyTorch port against the JAX package's Pallas
kernels (run in interpret mode on the CPU). Here the port's wrappers take
the plain PyTorch versions, since the tensors lie on the CPU; the CUDA
kernels are held against the same plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).

Tolerances: propagated values and distances are f32 sums taken in
another order than XLA's, so they are compared with rtol = atol = 1e-5;
exit flags and block predicates must be EQUAL (every distance of these
inputs lies far from the threshold; asserted).

Non-finite x (`test_*_nonfinite_*`): operands whose coefficients, features
and stationary factors are small dyadic numbers, so that every product and
sum is exact in f32 in any order; there the plain versions and the Pallas
kernels must agree bit for bit, NaN and +-Inf included (a NaN or Inf
behind a zero coefficient gives NaN, 0 * Inf = NaN, as the dense
product does). These cases pin the semantics the CUDA kernels are held
to on the card (tests/test_torch_cuda.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.nap_exit import nap_exit as j_nap_exit
from repro.kernels.nap_step import fused_step as j_fused_step
from repro.kernels.nap_step import two_launch_step as j_two_launch
from repro.kernels.spmm import build_block_ell as j_build_block_ell
from repro.kernels.spmm import pad_features as j_pad_features
from repro.kernels.spmm import spmm_block_ell as j_spmm

from repro_torch.kernels.nap_exit import nap_exit, ref_nap_exit
from repro_torch.kernels.nap_step import (fused_step, nap_step_fused,
                                          ref_nap_step, two_launch_step)
from repro_torch.kernels.spmm import (CB, RB, SLAB, build_block_ell,
                                      nonfinite_blocks, pad_features,
                                      ref_spmm_block_ell, spmm_block_ell)

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
T_S = 9.0


def _random_graph(rng, n, deg):
    E = n * deg
    src = np.concatenate([rng.integers(0, n, E),
                          np.arange(n)]).astype(np.int32)
    dst = np.concatenate([rng.integers(0, n, E),
                          np.arange(n)]).astype(np.int32)
    uk = np.unique(dst.astype(np.int64) * n + src)
    dst, src = (uk // n).astype(np.int32), (uk % n).astype(np.int32)
    return src, dst, rng.random(len(src)).astype(np.float32)


def _convert(src, dst, coef, n, x):
    """Block-ELL operands of the edge list and the padded x, from the
    port's converter (the port's side) and from the JAX package's (the
    oracle's side, with x under "x"; the port's x under "x_port")."""
    ell, jell = (build_block_ell(src, dst, coef, n),
                 j_build_block_ell(src, dst, coef, n))
    return ell, dict(tiles=jell.tiles, tile_col=jell.tile_col,
                     valid=jell.valid, x=j_pad_features(x, jell.n_pad),
                     x_port=pad_features(x, ell.n_pad))


def _jax(o, keys):
    """The JAX side's operands: its own converter's arrays where it has
    them, the shared ones otherwise."""
    return [jnp.asarray(o["jax"].get(k, o[k])) for k in keys]


def _operands(seed, frac_active, frac_nodes, n=192, deg=5, f=200, nb=32):
    """Numpy operands shared by both packages: block-ELL tiles of a
    random graph, two feature blocks, rank-1 factors, masks."""
    rng = np.random.default_rng(seed)
    src, dst, coef = _random_graph(rng, n, deg)
    ell, jax_ops = _convert(src, dst, coef, n,
                            rng.standard_normal((n, f)).astype(np.float32))
    x = jax_ops.pop("x_port")
    f_pad = x.shape[1]
    c = rng.random(nb).astype(np.float32) + 0.1
    s = np.pad(rng.standard_normal(f).astype(np.float32), (0, f_pad - f))
    n_rb = ell.tile_col.shape[0]
    active = (rng.random(n_rb) < frac_active).astype(np.int32)
    active[:nb // RB] = 1
    nact = (rng.random(nb) < frac_nodes).astype(np.int32)[:, None]
    return dict(tiles=ell.tiles, tile_col=ell.tile_col, valid=ell.valid,
                active=active, x=x, c=c, s=s, nact=nact, jax=jax_ops)


CASES = [(0, 1.0, 1.0), (1, 0.6, 0.5), (2, 1.0, 0.0), (3, 0.3, 1.0)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _far_from_threshold(dist2, ts2):
    assert np.abs(np.asarray(dist2) - ts2).min() > 1e-3 * ts2


@pytest.mark.parametrize("seed,frac_active,frac_nodes", CASES)
def test_spmm_plain_matches_pallas(seed, frac_active, frac_nodes):
    o = _operands(seed, frac_active, frac_nodes)
    want = np.asarray(j_spmm(*_jax(o, ("tiles", "tile_col", "valid",
                                       "active", "x")), interpret=True))
    args = [_t(o[k]) for k in ("tiles", "tile_col", "valid", "active", "x")]
    got = spmm_block_ell(*args)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # inactive row blocks are exactly zero, as in the Pallas kernel
    dead = np.repeat(o["active"] == 0, RB)
    assert not got.numpy()[dead].any()
    np.testing.assert_array_equal(ref_spmm_block_ell(*args).numpy(),
                                  got.numpy())


@pytest.mark.parametrize("seed,frac_nodes", [(0, 1.0), (1, 0.5), (2, 0.0)])
def test_nap_exit_plain_matches_pallas(seed, frac_nodes):
    o = _operands(seed, 1.0, frac_nodes)
    nb = len(o["c"])
    x = o["x"][:nb]
    x_inf = o["c"][:, None] * o["s"][None, :]
    jd, je, jb = j_nap_exit(jnp.asarray(o["jax"]["x"][:nb]),
                            jnp.asarray(x_inf),
                            jnp.asarray(o["nact"]), T_S, interpret=True)
    ts2 = float(np.float32(T_S * T_S))
    td, te, tb = nap_exit(_t(x), _t(x_inf), _t(o["nact"]), ts2)
    _far_from_threshold(jd, ts2)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), **TOL)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    for a, b in zip(ref_nap_exit(_t(x), _t(x_inf), _t(o["nact"]), ts2),
                    (td, te, tb)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("seed,frac_active,frac_nodes", CASES)
def test_nap_step_plain_matches_pallas(seed, frac_active, frac_nodes):
    """The fused step and the two-launch composition, both packages: all
    four agree on every output, flags exactly."""
    o = _operands(seed, frac_active, frac_nodes)
    keys = ("tiles", "tile_col", "valid", "active", "x", "c", "s", "nact")
    jargs = _jax(o, keys)
    targs = [_t(o[k]) for k in keys]
    j_f = j_fused_step(*jargs, T_S, interpret=True)
    j_t = j_two_launch(*jargs, T_S, interpret=True)
    t_f = fused_step(*targs, T_S)
    t_t = two_launch_step(*targs, T_S)
    nb = len(o["c"])
    d2 = ((np.asarray(j_f[0])[:nb] - o["c"][:, None] * o["s"][None, :])
          ** 2).sum(1)
    _far_from_threshold(d2, T_S * T_S)
    for want in (j_f, j_t):
        np.testing.assert_allclose(t_f[0].numpy(), np.asarray(want[0]),
                                   **TOL)
        for i in (1, 2):
            np.testing.assert_array_equal(t_f[i].numpy(),
                                          np.asarray(want[i]))
    for a, b in zip(t_f, t_t):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    ts2 = float(np.float32(T_S * T_S))
    for a, b in zip(ref_nap_step(*targs, ts2),
                    nap_step_fused(*targs, ts2)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_negative_ts2_gates_exits():
    """A negative squared threshold (T_min/T_max gating) keeps every
    active node active."""
    o = _operands(4, 1.0, 0.7)
    keys = ("tiles", "tile_col", "valid", "active", "x", "c", "s", "nact")
    _, exits, blk = nap_step_fused(*[_t(o[k]) for k in keys], -1.0)
    nb = len(o["c"])
    assert int(exits.sum()) == 0
    expect = o["nact"][:, 0].reshape(-1, RB).any(axis=1).astype(np.int32)
    np.testing.assert_array_equal(blk.numpy()[:nb // RB, 0], expect)
    assert int(blk[nb // RB:].sum()) == 0


def test_all_inactive_touches_nothing():
    o = _operands(5, 1.0, 1.0)
    keys = ("tiles", "tile_col", "valid", "active", "x", "c", "s", "nact")
    args = [_t(o[k]) for k in keys]
    args[3] = torch.zeros_like(args[3])
    args[7] = torch.zeros_like(args[7])
    out, exits, blk = fused_step(*args, T_S)
    assert float(out.abs().max()) == 0.0
    assert int(exits.sum()) == 0 and int(blk.sum()) == 0


def test_wrappers_reject_bad_operands():
    o = _operands(0, 1.0, 1.0)
    args = [_t(o[k]) for k in ("tiles", "tile_col", "valid", "active", "x")]
    bad_dtype = list(args)
    bad_dtype[1] = bad_dtype[1].long()
    with pytest.raises(ValueError, match="tile_col"):
        spmm_block_ell(*bad_dtype)
    bad_x = list(args)
    bad_x[4] = bad_x[4][:, :100]
    with pytest.raises(ValueError, match="features"):
        spmm_block_ell(*bad_x)
    strided = list(args)
    strided[4] = torch.zeros(args[4].shape[1], args[4].shape[0]).t()
    with pytest.raises(ValueError, match="contiguous"):
        spmm_block_ell(*strided)
    nb = len(o["c"])
    x = _t(o["x"][:nb])
    with pytest.raises(ValueError, match="active"):
        nap_exit(x, x.clone(), torch.ones(nb, dtype=torch.int32), 1.0)
    with pytest.raises(ValueError, match="c_inf"):
        nap_step_fused(*args, _t(o["c"][:12]), _t(o["s"]),
                       torch.ones((12, 1), dtype=torch.int32), 1.0)


PLANTS = {"nan": np.nan, "+inf": np.inf, "-inf": -np.inf}


def _nonfinite_operands(seed, behind, frac_active=0.8, n=300, deg=4, f=200,
                        nb=32):
    """Dyadic operands (exact f32 arithmetic) with NaN, +Inf and -Inf
    planted in three x rows: rows that only zero coefficients name
    (`behind="zero"`: every edge out of them has coefficient 0, so their
    tiles stay valid), or rows that non-zero ones name ("nonzero").
    Returns the operand dict and the planted rows."""
    rng = np.random.default_rng(seed)
    src, dst, _ = _random_graph(rng, n, deg)
    coef = rng.choice(np.float32([0.25, 0.5, 1.0]), len(src))
    rows = rng.choice(np.arange(nb, n), 3, replace=False)
    if behind == "zero":
        coef[np.isin(src, rows)] = 0.0
    ell, jax_ops = _convert(src, dst, coef, n,
                            rng.integers(-3, 4, (n, f)).astype(np.float32))
    x = jax_ops.pop("x_port")
    for row, val in zip(rows, PLANTS.values()):
        cols = rng.choice(f, 5, replace=False)
        x[row, cols] = jax_ops["x"][row, cols] = val
    f_pad = x.shape[1]
    c = rng.choice(np.float32([0.5, 1.0, 2.0]), nb)
    s = np.pad(rng.integers(-1, 2, f).astype(np.float32), (0, f_pad - f))
    n_rb = ell.tile_col.shape[0]
    active = (rng.random(n_rb) < frac_active).astype(np.int32)
    active[:nb // RB] = 1
    nact = (rng.random(nb) < 0.8).astype(np.int32)[:, None]
    named = np.isin(np.arange(ell.n_pad), src[coef != 0])
    assert (named[rows] == (behind == "nonzero")).all()
    return dict(tiles=ell.tiles, tile_col=ell.tile_col, valid=ell.valid,
                active=active, x=x, c=c, s=s, nact=nact, jax=jax_ops), rows


@pytest.mark.parametrize("behind", ["zero", "nonzero"])
@pytest.mark.parametrize("seed", [0, 1])
def test_spmm_nonfinite_matches_pallas(seed, behind):
    """The plain SpMM equals the Pallas kernel elementwise on x with NaN
    and +-Inf, NaN in the same places, and the non-finite values reach
    the output."""
    o, rows = _nonfinite_operands(seed, behind)
    keys = ("tiles", "tile_col", "valid", "active", "x")
    want = np.asarray(j_spmm(*_jax(o, keys), interpret=True))
    args = [_t(o[k]) for k in keys]
    got = ref_spmm_block_ell(*args).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.isnan(got).any() and (behind == "zero"
                                    or np.isinf(got).any())
    np.testing.assert_array_equal(spmm_block_ell(*args).numpy(), want)


@pytest.mark.parametrize("behind", ["zero", "nonzero"])
def test_nap_step_nonfinite_matches_pallas(behind):
    """The plain fused step and the two-launch composition equal the
    Pallas fused step on every output where x holds NaN and +-Inf: rows
    that reach a NaN never exit."""
    o, _ = _nonfinite_operands(2, behind)
    keys = ("tiles", "tile_col", "valid", "active", "x", "c", "s", "nact")
    j_f = j_fused_step(*_jax(o, keys), T_S, interpret=True)
    targs = [_t(o[k]) for k in keys]
    ts2 = float(np.float32(T_S * T_S))
    for got in (ref_nap_step(*targs, ts2), fused_step(*targs, T_S),
                two_launch_step(*targs, T_S)):
        for a, b in zip(got, j_f):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    out = np.asarray(j_f[0])[:len(o["c"])]
    assert not np.asarray(j_f[1])[~np.isfinite(out).all(1)].any()


@pytest.mark.parametrize("F", [128, 512, 640, 1152])
def test_nonfinite_blocks_flags(F):
    """One flag per (128-row block, 512-feature slab), set exactly where a
    NaN or Inf lies; the wrappers fill `out_bad` with their output's."""
    rng = np.random.default_rng(F)
    x = rng.standard_normal((640, F)).astype(np.float32)
    spots = [(3, 0, np.nan), (130, F - 1, np.inf), (600, F // 2, -np.inf)]
    for i, j, val in spots:
        x[i, j] = val
    flags = nonfinite_blocks(torch.from_numpy(x)).numpy()
    want = np.zeros((-(-F // SLAB), 640 // CB), np.uint8)
    for i, j, _ in spots:
        want[j // SLAB, i // CB] = 1
    np.testing.assert_array_equal(flags, want)
    o, _ = _nonfinite_operands(3, "zero")
    args = [_t(o[k]) for k in ("tiles", "tile_col", "valid", "active", "x")]
    n_rb = o["tile_col"].shape[0]
    out_bad = torch.full((1, -(-n_rb * RB // CB)), 7, dtype=torch.uint8)
    out = spmm_block_ell(*args, x_bad=nonfinite_blocks(args[4]),
                         out_bad=out_bad)
    np.testing.assert_array_equal(out_bad.numpy(),
                                  nonfinite_blocks(out).numpy())
    assert out_bad.any()
    with pytest.raises(ValueError, match="x_bad"):
        spmm_block_ell(*args, x_bad=torch.zeros((2, 1), dtype=torch.uint8))
