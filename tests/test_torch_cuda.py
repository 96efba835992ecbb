"""The CUDA kernels B1-B5 on the card, against their plain PyTorch
versions, and the port's engine end to end on the card. Marked `cuda`;
each test skips (from its fixture) where no GPU is present. Run on a GPU
machine with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: out / dist2 allclose at rtol = 1e-5, atol = 1e-5 (f32 sums in
another order than the plain version's); exit flags equal outside a
1e-4 relative margin around the squared threshold; the fused kernel's
`out` bitwise equal to the SpMM kernel's and its flags to the two-launch
composition's (csrc/block_ell.cuh). WKV6 (B5): out and state at
rtol = 1e-4, atol = 1e-3 (the same chunked f32 factorization, with
exp(+-80)-sized factors, summed in another order). Flash attention (B4):
f32 at rtol = 1e-4, atol = 2e-5 (softmax sums in another order); bf16
inputs against the plain version on the same bf16 inputs at
rtol = atol = 1e-2 (the kernel rounds the softmax weights P to bf16 for
the tensor cores, 2^-9 relative each, and both round the output to bf16,
2^-8 relative). B1 on dense tiles at atol = 1e-3 (sums of ~10^4 terms of
size ~1 in another order than the plain version's).

Non-finite x: on dyadic operands (every product and sum exact in f32)
B1 and B2 equal their plain versions elementwise, NaN and +-Inf in the
same places, also over two chained steps that pass the kernels' own
flags on. B5 at hd 16/32/64 and T up to 4096: out and state at
rtol = 1e-4, atol = max(1e-3, 1e-5 * the largest plain value) (with no
decay, logw = 0, the state sums thousands of steps and reaches ~10^3)."""
import numpy as np
import pytest
import torch

from repro_torch.gnn import (GNNConfig, NAIConfig, init_classifiers,
                             load_dataset)
from repro_torch.gnn.nai import decision_distances
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 gqa_flash_attention,
                                                 ref_attention)
from repro_torch.kernels.nap_exit import nap_exit, ref_nap_exit
from repro_torch.kernels.nap_step import (nap_step_fused, ref_nap_step,
                                          two_launch_step)
from repro_torch.kernels.spmm import (CB, RB, nonfinite_blocks,
                                      ref_spmm_block_ell, spmm_block_ell,
                                      zero_flags)
from repro_torch.kernels.wkv6 import ref_wkv6, wkv6, wkv6_heads
from repro_torch.serving import NAIServingEngine

from torch_parity import assert_orders_match, near_threshold

pytestmark = pytest.mark.cuda

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    build.library()
    return torch.device("cuda")


def _operands(dev, seed=0, n_rb=96, tb=5, n_cb=6, F=384, nb=64,
              frac_active=0.7, density=0.03, dyadic=False):
    g = torch.Generator().manual_seed(seed)
    # sparse tiles: by default ~3% non-zero, the packer's order of magnitude
    tiles = torch.rand((n_rb, tb, RB, CB), generator=g)
    if dyadic:   # 1/4, 1/2 or 1: exact products and sums below
        tiles = 2.0 ** -torch.randint(0, 3, tiles.shape, generator=g)
    tiles *= torch.rand(tiles.shape, generator=g) < density
    tile_col = torch.randint(0, n_cb, (n_rb, tb), generator=g,
                             dtype=torch.int32)
    valid = (torch.rand((n_rb, tb), generator=g) < 0.6).to(torch.int32)
    active = (torch.rand(n_rb, generator=g) < frac_active).to(torch.int32)
    active[:nb // RB] = 1
    x = torch.randn((n_cb * CB, F), generator=g)
    c = torch.rand(nb, generator=g) + 0.1
    s = torch.randn(F, generator=g)
    if dyadic:
        x = torch.randint(-3, 4, x.shape, generator=g).float()
        c = 2.0 ** -torch.randint(0, 2, c.shape, generator=g).float()
        s = torch.randint(-1, 2, s.shape, generator=g).float()
    nact = (torch.rand((nb, 1), generator=g) < 0.8).to(torch.int32)
    return [t.to(dev) for t in (tiles, tile_col, valid, active, x, c, s,
                                nact)]


def _threshold(out, c, s, nact):
    """A squared threshold at the median active distance."""
    d2 = ((out[:c.numel()] - c[:, None] * s[None, :]) ** 2).sum(1)
    return float(d2[nact[:, 0] != 0].median())


def _exits_match(a, b, d2, ts2):
    far = (d2.flatten() - ts2).abs() > 1e-4 * abs(ts2)
    assert torch.equal(a.flatten()[far], b.flatten()[far])


@pytest.mark.parametrize("seed", [0, 1])
def test_spmm_kernel_matches_plain(cuda, seed):
    tiles, tile_col, valid, active, x, *_ = _operands(cuda, seed)
    before = spmm_block_ell.launches
    out = spmm_block_ell(tiles, tile_col, valid, active, x)
    torch.cuda.synchronize()
    assert spmm_block_ell.launches == before + 1
    ref = ref_spmm_block_ell(tiles, tile_col, valid, active, x)
    torch.testing.assert_close(out, ref, **TOL)
    dead = (active == 0).repeat_interleave(RB)
    assert not out[dead].any()


@pytest.mark.parametrize("density,F,tb", [
    (0.0, 128, 20), (0.0, 512, 20),        # every tile empty
    (0.003, 128, 20), (0.003, 512, 20),    # ~3 non-zeros per tile
    (0.03, 128, 20), (0.03, 512, 20),
    (1.0, 128, 20), (1.0, 512, 20),        # dense: 1,024 per tile, 4 a chunk
    (0.003, 128, 140),                     # more slots than one window
])
def test_spmm_kernel_by_density(cuda, density, F, tb):
    """B1 skips zeros: allclose to the plain version at every density, and
    bitwise equal to the dense fused step's `out`."""
    ops = _operands(cuda, 5, tb=tb, F=F, density=density)
    tiles, tile_col, valid, active, x, *_ = ops
    out = spmm_block_ell(tiles, tile_col, valid, active, x)
    f_out, _, _ = nap_step_fused(*ops, 1.0)
    ref = ref_spmm_block_ell(tiles, tile_col, valid, active, x)
    torch.cuda.synchronize()
    tol = TOL if density < 1.0 else dict(rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(out, ref, **tol)
    assert torch.equal(out, f_out)
    if density == 0.0:
        assert not out.any()


def test_nap_step_kernel_matches_plain_and_spmm(cuda):
    ops = _operands(cuda, 2)
    tiles, tile_col, valid, active, x, c, s, nact = ops
    out_b1 = spmm_block_ell(tiles, tile_col, valid, active, x)
    ts2 = _threshold(out_b1, c, s, nact)
    out, exits, blk = nap_step_fused(*ops, ts2)
    r_out, r_exits, r_blk = ref_nap_step(*ops, ts2)
    torch.cuda.synchronize()
    assert torch.equal(out, out_b1)             # bitwise, same fmaf chain
    torch.testing.assert_close(out, r_out, **TOL)
    d2 = ((r_out[:c.numel()] - c[:, None] * s[None, :]) ** 2).sum(1)
    _exits_match(exits, r_exits, d2, ts2)
    t_out, t_exits, t_blk = two_launch_step(*ops, float(np.sqrt(ts2)))
    t_ts2 = float(np.float32(np.sqrt(ts2) * np.sqrt(ts2)))
    f_out, f_exits, f_blk = nap_step_fused(*ops, t_ts2)
    assert torch.equal(t_out, f_out)
    assert torch.equal(t_exits, f_exits) and torch.equal(t_blk, f_blk)


def test_nap_exit_kernel_matches_plain(cuda):
    _, _, _, _, x, c, s, nact = _operands(cuda, 3)
    nb = c.numel()
    xb = x[:nb].contiguous()
    x_inf = c[:, None] * s[None, :]
    ts2 = float(((xb - x_inf) ** 2).sum(1).median())
    d2, exits, blk = nap_exit(xb, x_inf, nact, ts2)
    r_d2, r_exits, r_blk = ref_nap_exit(xb, x_inf, nact, ts2)
    torch.cuda.synchronize()
    torch.testing.assert_close(d2, r_d2, **TOL)
    _exits_match(exits, r_exits, r_d2, ts2)


def test_kernels_refuse_bad_operands_on_cuda(cuda):
    tiles, tile_col, valid, active, x, *_ = _operands(cuda, 4)
    with pytest.raises(ValueError, match="tile_col"):
        spmm_block_ell(tiles, tile_col.long(), valid, active, x)
    with pytest.raises(ValueError, match="several devices"):
        spmm_block_ell(tiles, tile_col, valid, active, x.cpu())


def test_engine_on_card(cuda):
    """block_ell and fused agree exactly; every backend agrees with the
    host path outside the threshold margin."""
    g = load_dataset("pubmed-like", scale=0.1, seed=0)
    cfg = GNNConfig("sgc", g.features.shape[1], g.num_classes, k=4,
                    hidden=64, mlp_layers=2)
    nai = NAIConfig(t_s=20.0, t_min=1, t_max=3, batch_size=100)
    heads = init_classifiers(cfg, torch.Generator().manual_seed(0),
                             device=cuda)
    nodes = np.random.default_rng(0).choice(g.test_idx, size=300,
                                            replace=False)

    def serve(**kw):
        eng = NAIServingEngine(cfg, nai, heads, g, device=cuda,
                               max_wait_s=10.0, **kw)
        eng.submit(nodes)
        done = []
        while eng.queue:
            done += eng.step()
        done += eng.flush()
        assert [r.status for r in done] == ["completed"] * len(nodes)
        return (np.array([r.prediction for r in done]),
                np.array([r.exit_order for r in done]))

    host = serve(mode="host")
    res = {impl: serve(mode="compiled", spmm_impl=impl, pipeline_depth=2)
           for impl in ("segment", "block_ell", "fused")}
    for a, b in zip(res["fused"], res["block_ell"]):
        np.testing.assert_array_equal(a, b)
    near = near_threshold(decision_distances, cfg, nai, g, nodes, 100)
    for impl, (p, o) in res.items():
        assert_orders_match(p, o, *host, near)
    assert set(host[1]) == {1, 2, 3}


@pytest.mark.parametrize("hd,T", [(16, 48), (32, 64), (64, 128)])
def test_wkv6_kernel_matches_plain(cuda, hd, T):
    g = torch.Generator().manual_seed(hd)
    BH = 6
    r, k, v = (torch.randn((BH, T, hd), generator=g) for _ in range(3))
    logw = torch.clamp(-torch.exp(0.5 * torch.randn((BH, T, hd),
                                                    generator=g)), min=-5.0)
    u = 0.1 * torch.randn((BH, hd), generator=g)
    args = [t.to(cuda) for t in (r, k, v, logw, u)]
    before = wkv6.launches
    out, state = wkv6(*args)
    torch.cuda.synchronize()
    assert wkv6.launches == before + 1
    r_out, r_state = ref_wkv6(*args)
    torch.testing.assert_close(out, r_out, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(state, r_state, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("dtype,hd,H,KV,S,window,causal", [
    (torch.float32, 64, 4, 4, 256, 0, True),
    (torch.float32, 128, 4, 2, 384, 128, True),
    (torch.float32, 256, 4, 1, 256, 64, True),
    (torch.float32, 64, 2, 1, 256, 0, False),
    (torch.bfloat16, 256, 8, 1, 512, 192, True),
    (torch.bfloat16, 128, 4, 4, 256, 0, True),
    (torch.bfloat16, 64, 16, 1, 384, 100, True),     # window not a multiple of 64
    (torch.bfloat16, 128, 16, 1, 256, 1000, True),   # window longer than S
    (torch.bfloat16, 256, 16, 1, 512, 0, True),
    (torch.bfloat16, 64, 4, 2, 256, 0, False),
])
def test_flash_attention_kernel_matches_plain(cuda, dtype, hd, H, KV, S,
                                              window, causal):
    g = torch.Generator().manual_seed(S + hd)
    B = 2
    q = torch.randn((B, S, H, hd), generator=g).to(cuda, dtype)
    k = torch.randn((B, S, KV, hd), generator=g).to(cuda, dtype)
    v = torch.randn((B, S, KV, hd), generator=g).to(cuda, dtype)
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    ref = ref_attention(q, k, v, causal=causal, window=window)
    tol = dict(rtol=1e-4, atol=2e-5) if dtype == torch.float32 \
        else dict(rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(out.float(), ref.float(), **tol)


def test_gqa_flash_attention_unpadded_on_card(cuda):
    g = torch.Generator().manual_seed(7)
    q = torch.randn((2, 100, 8, 64), generator=g).to(cuda)
    k = torch.randn((2, 100, 2, 64), generator=g).to(cuda)
    v = torch.randn((2, 100, 2, 64), generator=g).to(cuda)
    out = gqa_flash_attention(q, k, v, window=48)
    ref = ref_attention(q, k, v, window=48)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=2e-5)


def test_gqa_flash_attention_unpadded_bf16_on_card(cuda):
    """S = 200 is padded to 256 for the tensor-core kernel and cut back."""
    g = torch.Generator().manual_seed(8)
    q = torch.randn((2, 200, 16, 256), generator=g).to(cuda, torch.bfloat16)
    k = torch.randn((2, 200, 1, 256), generator=g).to(cuda, torch.bfloat16)
    v = torch.randn((2, 200, 1, 256), generator=g).to(cuda, torch.bfloat16)
    out = gqa_flash_attention(q, k, v, window=72)
    ref = ref_attention(q, k, v, window=72)
    assert out.shape == q.shape
    torch.testing.assert_close(out.float(), ref.float(), rtol=1e-2, atol=1e-2)


def test_lm_kernels_refuse_bad_operands_on_cuda(cuda):
    x = torch.zeros((2, 128, 1, 32), device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(x, x, x)
    y = torch.zeros((2, 16, 48), device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        wkv6(y, y, y, y, torch.zeros((2, 48), device=cuda))


def _plant(ops, behind, seed):
    """NaN, +Inf and -Inf into three x rows (a few features each) that
    only zero coefficients of valid active tiles name (`behind="zero"`),
    or that a non-zero coefficient of such a tile names."""
    tiles, tile_col, valid, active, x = ops[:5]
    g = torch.Generator().manual_seed(seed)
    use = (valid != 0) & (active[:, None] != 0)
    named = tile_col[use].unique()
    for i, val in enumerate((float("nan"), float("inf"), float("-inf"))):
        xb = int(named[i % len(named)])
        k = int(torch.randint(0, CB, (1,), generator=g))
        sel = use & (tile_col == xb)
        if behind == "zero":
            tiles[..., k][sel] = 0.0
        else:
            tiles[..., 0, k][sel] = 0.5
        f = torch.randint(0, x.shape[1], (3,), generator=g)
        x[xb * CB + k, f.to(x.device)] = val
    return ops


@pytest.mark.parametrize("behind", ["zero", "nonzero"])
@pytest.mark.parametrize("F", [384, 640])
def test_kernels_nonfinite_match_plain(cuda, behind, F):
    """B1 and B2 equal their plain versions elementwise on x with NaN and
    +-Inf behind zero (or non-zero) coefficients, for one step and for a
    second step fed the first one's output and flags."""
    ops = _plant(_operands(cuda, 11, F=F, dyadic=True), behind, 11)
    tiles, tile_col, valid, active, x, c, s, nact = ops
    ts2 = 50.0
    x_bad = nonfinite_blocks(x)
    b1_bad, b2_bad = (zero_flags(x.shape[0], F, cuda) for _ in range(2))
    out1 = spmm_block_ell(tiles, tile_col, valid, active, x, x_bad=x_bad,
                          out_bad=b1_bad)
    f1 = nap_step_fused(*ops, ts2, x_bad=x_bad, out_bad=b2_bad)
    r1 = ref_nap_step(*ops, ts2)
    torch.cuda.synchronize()
    assert out1.isnan().any() and (behind == "zero" or out1.isinf().any())
    for a, b in zip(f1, r1):
        np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())
    assert torch.equal(out1.isnan(), f1[0].isnan())
    np.testing.assert_array_equal(out1.cpu().numpy(), r1[0].cpu().numpy())
    assert torch.equal(b1_bad, nonfinite_blocks(r1[0]))
    assert torch.equal(b1_bad, b2_bad)
    # step 2: x = step 1's output, flags from the kernel (the NAP loop)
    out2 = spmm_block_ell(tiles, tile_col, valid, active, out1,
                          x_bad=b1_bad)
    f2 = nap_step_fused(tiles, tile_col, valid, active, f1[0], c, s, nact,
                        ts2, x_bad=b2_bad)
    r2 = ref_nap_step(tiles, tile_col, valid, active, r1[0], c, s, nact,
                      ts2)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(out2.cpu().numpy(), r2[0].cpu().numpy())
    for a, b in zip(f2, r2):
        np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())


@pytest.mark.parametrize("density", [0.0, 0.003, 0.03, 1.0])
@pytest.mark.parametrize("F", [128, 384, 512, 640])
def test_nap_step_kernel_by_density_and_features(cuda, density, F):
    """B2 runs B1's zero-skipping code: `out` and its flags bitwise B1's,
    exit flags and block flags bitwise B1 then B3's, at every tile density
    and with F over one 512-feature slab."""
    ops = _operands(cuda, 6, tb=12, F=F, density=density)
    tiles, tile_col, valid, active, x, c, s, nact = ops
    b1_bad, b2_bad = (zero_flags(x.shape[0], F, cuda) for _ in range(2))
    out_b1 = spmm_block_ell(tiles, tile_col, valid, active, x,
                            out_bad=b1_bad)
    ts2 = _threshold(out_b1, c, s, nact) if density > 0 else 1.0
    t_s = float(np.sqrt(ts2))
    t_ts2 = float(np.float32(t_s * t_s))
    out, exits, blk = nap_step_fused(*ops, t_ts2, out_bad=b2_bad)
    t_out, t_exits, t_blk = two_launch_step(*ops, t_s)
    r_out = ref_spmm_block_ell(tiles, tile_col, valid, active, x)
    torch.cuda.synchronize()
    assert torch.equal(out, out_b1) and torch.equal(b1_bad, b2_bad)
    assert torch.equal(out, t_out)
    assert torch.equal(exits, t_exits) and torch.equal(blk, t_blk)
    tol = TOL if density < 1.0 else dict(rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(out, r_out, **tol)


@pytest.mark.parametrize("hd", [16, 32, 64])
@pytest.mark.parametrize("T", [16, 2048, 4096])
@pytest.mark.parametrize("decay", ["random", "min", "none"])
def test_wkv6_kernel_by_shape_and_decay(cuda, hd, T, decay):
    """B5 against its plain version; BH = 5 (no grouping of rows assumed);
    logw random in [-5, 0), all at the clamp -5, or all 0 (no decay)."""
    g = torch.Generator().manual_seed(hd + T)
    BH = 5
    r, k, v = (torch.randn((BH, T, hd), generator=g) for _ in range(3))
    if decay == "random":
        logw = torch.clamp(-torch.exp(0.5 * torch.randn((BH, T, hd),
                                                        generator=g)),
                           min=-5.0)
    else:
        logw = torch.full((BH, T, hd), -5.0 if decay == "min" else 0.0)
    u = 0.1 * torch.randn((BH, hd), generator=g)
    args = [t.to(cuda) for t in (r, k, v, logw, u)]
    out, state = wkv6(*args)
    r_out, r_state = ref_wkv6(*args)
    torch.cuda.synchronize()
    scale = float(max(r_out.abs().max(), r_state.abs().max()))
    tol = dict(rtol=1e-4, atol=max(1e-3, 1e-5 * scale))
    torch.testing.assert_close(out, r_out, **tol)
    torch.testing.assert_close(state, r_state, **tol)


@pytest.mark.parametrize("T", [5, 100, 2049])
def test_wkv6_heads_unpadded_on_card(cuda, T):
    """The model's (B, T, H, hd) layout goes to the kernel as it is, T not
    a multiple of 16: out and state equal the plain version's on the
    padded copies (`wkv6_heads` on the CPU)."""
    g = torch.Generator().manual_seed(T)
    B, H, hd = 2, 3, 64
    r, k, v = (torch.randn((B, T, H, hd), generator=g) for _ in range(3))
    logw = torch.clamp(-torch.exp(0.5 * torch.randn((B, T, H, hd),
                                                    generator=g)), min=-5.0)
    u = 0.1 * torch.randn((H, hd), generator=g)
    before = wkv6.launches
    out, state = wkv6_heads(*(t.to(cuda) for t in (r, k, v, logw, u)))
    torch.cuda.synchronize()
    assert wkv6.launches == before + 1
    r_out, r_state = wkv6_heads(r, k, v, logw, u)
    assert out.shape == (B, T, H, hd) and state.shape == (B, H, hd, hd)
    torch.testing.assert_close(out.cpu(), r_out, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(state.cpu(), r_state, rtol=1e-4, atol=1e-3)
