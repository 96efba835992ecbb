"""The CUDA kernels B1-B5 on the card, against their plain PyTorch
versions, the port's engine end to end on the card, training on the
card (AdamW steps against the CPU's at rtol 1e-4, TF32 off; `train_nai`
with CUDA-generator dropout, its heads served), and D = 2 and 4 shards
on the one card equal to one device bit for bit on B1 + B3 and B2. Marked `cuda`;
each test skips (from its fixture) where no GPU is present. B4 with
grok's logit soft-cap against its plain version, and dbrx/grok MoE smoke
models through B4 on the card against the CPU (1e-3); B4 with a key
bound (cross-attention and bidirectional shapes, NaN in the cut keys
leaving the bits unchanged) and the VLM / encoder-decoder smoke models
on the card against the CPU (1e-3); the dense `attn` LMs tensor- and
data-parallel on meshes of the card repeated against the unsharded model
on the card (f32 1e-4, bf16 3e-2 relative L2; B4 once per layer and
position; two sharded runs bitwise equal); the MoE and recurrent kinds
(`attn_moe`, `rwkv`, `rglru`, `local`) on a (1, 2) mesh of the card
against the unsharded model (f32 1e-4), and B4 / B5 at the query, KV
and rwkv heads one mesh position holds at model 2 and 4; the
cross-attention and encoder kinds and adaptive decoding on a (1, 2) mesh
(f32 1e-4, `seed_frontend_cache` bitwise the placed prefill's, exit
blocks equal) and B4 at their per-position shapes; B4's query offset
(QOFF) against its plain version and, at offsets on its row blocks,
bit for bit the rows of the whole causal call, and the fallback
placements (query rows over "model", rwkv's (batch row, head) pairs) of
smoke models on the card against the unsharded model (f32 1e-4); the
device sampler on the card array-equal to the numpy sampler, the
engine's choice between the two (`sample_stats`), and the segment
operands built on the card (`pack_place`) equal to the host path's. Run on
a GPU
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

from torch_parity import (assert_orders_match, near_threshold,
                          plant_remote_nonfinite, sharded_pack_pair,
                          step_operands)

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


@pytest.mark.parametrize("n", [8, 512, 16384])
@pytest.mark.parametrize("F", [128, 512, 640])
def test_nap_exit_kernel_by_shape(cuda, n, F):
    """B3 (one warp per node, float4 loads) against its plain version
    from one 8-node group to a full support's rows, at one, four and five
    feature blocks."""
    g = torch.Generator().manual_seed(n + F)
    x = torch.randn((n, F), generator=g)
    x_inf = torch.rand(n, generator=g)[:, None] * torch.randn(F, generator=g)
    nact = (torch.rand((n, 1), generator=g) < 0.8).to(torch.int32)
    x, x_inf, nact = x.to(cuda), x_inf.to(cuda), nact.to(cuda)
    ts2 = float(((x - x_inf) ** 2).sum(1).median())
    before = nap_exit.launches
    d2, exits, blk = nap_exit(x, x_inf, nact, ts2)
    r_d2, r_exits, r_blk = ref_nap_exit(x, x_inf, nact, ts2)
    torch.cuda.synchronize()
    assert nap_exit.launches == before + 1
    torch.testing.assert_close(d2, r_d2, **TOL)
    _exits_match(exits, r_exits, r_d2, ts2)
    far = ((r_d2 - ts2).abs() > 1e-4 * ts2).reshape(-1, RB).all(1)
    assert torch.equal(blk[far], r_blk[far])


@pytest.mark.parametrize("F", [128, 512, 640])
def test_nap_exit_bitwise_equals_fused_step(cuda, F):
    """B3 on B2's propagated batch rows and x_inf = c * s: the same exit
    and block flags bit for bit (one `dist_terms` chain and one `row_sum`
    tree in block_ell.cuh), also over two 512-feature slabs."""
    ops = _operands(cuda, 7, F=F)
    tiles, tile_col, valid, active, x, c, s, nact = ops
    out_b1 = spmm_block_ell(tiles, tile_col, valid, active, x)
    ts2 = _threshold(out_b1, c, s, nact)
    out, f_exits, f_blk = nap_step_fused(*ops, ts2)
    nb = c.numel()
    d2, exits, blk = nap_exit(out[:nb], c[:, None] * s[None, :], nact, ts2)
    torch.cuda.synchronize()
    assert 0 < int(exits.sum()) < int(nact.sum())
    assert torch.equal(exits, f_exits)
    assert torch.equal(blk, f_blk[:nb // RB])
    assert not f_blk[nb // RB:].any()


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


def _serve_all(eng, nodes):
    eng.submit(nodes)
    done = []
    while eng.queue:
        done += eng.step()
    done += eng.flush()
    assert [r.status for r in done] == ["completed"] * len(nodes)
    return (np.array([r.prediction for r in done]),
            np.array([r.exit_order for r in done]))


def test_cached_engine_on_card(cuda):
    """The propagated-feature cache on the card: cached == cold for every
    backend, also after a mutation round, outside the threshold margin
    (a seeded value was summed in its fill batch's tile order, so it may
    differ from the cold path's in the last bits)."""
    from repro_torch.gnn.store import InMemoryStore
    g = load_dataset("pubmed-like", scale=0.1, seed=0)
    cfg = GNNConfig("sgc", g.features.shape[1], g.num_classes, k=4,
                    hidden=64, mlp_layers=2)
    nai = NAIConfig(t_s=20.0, t_min=1, t_max=3, batch_size=64)
    heads = init_classifiers(cfg, torch.Generator().manual_seed(0),
                             device=cuda)
    rng = np.random.default_rng(3)
    pool = rng.choice(g.test_idx, size=128, replace=False)
    stream = [rng.choice(pool, size=64, replace=False) for _ in range(6)]
    for impl in ("fused", "block_ell", "segment"):
        stores = InMemoryStore(g), InMemoryStore(g)
        hot, cold = (NAIServingEngine(cfg, nai, heads, st, device=cuda,
                                      max_wait_s=10.0, mode="compiled",
                                      spmm_impl=impl, pipeline_depth=2,
                                      **kw)
                     for st, kw in zip(stores, ({"cache_nodes": 4096}, {})))
        for rnd in range(2):
            if rnd:
                served = np.unique(np.concatenate(stream))
                src = rng.choice(served, size=8, replace=False)
                for st in stores:
                    st.add_edges(src, (src + 1) % g.n)
                    st.add_nodes(np.ones((2, g.features.shape[1]),
                                         np.float32))
            for nodes in stream:
                ph, oh = _serve_all(hot, nodes)
                pc, oc = _serve_all(cold, nodes)
                near = near_threshold(decision_distances, cfg, nai,
                                      stores[1], nodes, 64)
                assert_orders_match(ph, oh, pc, oc, near)
        cs = hot.cache_stats
        assert cs["hits"] > 0 and cs["stale"] > 0, cs
        assert cs["rows_packed"] < cs["rows_support"], cs


def test_mmap_store_engine_on_card(cuda, tmp_path):
    """An engine over an MmapStore gives exactly what one over the
    InMemoryStore of the same graph gives."""
    from repro_torch.gnn.store import MmapStore, save_graph_store
    g = load_dataset("pubmed-like", scale=0.1, seed=0)
    cfg = GNNConfig("sgc", g.features.shape[1], g.num_classes, k=4,
                    hidden=64, mlp_layers=2)
    nai = NAIConfig(t_s=20.0, t_min=1, t_max=3, batch_size=100)
    heads = init_classifiers(cfg, torch.Generator().manual_seed(0),
                             device=cuda)
    nodes = np.random.default_rng(0).choice(g.test_idx, size=300,
                                            replace=False)
    with MmapStore(save_graph_store(g, str(tmp_path / "s"))) as ms:
        assert ms.verify()
        for impl in ("fused", "block_ell"):
            res = [_serve_all(NAIServingEngine(
                cfg, nai, heads, st, device=cuda, max_wait_s=10.0,
                mode="compiled", spmm_impl=impl, pipeline_depth=2), nodes)
                for st in (g, ms)]
            for a, b in zip(*res):
                np.testing.assert_array_equal(a, b)


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


@pytest.mark.parametrize("dtype,S,window", [(torch.float32, 256, 0),
                                            (torch.bfloat16, 384, 0),
                                            (torch.bfloat16, 256, 100),
                                            (torch.float32, 256, 64)])
def test_flash_attention_softcap_matches_plain(cuda, dtype, S, window):
    """grok's logit soft-cap (30) at hd 128, GQA 8/2, with q scaled so
    that the logits reach ~150, far beyond the cap: the kernel against its
    plain version under the same cap (tolerances as without it), and far
    from the uncapped plain version (the cap acts)."""
    g = torch.Generator().manual_seed(S + window)
    B, H, KV, hd, cap = 2, 8, 2, 128, 30.0
    q = (6.0 * torch.randn((B, S, H, hd), generator=g)).to(cuda, dtype)
    k = (6.0 * torch.randn((B, S, KV, hd), generator=g)).to(cuda, dtype)
    v = torch.randn((B, S, KV, hd), generator=g).to(cuda, dtype)
    before = flash_attention.launches
    out = flash_attention(q, k, v, window=window, softcap=cap)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ref = ref_attention(q, k, v, window=window, softcap=cap)
    tol = dict(rtol=1e-4, atol=2e-5) if dtype == torch.float32 \
        else dict(rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(out.float(), ref.float(), **tol)
    far = ref_attention(q, k, v, window=window)
    assert (out.float() - far.float()).abs().max() > 0.5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_softcap_zero_is_the_uncapped_kernel(cuda, dtype):
    """softcap = 0 runs the kernels compiled without the cap: the same bits
    as a call that names no cap, and not those of a cap of 5 on the same
    logits. (Bits against the kernel before the cap existed:
    `python -m repro_torch.kernels.ab --against <parent checkout>`.)"""
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn((2, 256, 4, 128), generator=g).to(cuda, dtype)
               for _ in range(3))
    a = flash_attention(q, k, v)
    b = flash_attention(q, k, v, softcap=0.0)
    c = gqa_flash_attention(q, k, v, softcap=0.0)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and torch.equal(a, c)
    assert not torch.equal(a, flash_attention(q, k, v, softcap=5.0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,H,KV,Sq,Sk,kv_len,causal", [
    (64, 12, 12, 256, 1536, 1500, False),    # whisper's cross-attention
    (64, 12, 12, 1536, 1536, 1500, False),   # whisper's encoder
    (128, 32, 8, 256, 1664, 1600, False),    # llama-3.2-vision's xattn
    (128, 4, 2, 384, 128, 1, False),         # one key
    (64, 4, 1, 128, 256, 129, False),        # one key of the last block
    (128, 8, 2, 384, 384, 300, True),        # causal with a bound
])
def test_flash_attention_kv_len_matches_plain(cuda, dtype, hd, H, KV, Sq,
                                              Sk, kv_len, causal):
    """The key bound on the card: the kernel against its plain version
    with the same bound, and with NaN in every key and value at or past
    kv_len the same bits as with zeros there (the padding is never read)."""
    g = torch.Generator().manual_seed(Sk + kv_len + hd)
    B = 2
    q = torch.randn((B, Sq, H, hd), generator=g).to(cuda, dtype)
    k = torch.randn((B, Sk, KV, hd), generator=g).to(cuda, dtype)
    v = torch.randn((B, Sk, KV, hd), generator=g).to(cuda, dtype)
    k[:, kv_len:], v[:, kv_len:] = 0, 0
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal, kv_len=kv_len)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ref = ref_attention(q, k, v, causal=causal, kv_len=kv_len)
    tol = dict(rtol=1e-4, atol=2e-5) if dtype == torch.float32 \
        else dict(rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(out.float(), ref.float(), **tol)
    k[:, kv_len:], v[:, kv_len:] = float("nan"), float("nan")
    nan = flash_attention(q, k, v, causal=causal, kv_len=kv_len)
    assert torch.equal(nan, out)


@pytest.mark.parametrize("dtype,hd,H,KV,Sq,Sk,q_offset,window", [
    (torch.bfloat16, 128, 56, 8, 128, 2048, 1920, 0),   # deepseek, last rows
    (torch.bfloat16, 128, 8, 2, 256, 1024, 384, 0),
    (torch.bfloat16, 64, 12, 12, 128, 384, 128, 0),
    (torch.bfloat16, 64, 4, 1, 256, 1024, 640, 200),    # banded
    (torch.float32, 64, 12, 12, 128, 512, 256, 0),
    (torch.float32, 64, 4, 2, 128, 256, 100, 48),       # not block-aligned
    (torch.float32, 32, 6, 2, 128, 256, 128, 0),        # the smoke models
    (torch.float32, 32, 6, 6, 128, 256, 64, 16),
])
def test_flash_attention_q_offset_matches_plain(cuda, dtype, hd, H, KV, Sq,
                                                Sk, q_offset, window):
    """The instances with a query offset (QOFF): rows standing at
    q_offset.. of a causal sequence against the plain version with the
    same offset, counted in `offset_launches`; where the offset is a
    multiple of the kernel's row block, the same bits as those rows of
    the causal call over the whole sequence (the same key tiles, masks
    and order). At q_offset 0 the instances without the flag: the bits
    of a call that names no offset on the keys the rows reach."""
    g = torch.Generator().manual_seed(q_offset + hd)
    B = 2
    q = torch.randn((B, max(q_offset + Sq, Sk), H, hd), generator=g).to(
        cuda, dtype)
    k = torch.randn((B, Sk, KV, hd), generator=g).to(cuda, dtype)
    v = torch.randn((B, Sk, KV, hd), generator=g).to(cuda, dtype)
    rows = q[:, q_offset:q_offset + Sq].contiguous()
    before = (flash_attention.launches, flash_attention.offset_launches)
    out = flash_attention(rows, k, v, window=window, q_offset=q_offset)
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention.offset_launches) \
        == (before[0] + 1, before[1] + 1)
    ref = ref_attention(rows, k, v, window=window, q_offset=q_offset)
    tol = dict(rtol=1e-4, atol=2e-5) if dtype == torch.float32 \
        else dict(rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(out.float(), ref.float(), **tol)
    block = 64 if dtype == torch.float32 else 128
    if q_offset % block == 0 and Sk == q.shape[1]:
        full = flash_attention(q, k, v, window=window)
        assert torch.equal(out, full[:, q_offset:q_offset + Sq])
    head = q[:, :Sq].contiguous()
    zero = flash_attention(head, k, v, window=window, q_offset=0)
    assert flash_attention.offset_launches == before[1] + 1
    assert torch.equal(zero, flash_attention(
        head, k[:, :Sq].contiguous(), v[:, :Sq].contiguous(), window=window))
    torch.testing.assert_close(zero.float(), ref_attention(
        head, k, v, window=window, q_offset=0).float(), **tol)


def test_flash_attention_q_offset_refusals_on_cuda(cuda):
    """No QOFF instance with the soft-cap, at bf16 head dim 256 or f32 128;
    an offset only when causal."""
    q = torch.zeros((1, 128, 4, 128), device=cuda, dtype=torch.bfloat16)
    k = torch.zeros((1, 256, 4, 128), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="q_offset"):
        flash_attention(q, k, k, q_offset=128, softcap=30.0)
    with pytest.raises(ValueError, match="q_offset"):
        flash_attention(q.float(), k.float(), k.float(), q_offset=128)
    with pytest.raises(ValueError, match="q_offset"):
        flash_attention(q, k, k, q_offset=128, causal=False)
    q256 = torch.zeros((1, 128, 2, 256), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="q_offset"):
        flash_attention(q256, q256, q256, q_offset=64)


def test_gqa_flash_attention_q_offset_rows_on_card(cuda):
    """whisper-small's decoder rows at model 8 (28 of 224 tokens a
    position, padded to 128 rows, keys padded to 256 and bounded at 224):
    each position's rows through the wrapper with its offset, stacked,
    against the plain causal attention over the whole sequence."""
    g = torch.Generator().manual_seed(28)
    for dtype, tol in ((torch.float32, dict(rtol=1e-4, atol=2e-5)),
                       (torch.bfloat16, dict(rtol=1e-2, atol=1e-2))):
        q, k, v = (torch.randn((2, 224, 12, 64), generator=g).to(cuda, dtype)
                   for _ in range(3))
        parts = [gqa_flash_attention(q[:, r:r + 28], k, v, q_offset=r)
                 for r in range(0, 224, 28)]
        torch.testing.assert_close(torch.cat(parts, 1).float(),
                                   ref_attention(q, k, v).float(), **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 256])
def test_gqa_flash_attention_cross_unpadded_on_card(cuda, dtype, hd):
    """Cross-attention through the wrapper: Sq 200 and Sk 1500, each
    padded to a multiple of 128, the true Sk as the bound, against the
    plain version on the unpadded operands. The causal path at S = 2200
    (padded to 2304, bounded at 2200; at hd 256 the bf16 kernel's tiles
    are 64 keys, so the bound also cuts a tile) gives the bits of the
    unbounded kernel on the zero-padded operands in every real row."""
    g = torch.Generator().manual_seed(11)
    q = torch.randn((2, 200, 4, hd), generator=g).to(cuda, dtype)
    k = torch.randn((2, 1500, 4, hd), generator=g).to(cuda, dtype)
    v = torch.randn((2, 1500, 4, hd), generator=g).to(cuda, dtype)
    out = gqa_flash_attention(q, k, v, causal=False)
    assert out.shape == q.shape
    ref = ref_attention(q, k, v, causal=False)
    tol = dict(rtol=1e-4, atol=2e-5) if dtype == torch.float32 \
        else dict(rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(out.float(), ref.float(), **tol)
    x = torch.randn((2, 2200, 4, hd), generator=g).to(cuda, dtype)
    xp = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, 104))
    assert torch.equal(gqa_flash_attention(x, x, x),
                       flash_attention(xp, xp, xp)[:, :2200])


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "whisper-small"])
def test_encdec_prefill_and_decode_on_card_match_cpu(cuda, arch):
    """A VLM / encoder-decoder smoke model (head dim 64, which the kernel
    takes; the xattn gates set to 1) in f32: prefill with a stub frontend
    through B4 (self, bidirectional and cross-attention) and 3 decode
    steps on the card against the same on the CPU (plain versions),
    logits within 1e-3 relative L2; `seed_frontend_cache` equal to the
    prefill's xk / xv."""
    import dataclasses
    from repro_torch.configs import ARCHS, smoke
    from repro_torch.models import decoder_lm as M
    cfg = dataclasses.replace(smoke(ARCHS[arch]), head_dim=64)
    cpu = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    with torch.no_grad():
        for p, kind in zip(cpu.layers, cfg.layer_kinds):
            if kind == "xattn":
                p["gate_attn"].fill_(1.0)
                p["gate_mlp"].fill_(1.0)
    card = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    card.load_state_dict(cpu.state_dict())
    card = card.to(cuda)
    n = cfg.encoder_seq if cfg.is_encdec else cfg.num_image_tokens
    fe = torch.randn((3, n, cfg.d_model),
                     generator=torch.Generator().manual_seed(2))
    toks = torch.randint(0, cfg.vocab_size, (3, 40),
                         generator=torch.Generator().manual_seed(1))
    n_b4 = (sum(k in ("attn", "xattn") for k in cfg.layer_kinds)
            + 2 * cfg.layer_kinds.count("encdec") + cfg.encoder_layers)
    out = {}
    for dev, model in (("cpu", cpu), ("cuda", card)):
        before = flash_attention.launches
        t, f = toks.to(dev), fe.to(dev)
        last, cache = M.prefill_step(cfg, model, t, frontend=f, length=43)
        assert flash_attention.launches - before == (n_b4 if dev == "cuda"
                                                     else 0)
        seeded = M.seed_frontend_cache(cfg, model, M.init_cache(
            cfg, 3, 43, device=dev), f)
        for c, sc, kind in zip(cache, seeded, cfg.layer_kinds):
            if kind in ("xattn", "encdec"):
                assert torch.equal(c["xk"], sc["xk"])
                assert torch.equal(c["xv"], sc["xv"])
        steps = []
        tok = last.argmax(-1, keepdim=True).cpu()
        for pos in range(40, 43):
            lg, cache = M.decode_step(cfg, model, cache, tok.to(dev), pos)
            steps.append(lg[:, 0].cpu())
        out[dev] = (last.cpu(), steps)

    def rel(a, b):
        return float((a - b).norm() / b.norm())
    (p0, s0), (p1, s1) = out["cpu"], out["cuda"]
    assert rel(p1, p0) < 1e-3
    assert all(rel(b, a) < 1e-3 for a, b in zip(s0, s1))


@pytest.mark.parametrize("arch", ["dbrx-132b", "grok-1-314b"])
def test_moe_prefill_and_decode_on_card_match_cpu(cuda, arch):
    """A 2-layer MoE smoke model (head dim 64, which the kernel takes) in
    f32: prefill through B4 (grok: soft-capped) and 3 decode steps on the
    card against the same on the CPU (plain versions), logits within 1e-3
    relative L2, the aux loss within 1e-5."""
    import dataclasses
    from repro_torch.configs import ARCHS, smoke
    from repro_torch.models import decoder_lm as M
    cfg = dataclasses.replace(smoke(ARCHS[arch]), num_layers=2, head_dim=64)
    cpu = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    card = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu"
                         ).to(cuda)
    toks = torch.randint(0, cfg.vocab_size, (3, 40),
                         generator=torch.Generator().manual_seed(1))
    out = {}
    for dev, model in (("cpu", cpu), ("cuda", card)):
        before = flash_attention.launches
        t = toks.to(dev)
        logits, aux = M.forward(cfg, model, t)
        last, cache = M.prefill_step(cfg, model, t, length=43)
        steps = []
        tok = last.argmax(-1, keepdim=True).cpu()
        for pos in range(40, 43):
            lg, cache = M.decode_step(cfg, model, cache, tok.to(dev), pos)
            steps.append(lg[:, 0].cpu())
        out[dev] = (logits.cpu(), aux.cpu(), last.cpu(), steps)
        assert flash_attention.launches - before == (4 if dev == "cuda"
                                                     else 0)

    def rel(a, b):
        return float((a - b).norm() / b.norm())
    (l0, a0, p0, s0), (l1, a1, p1, s1) = out["cpu"], out["cuda"]
    assert rel(l1, l0) < 1e-3 and rel(p1, p0) < 1e-3
    assert all(rel(b, a) < 1e-3 for a, b in zip(s0, s1))
    torch.testing.assert_close(a1, a0, rtol=1e-5, atol=0)


@pytest.mark.parametrize("arch", ["dbrx-132b", "grok-1-314b",
                                  "recurrentgemma-9b", "whisper-small",
                                  "llama-3.2-vision-11b"])
def test_serve_lm_smoke_cli_on_card(cuda, arch):
    """`launch.serve --arch ... --smoke` on the card by default, at
    smoke()'s head dim 32 (B4's f32 instance for it)."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
         "--smoke", "--tokens", "40", "--batch", "2"], cwd=root,
        env=dict(os.environ, PYTHONPATH="src"), capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert f"[serve-lm] {arch} on cuda" in out.stdout
    assert "decode 39 steps" in out.stdout


def test_lm_kernels_refuse_bad_operands_on_cuda(cuda):
    x = torch.zeros((2, 128, 1, 32), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(x, x, x)        # hd 32 has an f32 instance only
    x = torch.zeros((2, 128, 1, 48), device=cuda)
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


def test_training_steps_on_card_match_cpu(cuda):
    """20 AdamW steps of the base loss (dropout 0) on the card and on the
    CPU from the same heads: losses within 1e-4 relative (TF32 off), test
    predictions equal on >= 99% of nodes."""
    from repro_torch.core.inception_distill import hard_ce
    from repro_torch.gnn.distill import DistillConfig, _fit, _tc
    from repro_torch.gnn.graph import propagated_series
    g = load_dataset("pubmed-like", scale=0.1, seed=0)
    cfg = GNNConfig("sgc", g.features.shape[1], g.num_classes, k=4,
                    hidden=64, mlp_layers=2, dropout=0.0)
    series = np.stack(propagated_series(g.train_subgraph(), g.features,
                                        cfg.k))
    full = torch.from_numpy(np.stack(propagated_series(g, g.features,
                                                       cfg.k))[:, g.test_idx])
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for dev in (torch.device("cpu"), cuda):
        head = init_classifiers(cfg, torch.Generator().manual_seed(0),
                                device=dev).head(cfg.k)
        fv = torch.from_numpy(series[:, g.train_idx]).to(dev)
        y = torch.from_numpy(g.labels[g.train_idx]).long().to(dev)
        hist = []

        def loss_fn(h, rng):
            loss = hard_ce(h(fv, generator=rng), y)
            hist.append(loss.detach())
            return loss

        _fit(loss_fn, head, 20, _tc(DistillConfig()),
             torch.Generator(dev).manual_seed(0))
        with torch.no_grad():
            pred = head(full.to(dev)).argmax(-1).cpu().numpy()
        out[dev.type] = (np.array([float(v) for v in hist]), pred)
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-4)
    assert (out["cuda"][1] == out["cpu"][1]).mean() >= 0.99


def test_train_nai_on_card(cuda):
    """train_nai on the card, with dropout masks from a CUDA generator:
    finite losses, every order far above chance, and the trained heads
    serve through the compiled engine."""
    from repro_torch.gnn import (DistillConfig, evaluate_classifier,
                                 train_nai)
    from repro_torch.gnn.graph import propagated_series
    g = load_dataset("pubmed-like", scale=0.1, seed=0)
    cfg = GNNConfig("sgc", g.features.shape[1], g.num_classes, k=4,
                    hidden=64, mlp_layers=2, dropout=0.1)
    model, info = train_nai(cfg, g, DistillConfig(
        epochs_base=60, epochs_offline=30, epochs_online=30), device=cuda)
    assert next(model.parameters()).device.type == "cuda"
    assert all(np.isfinite(v) for v in info.values())
    series = np.stack(propagated_series(g, g.features, cfg.k))
    for l in range(1, cfg.k + 1):
        acc = evaluate_classifier(cfg, model, series, g.labels, g.test_idx,
                                  l)
        assert acc > 1.5 / cfg.num_classes, (l, acc)
    nai = NAIConfig(t_s=20.0, t_min=1, t_max=3, batch_size=100)
    eng = NAIServingEngine(cfg, nai, model, g, device=cuda, mode="compiled",
                           spmm_impl="fused", max_wait_s=10.0)
    eng.submit(g.test_idx[:200])
    stats = eng.run_until_drained()
    assert stats.served == 200 and stats.failed == 0


def test_spmm_ops_on_card(cuda):
    """`kernels/spmm/ops.spmm` launches B1 on CUDA tensors and equals its
    plain version on the CPU."""
    from repro_torch.kernels.spmm import (active_blocks_from_nodes,
                                          build_block_ell, pad_features,
                                          spmm)
    rng = np.random.default_rng(0)
    n, E = 700, 4000
    src = rng.integers(0, n, E).astype(np.int32)
    dst = rng.integers(0, n, E).astype(np.int32)
    uk = np.unique(dst.astype(np.int64) * n + src)
    dst, src = (uk // n).astype(np.int32), (uk % n).astype(np.int32)
    ell = build_block_ell(src, dst, rng.random(len(src)).astype(np.float32),
                          n)
    x = torch.from_numpy(pad_features(
        rng.standard_normal((n, 300)).astype(np.float32), ell.n_pad))
    active = active_blocks_from_nodes(torch.from_numpy(rng.random(n) < 0.5),
                                      ell.n_pad)
    before = spmm_block_ell.launches
    got = spmm(ell, x.to(cuda), active.to(cuda))
    assert spmm_block_ell.launches == before + 1
    torch.testing.assert_close(got.cpu(), spmm(ell, x, active), **TOL)


def test_watchdog_on_a_real_cuda_event(cuda):
    """The engine's watchdog polls a real CUDA event that has not fired
    (the card spins for about a second) and declares the batch hung
    within its deadline plus 50 ms, without waiting on the event."""
    import time
    from repro_torch.serving import WatchdogTimeout
    from repro_torch.serving.engine import _Inflight
    g = load_dataset("pubmed-like", scale=0.02, seed=4)
    cfg = GNNConfig("sgc", g.features.shape[1], g.num_classes, k=2)
    nai = NAIConfig(t_s=6.0, t_min=1, t_max=2, batch_size=8)
    heads = init_classifiers(cfg, torch.Generator().manual_seed(0),
                             device=cuda)
    eng = NAIServingEngine(cfg, nai, heads, g, device=cuda, mode="compiled",
                           spmm_impl="fused", watchdog_s=0.05)
    torch.cuda._sleep(int(2e9))
    ev = torch.cuda.Event()
    ev.record()
    t0 = time.perf_counter()
    fl = _Inflight([], np.zeros(0, np.int64), 0, None, None, ev, 0.0, 0.0,
                   t_submit=t0)
    with pytest.raises(WatchdogTimeout):
        eng._watchdog_sync(fl)
    took = time.perf_counter() - t0
    assert 0.05 <= took < 0.1 and not ev.query()
    ev.synchronize()


def test_hang_and_nan_faults_on_card(cuda):
    """Injected faults on the card: the hung batch (watchdog) and the
    poisoned batch (NaN guard) fail alone; every other batch equals a
    fault-free run's; with retry_failed they complete on the host path."""
    from repro_torch.serving import FaultPlan, FaultSpec
    g = load_dataset("pubmed-like", scale=0.1, seed=0)
    cfg = GNNConfig("sgc", g.features.shape[1], g.num_classes, k=4,
                    hidden=64, mlp_layers=2)
    nai = NAIConfig(t_s=20.0, t_min=1, t_max=3, batch_size=50)
    heads = init_classifiers(cfg, torch.Generator().manual_seed(0),
                             device=cuda)
    nodes = np.random.default_rng(0).choice(g.test_idx, size=300,
                                            replace=False)

    def serve(**kw):
        eng = NAIServingEngine(cfg, nai, heads, g, device=cuda,
                               mode="compiled", spmm_impl="fused",
                               pipeline_depth=2, max_wait_s=10.0, **kw)
        done = []
        for i in range(0, len(nodes), 50):
            eng.submit(nodes[i:i + 50])
            done += eng.step()
        return done + eng.flush()

    plan = FaultPlan([FaultSpec("nan", at=(1,)), FaultSpec("hang", at=(3,))])
    clean = serve()
    hit = serve(faults=plan, watchdog_s=0.5)
    errs = {r.error.split(":")[0] for r in hit if r.status == "failed"}
    assert errs == {"NaNGuardError", "WatchdogTimeout"}
    bad = {int(n) for n in nodes[50:100]} | {int(n) for n in nodes[200:250]}
    for a, b in zip(clean, hit):
        assert a.node_id == b.node_id
        assert (b.status == "failed") == (b.node_id in bad)
        if b.status == "completed":
            assert (a.prediction, a.exit_order) == (b.prediction,
                                                    b.exit_order)
    retried = serve(faults=plan, watchdog_s=0.5, retry_failed=True)
    assert all(r.status == "completed" for r in retried)
    assert sum(r.retried for r in retried) == 100


def _full_graph_pack(impl):
    from repro_torch.gnn.backends import pack_operands
    from repro_torch.gnn.distributed import pack_graph
    from repro_torch.gnn.packing import step_active_blocks
    from repro_torch.gnn.store import make_graph
    store = make_graph(3000, avg_deg=8.0, alpha=2.2, seed=3, path=None,
                       feat_dim=200, num_classes=5)
    be, packed = pack_graph(store, 1, 0.5, impl, stationary=True)
    sa = step_active_blocks(packed.hop_rb, 3)
    ops = pack_operands(be, packed, sa)
    if be.uses_dense_x_inf:
        ops["x_inf"] = packed.x_inf
    return store, be, packed, ops


@pytest.mark.parametrize("impl", ["block_ell", "fused"])
def test_superstep_chain_equals_loop_on_card(cuda, impl):
    """A chain of supersteps (flags recomputed from x) equals the
    single-dispatch NAP loop (flags carried by the kernels) bit for bit
    on the card, through B1 + B3 or B2."""
    from repro_torch.gnn.backends import make_superstep, run_propagation
    from repro_torch.launch.full_graph_infer import \
        first_step_distance_quantile
    store, be, packed, ops = _full_graph_pack(impl)
    nai = NAIConfig(t_s=first_step_distance_quantile(store, 0.5, 0.5),
                    t_min=1, t_max=3)
    eo_loop, series = run_propagation(be, nai, dict(ops), packed.x0,
                                      packed.n_batch, device=cuda)
    step = make_superstep(be, nai, n_batch=packed.n_batch,
                          n_rows=packed.n_pad, device=cuda)
    before = {k.__name__: k.launches
              for k in (spmm_block_ell, nap_exit, nap_step_fused)}
    x = torch.from_numpy(packed.x0).to(cuda)
    eo = torch.zeros(packed.n_batch, dtype=torch.int32, device=cuda)
    for l in range(1, 4):
        x, eo = step(ops, x, eo, l)
        assert torch.equal(x[:packed.n_batch], series[l]), l
    assert torch.equal(torch.where(eo == 0, 3, eo), eo_loop)
    assert set(eo_loop.tolist()) == {1, 2, 3}
    kernel = nap_step_fused if impl == "fused" else spmm_block_ell
    assert kernel.launches - before[kernel.__name__] == 3


@pytest.mark.parametrize("impl", ["block_ell", "fused"])
def test_offline_resume_equals_uninterrupted_on_card(cuda, impl, tmp_path):
    from repro_torch.gnn import init_classifiers as init
    from repro_torch.launch.full_graph_infer import (OfflineConfig,
                                                     PreemptionSimulated,
                                                     run_full_graph_infer)
    store, *_ = _full_graph_pack(impl)
    cfg = GNNConfig("sgc", 200, 5, k=3, hidden=32)
    heads = init(cfg, torch.Generator().manual_seed(0), device=cuda)
    nai = NAIConfig(t_s=5.0, t_min=1, t_max=3)

    def run(ck, **kw):
        return run_full_graph_infer(store, cfg, heads, nai, OfflineConfig(
            ckpt_dir=str(tmp_path / ck), spmm_impl=impl, device="cuda",
            watchdog_s=5.0, **kw))

    ref = run("clean")
    for k in range(3):
        with pytest.raises(PreemptionSimulated):
            run(f"k{k}", crash_after=k)
        res = run(f"k{k}")
        assert res.stats["resumed_from"] == k
        np.testing.assert_array_equal(res.predictions, ref.predictions)
        np.testing.assert_array_equal(res.exit_orders, ref.exit_orders)


@pytest.mark.parametrize("impl", ["block_ell", "fused"])
@pytest.mark.parametrize("D,gather_mode", [(2, "dense"), (2, "halo"),
                                           (2, "alltoall"), (4, "halo"),
                                           (4, "alltoall")])
def test_sharded_propagation_bitwise_on_card(cuda, impl, D, gather_mode):
    """D shards on the one card (a mesh that repeats cuda:0): B1 + B3 or
    B2 per shard, on its tiles and the frontier it gathers, equal the
    single-device loop on the card bit for bit — also with NaN, +Inf and
    -Inf planted in a row of shard 1 that shard 0 reads, which reaches
    shard 0's kernels through the exchanged flags; each kernel launched D
    times per step."""
    from repro_torch.gnn.backends import run_propagation
    from repro_torch.gnn.packing import shard_batch_perm
    from repro_torch.launch.mesh import make_serving_mesh
    g = load_dataset("pubmed-like", scale=0.1, seed=0)
    nai = NAIConfig(t_s=20.0, t_min=1, t_max=3)
    be, base, sh = sharded_pack_pair(g, impl, D, gather_mode,
                                     batch_size=64, seed=2, t_max=3)
    mesh = make_serving_mesh(D, devices=(cuda,) * D)
    perm = torch.from_numpy(shard_batch_perm(sh.n_batch, D)).to(cuda)
    kernel = nap_step_fused if impl == "fused" else spmm_block_ell
    for xb, xs in ((base.x0, sh.x0), plant_remote_nonfinite(base, sh)):
        eo1, s1 = run_propagation(be, nai, step_operands(be, base, 3), xb,
                                  base.n_batch, device=cuda)
        before = kernel.launches
        eo2, s2 = run_propagation(be, nai, step_operands(be, sh, 3), xs,
                                  sh.n_batch, mesh=mesh,
                                  gather_mode=gather_mode)
        assert kernel.launches - before == 3 * D
        assert torch.equal(eo2[perm], eo1)
        assert torch.equal(s2[:, perm].view(torch.int32),
                           s1.view(torch.int32))
    assert torch.isnan(s1).any() and torch.isinf(s1).any()


@pytest.mark.parametrize("causal,window,cap,bound", [
    (c, w, cap, b) for c, w in ((True, 0), (True, 48), (False, 0))
    for cap in (0.0, 5.0) for b in (False, True)])
def test_flash_attention_f32_hd32_matches_plain(cuda, causal, window, cap,
                                                bound):
    """B4's f32 instance at head dim 32 (the smoke configs') in each of
    its four (cap, bound) instances, causal, banded and not causal,
    against the plain version at the f32 tolerance (rtol 1e-4, atol
    2e-5); with the bound, NaN in the cut keys leaves the bits alone.
    Banded with a bound, the rows that neither the band nor the bound
    leave a key (qpos >= kv_len + window - 1) are not compared: the
    kernel skips their blocks and writes 0, the plain version a uniform
    softmax over -1e30 (the mean of v), and no model reads such a row (a
    causal layer's bound is its true length; the wrapper cuts the padded
    rows)."""
    g = torch.Generator().manual_seed(32 + window + int(cap))
    B, S, H, KV, hd = 2, 256, 4, 2, 32
    q = (3.0 * torch.randn((B, S, H, hd), generator=g)).to(cuda)
    k = (3.0 * torch.randn((B, S, KV, hd), generator=g)).to(cuda)
    v = torch.randn((B, S, KV, hd), generator=g).to(cuda)
    kv_len = 200 if bound else None
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal, window=window,
                          softcap=cap, kv_len=kv_len)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ref = ref_attention(q, k, v, causal=causal, window=window, softcap=cap,
                        kv_len=kv_len)
    rows = kv_len + window - 1 if bound and window else S
    torch.testing.assert_close(out[:, :rows], ref[:, :rows], rtol=1e-4,
                               atol=2e-5)
    if bound:
        k[:, 200:], v[:, 200:] = float("nan"), float("nan")
        again = flash_attention(q, k, v, causal=causal, window=window,
                                softcap=cap, kv_len=kv_len)
        assert torch.equal(again, out)


def _adaptive_granite(layers=4):
    """granite-34b smoke (f32, head dim 32) with exit heads at blocks
    0-2, t_min 0, t_max 2, as the reference's adaptive tests."""
    import dataclasses
    from repro_torch.common import AdaptiveDepthConfig
    from repro_torch.configs import ARCHS, smoke
    return dataclasses.replace(
        smoke(ARCHS["granite-34b"]), num_layers=layers,
        adaptive=AdaptiveDepthConfig(enabled=True, exit_layers=(0, 1, 2),
                                     t_s=0.9, t_min=0, t_max=2))


def _soft_model(cfg, dev):
    """Random weights with wq, wk, wv of every attention and
    cross-attention scaled to a fan-in of d (the initializer takes it
    from the heads axis, so the softmax is near a hard max, where f32
    sums in another order move the gradients by percents), and the
    `xattn` gates set to 1 (at 0 they switch cross-attention off)."""
    from repro_torch.models import decoder_lm as M
    model = M.init_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    with torch.no_grad():
        for p in (*model.layers, *model.encoder):
            for group in ("attn", "xattn"):
                if group in p.defs:
                    p[group]["wq"].mul_((cfg.num_heads / cfg.d_model) ** 0.5)
                    for w in ("wk", "wv"):
                        p[group][w].mul_(
                            (cfg.num_kv_heads / cfg.d_model) ** 0.5)
            for gate in ("gate_attn", "gate_mlp"):
                if gate in p.defs:
                    p[gate].fill_(1.0)
    return model.to(dev)


def test_lm_training_step_on_card_matches_cpu(cuda):
    """One f32 training step of granite smoke with exit heads (loss_fn
    with the inception term through the differentiable path, then the
    in-place AdamW) on the card against the CPU: the loss within 1e-4
    relative, every gradient within 1e-4 relative L2, and so the updated
    parameters (TF32 off)."""
    from repro_torch.common import TrainConfig
    from repro_torch.data import synthetic_stream
    from repro_torch.launch.train import lm_batch
    from repro_torch.models import decoder_lm as M
    from repro_torch.optim import adamw_init, adamw_update_, make_schedule
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _adaptive_granite()
    raw = next(synthetic_stream(0, 4, 64, cfg.vocab_size))
    tc = TrainConfig(learning_rate=3e-3, warmup_steps=0, total_steps=10)
    out = {}
    for dev in (torch.device("cpu"), cuda):
        model = _soft_model(cfg, dev).requires_grad_(True)
        loss, _ = M.loss_fn(cfg, model, lm_batch(cfg, raw, dev))
        loss.backward()
        params = dict(model.named_parameters())
        grads = {k: p.grad.detach().cpu() for k, p in params.items()}
        opt = adamw_init(params, tc)
        adamw_update_({k: p.grad for k, p in params.items()}, opt, params,
                      tc, make_schedule(tc)(opt["count"]))
        out[dev.type] = (float(loss.detach()), grads,
                         {k: p.detach().cpu() for k, p in params.items()})
    (l0, g0, p0), (l1, g1, p1) = out["cpu"], out["cuda"]
    assert abs(l1 - l0) <= 1e-4 * abs(l0)
    for k in g0:
        assert float((g1[k] - g0[k]).norm()) <= 1e-4 * float(g0[k].norm()), k
        assert float((p1[k] - p0[k]).norm()) <= 1e-4 * float(p0[k].norm()), k


def test_adaptive_decode_at_zero_threshold_is_decode_step_on_card(cuda):
    """At t_s = 0 no token exits, and adaptive_decode_step's logits equal
    decode_step's bit for bit on the card (the same layers in the same
    order; the exit heads are computed and not taken)."""
    import dataclasses
    from repro_torch.core.adaptive_depth import adaptive_decode_step
    from repro_torch.models import decoder_lm as M
    cfg = _adaptive_granite()
    cfg = dataclasses.replace(cfg, adaptive=dataclasses.replace(
        cfg.adaptive, t_s=0.0))
    model = _soft_model(cfg, cuda)
    toks = torch.randint(0, cfg.vocab_size, (3, 128),
                         generator=torch.Generator().manual_seed(1)).to(cuda)
    _, c1 = M.prefill_step(cfg, model, toks, length=136)
    _, c2 = M.prefill_step(cfg, model, toks, length=136)
    tok = toks[:, -1:]
    for pos in range(128, 136):
        want, c1 = M.decode_step(cfg, model, c1, tok, pos)
        got, c2, info = adaptive_decode_step(cfg, model, c2, tok, pos)
        assert torch.equal(got, want)
        assert bool((info["exit_block"] == -1).all())
        tok = want[:, 0].argmax(-1, keepdim=True)


@pytest.mark.parametrize("data,model", [(1, 2), (1, 4), (2, 2)])
@pytest.mark.parametrize("kv,dtype", [(2, "float32"), (2, "bfloat16"),
                                      (16, "bfloat16")])
def test_sharded_dense_lm_on_card(cuda, data, model, kv, dtype):
    """A 2-layer mistral-shaped smoke model with 16 query heads of 64 and 2
    KV heads (wk / wv and the decode cache over the head dim) or 16 (the
    cache over KV heads, gemma-7b's layout), placed on a mesh of the card
    repeated: prefill (B4 once per layer and position, on the position's
    heads) and 3 decode steps against the unsharded model on the card,
    the logits within 1e-4 (f32) or 3e-2 (bf16: each position's partial
    products round to bf16 before the f32 all-reduce) relative L2; two
    sharded runs bitwise equal."""
    import dataclasses
    from repro_torch.configs import ARCHS, smoke
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import decoder_lm as M
    from repro_torch.sharding import placement as pl
    from repro_torch.sharding import use_mesh
    cfg = dataclasses.replace(smoke(ARCHS["mistral-large-123b"]),
                              num_layers=2, num_heads=16, num_kv_heads=kv,
                              head_dim=64, dtype=dtype, param_dtype=dtype)
    base = M.init_params(cfg, torch.Generator(cuda).manual_seed(0),
                         device=cuda)
    with torch.no_grad():
        for p in base.layers:
            p["attn"]["wq"].mul_((cfg.num_heads / cfg.d_model) ** 0.5)
            for w in ("wk", "wv"):
                p["attn"][w].mul_((kv / cfg.d_model) ** 0.5)
    toks = torch.randint(0, cfg.vocab_size, (4, 200),
                         generator=torch.Generator().manual_seed(1)).to(cuda)

    def run(params):
        last, cache = M.prefill_step(cfg, params, toks, length=203)
        out = [last]
        for pos in range(200, 203):
            lg, cache = M.decode_step(cfg, params, cache, toks[:, :1], pos)
            out.append(lg[:, 0])
        return out

    want = run(base)
    mesh = make_mesh((cuda,) * (data * model), {"data": data,
                                                "model": model})
    params = pl.shard_params(base, mesh)
    with use_mesh(mesh):
        before = flash_attention.launches
        got = run(params)
        assert flash_attention.launches - before == 2 * data * model
        again = run(params)
    tol = 1e-4 if dtype == "float32" else 3e-2
    for a, b in zip(got, want):
        assert float((a.float() - b.float()).norm() / b.float().norm()) < tol
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("arch", ["dbrx-132b", "grok-1-314b", "rwkv6-3b",
                                  "recurrentgemma-9b"])
def test_sharded_kinds_on_card(cuda, arch):
    """The MoE and recurrent kinds in f32 smoke models (rwkv6-3b with 4
    heads of 64, recurrentgemma-9b with 16 query heads and one KV head, as
    the full model) placed on a (1, 2) mesh of the card repeated: prefill
    (B4 or B5 once per layer that runs it and position, on the position's
    heads) and 3 decode steps against the unsharded model on the card,
    the logits within 1e-4 relative L2; two sharded runs bitwise equal."""
    import dataclasses
    from repro_torch.configs import ARCHS, smoke
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import decoder_lm as M
    from repro_torch.sharding import placement as pl
    from repro_torch.sharding import use_mesh
    kw = {"rwkv6-3b": dict(d_model=256, num_heads=4, num_kv_heads=4),
          "recurrentgemma-9b": dict(num_heads=16)}.get(arch, {})
    cfg = dataclasses.replace(smoke(ARCHS[arch]), **kw)
    base = M.init_params(cfg, torch.Generator(cuda).manual_seed(0),
                         device=cuda)
    toks = torch.randint(0, cfg.vocab_size, (4, 200),
                         generator=torch.Generator().manual_seed(1)).to(cuda)

    def run(params):
        last, cache = M.prefill_step(cfg, params, toks, length=203)
        out = [last]
        for pos in range(200, 203):
            lg, cache = M.decode_step(cfg, params, cache, toks[:, :1], pos)
            out.append(lg[:, 0])
        return out

    want = run(base)
    mesh = make_mesh((cuda,) * 2, {"data": 1, "model": 2})
    params = pl.shard_params(base, mesh)
    kernel = wkv6 if arch == "rwkv6-3b" else flash_attention
    kinds = ("rwkv",) if arch == "rwkv6-3b" else ("attn_moe", "local")
    with use_mesh(mesh):
        before = kernel.launches
        got = run(params)
        assert kernel.launches - before == 2 * sum(
            k in kinds for k in cfg.layer_kinds)
        again = run(params)
    for a, b in zip(got, want):
        assert float((a - b).norm() / b.norm()) < 1e-4
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("case", ["dbrx", "grok", "recurrentgemma"])
@pytest.mark.parametrize("model", [2, 4])
def test_flash_attention_at_per_position_shapes(cuda, case, model):
    """B4 in bf16 at the query and KV heads one mesh position holds at
    model 2 and 4: dbrx-132b / grok-1-314b (48 / 8 heads of 128, causal,
    grok capped at 30) and recurrentgemma-9b (16 query heads of 256 and
    its one KV head whole on every position, banded to its window 2048),
    over 2304 tokens, against the plain version (tolerance as at the
    other bf16 shapes)."""
    H, KV, hd, cap, window = {"dbrx": (48, 8, 128, 0.0, 0),
                              "grok": (48, 8, 128, 30.0, 0),
                              "recurrentgemma": (16, 1, 256, 0.0, 2048)}[case]
    H, KV = H // model, max(KV // model, 1)
    g = torch.Generator().manual_seed(model)
    q, k, v = (torch.randn((2, 2304, h, hd), generator=g).to(
        cuda, torch.bfloat16) for h in (H, KV, KV))
    before = flash_attention.launches
    out = flash_attention(q, k, v, window=window, softcap=cap)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ref = ref_attention(q, k, v, window=window, softcap=cap)
    torch.testing.assert_close(out.float(), ref.float(), rtol=1e-2,
                               atol=1e-2)


@pytest.mark.parametrize("model", [2, 4])
def test_wkv6_at_per_position_shapes(cuda, model):
    """B5 at the rwkv6-3b heads one mesh position holds (40 / model heads
    of 64) over 2048 steps, against the plain version (tolerance as at
    the other shapes)."""
    g = torch.Generator().manual_seed(model)
    B, T, H, hd = 2, 2048, 40 // model, 64
    r, k, v = (torch.randn((B, T, H, hd), generator=g) for _ in range(3))
    logw = torch.clamp(-torch.exp(0.5 * torch.randn((B, T, H, hd),
                                                    generator=g)), min=-5.0)
    u = 0.1 * torch.randn((H, hd), generator=g)
    before = wkv6.launches
    out, state = wkv6_heads(*(t.to(cuda) for t in (r, k, v, logw, u)))
    torch.cuda.synchronize()
    assert wkv6.launches == before + 1
    r_out, r_state = wkv6_heads(r, k, v, logw, u)
    scale = float(max(r_out.abs().max(), r_state.abs().max()))
    tol = dict(rtol=1e-4, atol=max(1e-3, 1e-5 * scale))
    torch.testing.assert_close(out.cpu(), r_out, **tol)
    torch.testing.assert_close(state.cpu(), r_state, **tol)


@pytest.mark.parametrize("case", ["llama-xattn", "whisper-enc",
                                  "whisper-self", "whisper-cross",
                                  "granite"])
@pytest.mark.parametrize("model", [2, 4])
def test_flash_attention_at_per_position_frontend_shapes(cuda, case, model):
    """B4 in bf16 through the GQA wrapper (queries and keys padded to 128,
    the true key length as the bound) at the heads one mesh position
    holds at model 2 and 4: llama-3.2-vision-11b's `xattn` (32 / 8 heads
    of 128 over 1600 image rows, not causal), whisper-small's `enc` (12 /
    12 heads of 64 over 1500 frames, not causal), its `encdec`
    self-attention (224 tokens, causal) and cross-attention (224 queries
    over 1500 frames), and granite-34b's causal MQA prefill (48 / 1 heads
    of 128, the KV head whole on every position); against the plain
    version on the unpadded operands (tolerance as at the other bf16
    shapes)."""
    H, KV, hd, Sq, Sk, causal = {
        "llama-xattn": (32, 8, 128, 2048, 1600, False),
        "whisper-enc": (12, 12, 64, 1500, 1500, False),
        "whisper-self": (12, 12, 64, 224, 224, True),
        "whisper-cross": (12, 12, 64, 224, 1500, False),
        "granite": (48, 1, 128, 2048, 2048, True)}[case]
    H, KV = H // model, max(KV // model, 1)
    g = torch.Generator().manual_seed(model)
    q = torch.randn((2, Sq, H, hd), generator=g).to(cuda, torch.bfloat16)
    k, v = (torch.randn((2, Sk, KV, hd), generator=g).to(
        cuda, torch.bfloat16) for _ in range(2))
    before = flash_attention.launches
    out = gqa_flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1 and out.shape == q.shape
    ref = ref_attention(q, k, v, causal=causal)
    torch.testing.assert_close(out.float(), ref.float(), rtol=1e-2,
                               atol=1e-2)


@pytest.mark.parametrize("case", ["deepseek-6h", "deepseek-8h",
                                  "whisper-6h", "rwkv-m16"])
def test_fallback_placements_on_card(cuda, case):
    """f32 smoke models placed where the heads do not divide "model" (or
    the reference's `_seq_shard` splits the rows, "deepseek-8h") on a
    mesh of the card repeated: prefill of 256 tokens (B4 once per
    attention layer and position on the position's rows, causal ones at
    their first row's offset through the query-offset instances of f32
    head dim 32; B5 once per rwkv layer and position on its (batch row,
    head) pairs) and 3 decode steps against the unsharded model on the
    card, the logits within 1e-4 relative L2; two placed runs bitwise
    equal."""
    import dataclasses
    from repro_torch.configs import ARCHS, smoke
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import decoder_lm as M
    from repro_torch.sharding import placement as pl
    from repro_torch.sharding import use_mesh
    arch, kw, model = {
        "deepseek-6h": ("deepseek-coder-33b",
                        dict(num_heads=6, num_kv_heads=2), 4),
        "deepseek-8h": ("deepseek-coder-33b",
                        dict(num_heads=8, num_kv_heads=2), 4),
        "whisper-6h": ("whisper-small", dict(num_heads=6, num_kv_heads=6),
                       4),
        "rwkv-m16": ("rwkv6-3b", {}, 16)}[case]
    cfg = dataclasses.replace(smoke(ARCHS[arch]), **kw)
    base = _soft_model(cfg, cuda)
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (4, 256), generator=g).to(cuda)
    fe = (torch.randn((4, cfg.encoder_seq, cfg.d_model), generator=g).to(
        cuda) if cfg.is_encdec else None)

    def run(params):
        last, cache = M.prefill_step(cfg, params, toks, frontend=fe,
                                     length=259)
        out = [last]
        for pos in range(256, 259):
            lg, cache = M.decode_step(cfg, params, cache, toks[:, :1], pos)
            out.append(lg[:, 0])
        return out

    want = run(base)
    mesh = make_mesh((cuda,) * model, {"data": 1, "model": model})
    params = pl.shard_params(base, mesh)
    with use_mesh(mesh):
        before = (flash_attention.launches, flash_attention.offset_launches,
                  wkv6.launches)
        got = run(params)
        n = (flash_attention.launches - before[0],
             flash_attention.offset_launches - before[1],
             wkv6.launches - before[2])
        again = run(params)
    layers = cfg.num_layers
    if arch == "rwkv6-3b":
        assert n == (0, 0, layers * model)
    else:
        per = 2 * layers + cfg.encoder_layers if cfg.is_encdec else layers
        assert n == (per * model, layers * (model - 1), 0)
    for a, b in zip(got, want):
        assert float((a - b).norm() / b.norm()) < 1e-4
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "whisper-small"])
def test_sharded_frontend_models_on_card(cuda, arch):
    """The cross-attention and encoder kinds in f32 smoke models placed on
    a (1, 2) mesh of the card repeated: prefill with the frontend (B4
    once per self-, cross- and encoder attention layer and position) and
    3 decode steps against the unsharded model on the card, the logits
    within 1e-4 relative L2; `seed_frontend_cache` equal to the placed
    prefill's xk / xv bit for bit; two sharded runs bitwise equal."""
    from repro_torch.configs import ARCHS, smoke
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import decoder_lm as M
    from repro_torch.sharding import placement as pl
    from repro_torch.sharding import use_mesh
    cfg = smoke(ARCHS[arch])
    base = _soft_model(cfg, cuda)
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (4, 200), generator=g).to(cuda)
    n_fe = cfg.encoder_seq if cfg.is_encdec else cfg.num_image_tokens
    fe = torch.randn((4, n_fe, cfg.d_model), generator=g).to(cuda)

    def run(params):
        last, cache = M.prefill_step(cfg, params, toks, frontend=fe,
                                     length=203)
        out = [last]
        for pos in range(200, 203):
            lg, cache = M.decode_step(cfg, params, cache, toks[:, :1], pos)
            out.append(lg[:, 0])
        return out, cache

    want, _ = run(base)
    mesh = make_mesh((cuda,) * 2, {"data": 1, "model": 2})
    params = pl.shard_params(base, mesh)
    per_layer = (sum(k in ("attn", "xattn") for k in cfg.layer_kinds)
                 + 2 * cfg.layer_kinds.count("encdec") + cfg.encoder_layers)
    with use_mesh(mesh):
        before = flash_attention.launches
        got, cache = run(params)
        assert flash_attention.launches - before == 2 * per_layer
        again, _ = run(params)
        seeded = M.seed_frontend_cache(cfg, params, M.init_cache(
            cfg, 4, 203, cuda), fe)
    for a, b in zip(got, want):
        assert float((a - b).norm() / b.norm()) < 1e-4
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for c, s, kind in zip(cache, seeded, cfg.layer_kinds):
        if kind in ("xattn", "encdec"):
            for n in ("xk", "xv"):
                assert all(torch.equal(x, y) for x, y in zip(
                    c[n].locals, s[n].locals))


def test_placed_adaptive_decode_on_card(cuda):
    """granite-34b smoke with exit heads (its one KV head puts wk / wv's
    "model" onto d) on a (1, 2) mesh of the card: 6 adaptive decode steps
    after a prefill, at t_s 0.6, the exit blocks and the FLOPs share
    equal to the unsharded model's on the card, the logits within 1e-4
    relative L2."""
    import dataclasses
    from repro_torch.core.adaptive_depth import adaptive_decode_step
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import decoder_lm as M
    from repro_torch.sharding import placement as pl
    from repro_torch.sharding import use_mesh
    cfg = _adaptive_granite()
    cfg = dataclasses.replace(cfg, adaptive=dataclasses.replace(
        cfg.adaptive, t_s=0.6))
    model = _soft_model(cfg, cuda)
    toks = torch.randint(0, cfg.vocab_size, (4, 134),
                         generator=torch.Generator().manual_seed(1)).to(cuda)
    mesh = make_mesh((cuda,) * 2, {"data": 1, "model": 2})
    params = pl.shard_params(model, mesh)

    def run(params):
        _, cache = M.prefill_step(cfg, params, toks[:, :128], length=134)
        out = []
        for pos in range(128, 134):
            lg, cache, info = adaptive_decode_step(cfg, params, cache,
                                                   toks[:, pos:pos + 1], pos)
            out.append((lg, info))
        return out

    want = run(model)
    with use_mesh(mesh):
        got = run(params)
    for (a, ia), (b, ib) in zip(got, want):
        # outside the margin around t_s (none of these lanes lies in it)
        assert not bool(((ib["saturation"] - 0.6).abs() <= 6e-5).any())
        assert torch.equal(ia["exit_block"], ib["exit_block"])
        assert float(ia["flops_saved_frac"]) == float(ib["flops_saved_frac"])
        assert float((a - b).norm() / b.norm()) < 1e-4


@pytest.mark.parametrize("arch,meshes", [
    ("granite-34b", ((1, 2), (2, 2))), ("dbrx-132b", ((1, 2), (2, 2))),
    ("rwkv6-3b", ((1, 2), (2, 1))), ("recurrentgemma-9b", ((1, 2), (2, 2))),
    ("whisper-small", ((1, 2), (2, 2)))])
def test_placed_training_step_on_card(cuda, arch, meshes):
    """An f32 training step (TF32 off) of a smoke model placed trainable on
    meshes of the card repeated (granite-34b with exit heads, MoE, rwkv,
    rglru + local, encoder-decoder): the synced gradients and the
    parameters and moments after `lm_train_step` within 1e-4 relative L2
    of the (1, 1) mesh's on the card and of the CPU's; every copy of a
    block bitwise equal; B4 and B5 not launched."""
    import dataclasses
    from repro_torch.configs import ARCHS, smoke
    from repro_torch.data import synthetic_stream
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import lm_batch, lm_train_step
    from repro_torch.common import TrainConfig
    from repro_torch.models import decoder_lm as M
    from repro_torch.optim import adamw_init, make_schedule
    from repro_torch.sharding import placement as pl
    from repro_torch.sharding import use_mesh
    cfg = (_adaptive_granite() if arch == "granite-34b"
           else smoke(ARCHS[arch]))
    raw = next(synthetic_stream(0, 4, 32, cfg.vocab_size, cfg))
    tc = TrainConfig(learning_rate=3e-3, warmup_steps=0, total_steps=10)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    try:
        for run, dev, (data, model_ax) in [
                ("host", torch.device("cpu"), (1, 1)),
                ("card", cuda, (1, 1))] + [("card", cuda, m) for m in meshes]:
            mesh = make_mesh((dev,) * (data * model_ax),
                             {"data": data, "model": model_ax})
            params = pl.shard_params(_soft_model(cfg, dev), mesh,
                                     trainable=True)
            opt = adamw_init(params, tc)
            batch = lm_batch(cfg, raw, dev)
            flash_attention.launches = wkv6.launches = 0
            with use_mesh(mesh):
                loss, _ = M.loss_fn(cfg, params, batch)
                loss.backward()
                grads = pl.sync_grads(params)
                lm_train_step(cfg, params, opt, tc, make_schedule(tc), batch)
            assert flash_attention.launches == wkv6.launches == 0
            assert pl.copies_equal((grads, params, opt["mu"], opt["nu"]))
            out[run, data, model_ax] = {
                f"{k}.{path}": pl.gather(st, "cpu").detach()
                for k, tree in (("g", grads), ("p", params),
                                ("mu", opt["mu"]), ("nu", opt["nu"]))
                for path, st in pl.named_leaves(tree)}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    cpu, one = out.pop(("host", 1, 1)), out.pop(("card", 1, 1))
    for got in [one, *out.values()]:
        for want in (cpu, one):
            for n, w in want.items():
                err = float((got[n] - w).norm())
                assert err <= 1e-4 * float(w.norm()) + 1e-12, (arch, n, err)


@pytest.mark.parametrize("arch", ["granite-34b", "dbrx-132b", "rwkv6-3b",
                                  "whisper-small"])
def test_placed_checkpoint_on_card(cuda, arch, tmp_path):
    """A smoke model placed trainable on a (1, 2) mesh of the card: two
    `build_train_step` steps against one step, a save, a load into a
    fresh placement and the second step: every block of the parameters
    and moments, the count and the second loss bitwise equal; the file
    loaded onto (2, 2) of the card gathers to the file's arrays bit for
    bit, and loaded unplaced onto the CPU equals the gathered state."""
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.configs import ARCHS, smoke
    from repro_torch.data import synthetic_stream
    from repro_torch.launch.dryrun import build_train_step
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import lm_batch
    from repro_torch.optim import adamw_init
    from repro_torch.sharding import placement as pl
    from repro_torch.sharding import use_mesh
    cfg = (_adaptive_granite() if arch == "granite-34b"
           else smoke(ARCHS[arch]))
    stream = synthetic_stream(0, 4, 32, cfg.vocab_size, cfg)
    batches = [lm_batch(cfg, next(stream), cuda) for _ in range(2)]
    step, tc = build_train_step(cfg, learning_rate=3e-3, warmup_steps=0,
                                total_steps=10)

    def mesh_of(data, model_ax):
        return make_mesh((cuda,) * (data * model_ax),
                         {"data": data, "model": model_ax})
    mesh = mesh_of(1, 2)

    def placed(on):
        params = pl.shard_params(_soft_model(cfg, cuda), on, trainable=True)
        return {"params": params, "opt": adamw_init(params, tc)}

    def run(state, steps):
        with use_mesh(mesh):
            return [float(step(state["params"], state["opt"],
                               batches[i])[2]["loss"]) for i in steps]

    def leaves(state):
        return [(f"{k}.{p}", st) for k, tree in (
            ("params", state["params"]), ("mu", state["opt"]["mu"]),
            ("nu", state["opt"]["nu"])) for p, st in pl.named_leaves(tree)]
    whole = placed(mesh)
    want_losses = run(whole, range(2))
    cut = placed(mesh)
    run(cut, range(1))
    path = str(tmp_path / "state.ckpt")
    save_checkpoint(path, cut, 1)
    got, at = load_checkpoint(path, placed(mesh))
    assert at == 1 and run(got, range(1, 2)) == want_losses[1:]
    assert torch.equal(got["opt"]["count"], whole["opt"]["count"])
    for (n, a), (_, b) in zip(leaves(whole), leaves(got)):
        assert a.spec == b.spec and all(
            torch.equal(x, y) for x, y in zip(a.locals, b.locals)), n
    saved = dict(leaves(cut))
    moved, _ = load_checkpoint(path, placed(mesh_of(2, 2)))
    plain, _ = load_checkpoint(path, _unplaced_like(cut))
    for n, st in leaves(moved):
        want = pl.gather(saved[n], "cpu")
        assert torch.equal(pl.gather(st, "cpu"), want), n
        assert st.locals[0].requires_grad == n.startswith("params."), n
    for n, t in dict(_unplaced_leaves(plain)).items():
        assert t.device.type == "cpu" and torch.equal(
            t, pl.gather(saved[n], "cpu")), n


def _unplaced_like(state):
    """The unplaced CPU tree of a placed training state's shapes."""
    from repro_torch.sharding import placement as pl

    def like(t):
        if isinstance(t, dict):
            return {k: like(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [like(v) for v in t]
        if pl.is_sharded(t):
            return torch.empty(t.shape, dtype=t.dtype)
        return t.cpu()
    return like(state)


def _unplaced_leaves(state):
    """(path, tensor) of an unplaced training state's parameters and
    moments, named as `test_placed_checkpoint_on_card` names them."""
    from repro_torch.sharding import placement as pl
    return [(f"{k}.{p}", t) for k, tree in (
        ("params", state["params"]), ("mu", state["opt"]["mu"]),
        ("nu", state["opt"]["nu"])) for p, t in pl.named_leaves(tree)]


@pytest.mark.parametrize("depth", [1, 2])
def test_copy_stream_engine_on_card(cuda, depth):
    """The engine's host-to-device copies run on its copy stream (one for
    the card), the compute stream waits on the event recorded after them,
    and the pageable `step_active` goes through a pinned staging buffer:
    fused == block_ell bit for bit and every backend equals the host path
    outside the threshold margin, at pipeline depth 1 and 2; a third pass
    adds no shape key and no pack allocation."""
    g = load_dataset("pubmed-like", scale=0.1, seed=0)
    cfg = GNNConfig("sgc", g.features.shape[1], g.num_classes, k=4,
                    hidden=64, mlp_layers=2)
    nai = NAIConfig(t_s=20.0, t_min=1, t_max=3, batch_size=100)
    heads = init_classifiers(cfg, torch.Generator().manual_seed(0),
                             device=cuda)
    nodes = np.random.default_rng(0).choice(g.test_idx, size=300,
                                            replace=False)
    host = _serve_all(NAIServingEngine(cfg, nai, heads, g, device=cuda,
                                       max_wait_s=10.0, mode="host"), nodes)
    res = {}
    for impl in ("segment", "block_ell", "fused"):
        eng = NAIServingEngine(cfg, nai, heads, g, device=cuda,
                               max_wait_s=10.0, mode="compiled",
                               spmm_impl=impl, pipeline_depth=depth)
        assert len(eng._copy_streams) == 1
        copy = next(iter(eng._copy_streams.values()))
        assert copy != torch.cuda.current_stream(cuda)
        for _ in range(2):
            res[impl] = _serve_all(eng, nodes)
        c0, a0 = eng.jit_stats["compiles"], eng.pack_stats["allocs"]
        assert _serve_all(eng, nodes)[0].tolist() == res[impl][0].tolist()
        assert (eng.jit_stats["compiles"], eng.pack_stats["allocs"]) == \
            (c0, a0)
        assert eng.jit_cache_size() == c0
        if impl != "segment":
            assert eng._staged and all(t.is_pinned()
                                       for t in eng._staged.values())
    for a, b in zip(res["fused"], res["block_ell"]):
        np.testing.assert_array_equal(a, b)
    near = near_threshold(decision_distances, cfg, nai, g, nodes, 100)
    for impl, (p, o) in res.items():
        assert_orders_match(p, o, *host, near)


def test_copy_stream_on_a_mesh_of_the_card(cuda):
    """D = 2 shards on the card repeated: one copy stream for the one
    device, and fused serving bitwise equal to one device."""
    from repro_torch.launch.mesh import make_serving_mesh
    g = load_dataset("pubmed-like", scale=0.1, seed=0)
    cfg = GNNConfig("sgc", g.features.shape[1], g.num_classes, k=4,
                    hidden=64, mlp_layers=2)
    nai = NAIConfig(t_s=20.0, t_min=1, t_max=3, batch_size=100)
    heads = init_classifiers(cfg, torch.Generator().manual_seed(0),
                             device=cuda)
    nodes = np.random.default_rng(0).choice(g.test_idx, size=300,
                                            replace=False)
    one = _serve_all(NAIServingEngine(cfg, nai, heads, g, device=cuda,
                                      max_wait_s=10.0, mode="compiled",
                                      spmm_impl="fused", pipeline_depth=2),
                     nodes)
    eng = NAIServingEngine(cfg, nai, heads, g, max_wait_s=10.0,
                           mode="compiled", spmm_impl="fused",
                           pipeline_depth=2, gather_mode="halo",
                           mesh=make_serving_mesh(2, devices=(cuda,) * 2))
    assert len(eng._copy_streams) == 1
    for a, b in zip(_serve_all(eng, nodes), one):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch,axes", [
    ("mistral-large-123b", {"data": 2, "model": 2}),
    ("gemma-7b", {"pod": 2, "data": 2, "model": 2}),
    ("rwkv6-3b", {"data": 2, "model": 2}),
    ("dbrx-132b", {"pod": 2, "data": 2, "model": 1})])
def test_batch_one_and_multi_pod_on_card(cuda, arch, axes):
    """f32 smoke models on meshes of the card repeated: a batch of one
    (the split-key decode over "data" or "pod", gemma's head dim over
    "data", rwkv's state over its key and value dims) and dbrx's MoE with
    a batch of 4 over ("pod", "data"), prefill and 3 decode steps against
    the unplaced model on the card within 1e-4 relative L2, two placed
    runs bitwise equal."""
    import dataclasses
    from repro_torch.configs import ARCHS, smoke
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import decoder_lm as M
    from repro_torch.sharding import placement as pl
    from repro_torch.sharding import use_mesh
    kw = {"gemma-7b": dict(num_heads=16, num_kv_heads=16),
          "rwkv6-3b": dict(d_model=192),
          "dbrx-132b": {}}.get(arch, dict(num_kv_heads=1))
    cfg = dataclasses.replace(smoke(ARCHS[arch]), **kw)
    base = M.init_params(cfg, torch.Generator(cuda).manual_seed(0),
                         device=cuda)
    B = 4 if arch == "dbrx-132b" else 1
    toks = torch.randint(0, cfg.vocab_size, (B, 200),
                         generator=torch.Generator().manual_seed(1)).to(cuda)

    def run(params):
        last, cache = M.prefill_step(cfg, params, toks, length=256)
        out = [last]
        for pos in range(200, 203):
            lg, cache = M.decode_step(cfg, params, cache, toks[:, :1], pos)
            out.append(lg[:, 0])
        return out

    want = run(base)
    n = int(np.prod(list(axes.values())))
    mesh = make_mesh((cuda,) * n, axes)
    params = pl.shard_params(base, mesh)
    with use_mesh(mesh):
        got = run(params)
        again = run(params)
    for a, b in zip(got, want):
        assert float((a - b).norm() / b.norm()) < 1e-4
    assert all(torch.equal(a, b) for a, b in zip(got, again))


# ------------------------------------------------ the device sampler
def _arxiv_engines(cuda, **kw):
    """arxiv-like at scale 0.05 with SGC heads: the plain engine and the
    given variant, each over its own store."""
    from repro_torch.gnn.store import InMemoryStore
    g = load_dataset("arxiv-like", scale=0.05, seed=0)
    cfg = GNNConfig("sgc", g.features.shape[1], g.num_classes, k=3,
                    mlp_layers=1)
    # about the median first-step distance: both orders exit
    nai = NAIConfig(t_s=10.0, t_min=1, t_max=2, batch_size=500)
    heads = init_classifiers(cfg, torch.Generator().manual_seed(0),
                             device=cuda)
    return g, cfg, nai, [
        NAIServingEngine(cfg, nai, heads, InMemoryStore(g), device=cuda,
                         max_wait_s=10.0, mode="compiled",
                         spmm_impl="segment", pipeline_depth=2, **extra)
        for extra in ({}, kw)]


@pytest.mark.parametrize("hops,r", [(2, 0.5), (3, 0.5), (2, 0.3)])
def test_device_sampler_on_card(cuda, hops, r):
    """The device sampler on the card: array-equal to the numpy sampler
    for batches of 500, also after a mutation of the store."""
    from repro_torch.gnn.device_sampler import DeviceSampler
    from repro_torch.gnn.sampler import sample_support
    from repro_torch.gnn.store import InMemoryStore
    g = load_dataset("arxiv-like", scale=0.05, seed=0)
    store = InMemoryStore(g)
    sampler = DeviceSampler(store, r, cuda)
    rng = np.random.default_rng(hops)
    for rnd in range(3):
        if rnd == 2:
            src = rng.choice(g.test_idx, size=16, replace=False)
            store.add_edges(src, (src + 1) % g.n)
            store.add_nodes(np.ones((4, g.features.shape[1]), np.float32))
        batch = rng.choice(g.test_idx, size=500, replace=False)
        got = sampler.sample(batch, hops)
        want = sample_support(store, batch, hops, r)
        for k in ("nodes", "hop", "src", "dst", "coef"):
            a, b = getattr(got, k), getattr(want, k)
            assert a.dtype == b.dtype, k
            np.testing.assert_array_equal(a, b, err_msg=k)
        assert (got.n_batch, got.sub_edges, got.graph_version) == \
            (want.n_batch, want.sub_edges, want.graph_version)
    assert sampler._version == (store.mutation_clock, store.n)


def test_engine_sampler_choice_on_card(cuda):
    """A plain CUDA engine samples every batch on the card, a cached one
    every batch on the host; their predictions and exit orders agree
    outside the threshold margin (the cache never fills here, so both
    propagate the same support)."""
    g, cfg, nai, (plain, cached) = _arxiv_engines(
        cuda, cache_nodes=4096, cache_fill=False)
    rng = np.random.default_rng(5)
    batches = [rng.choice(g.test_idx, size=500, replace=False)
               for _ in range(3)]
    for nodes in batches:
        pp, op = _serve_all(plain, nodes)
        pc, oc = _serve_all(cached, nodes)
        near = near_threshold(decision_distances, cfg, nai, g, nodes, 500)
        assert_orders_match(pp, op, pc, oc, near)
        assert set(op) == {1, 2}
    assert plain.sample_stats == {"device": 3, "host": 0}
    assert cached.sample_stats == {"device": 0, "host": 3}
    assert plain.pack_place == {"device": 3, "host": 0}
    assert cached.pack_place == {"device": 0, "host": 3}
    plain.reset_stats()
    assert plain.sample_stats == {"device": 0, "host": 0}
    assert plain.pack_place == {"device": 0, "host": 0}


# ------------------------------------------------ the device packer
@pytest.mark.parametrize("r", [0.5, 0.3])
def test_device_pack_on_card(cuda, r):
    """The segment operands built on the card equal the host path's on the
    same support: x0, src, dst, coef and c_inf bit for bit, s_inf and
    x_inf within one float32 ulp (CUDA sums s in a tree), s in float64
    within 1e-11 of the terms' magnitudes of the host's; also for a
    refilled set and after a mutation of the store."""
    from repro_torch.gnn.device_packing import pack_support_device
    from repro_torch.gnn.device_sampler import DeviceSampler
    from repro_torch.gnn.nai import support_stationary_factors
    from repro_torch.gnn.store import InMemoryStore
    from test_torch_device_packing import assert_same_pack, host_pack
    g = load_dataset("arxiv-like", scale=0.05, seed=0)
    store = InMemoryStore(g)
    sampler = DeviceSampler(store, r, cuda)
    rng = np.random.default_rng(3)
    packed, hwm = None, dict(s_bucket=0, e_bucket=0)
    for rnd in range(3):
        if rnd == 2:
            src = rng.choice(g.test_idx, size=16, replace=False)
            new = store.add_nodes(rng.standard_normal(
                (4, g.features.shape[1])).astype(np.float32))
            store.add_edges(new, src[:4])
        batch = rng.choice(g.test_idx, size=500 - rnd, replace=False)
        tables = sampler.feature_tables()
        dsup = sampler.sample_device(batch, 2)
        sup = sampler.sample(batch, 2)
        want = host_pack(store, sup, r, nb_bucket=512, **hwm)
        # the last round packs twice: the second refills the first's set
        for again in range(1 + (rnd == 2)):
            packed = pack_support_device(dsup, tables, nb_bucket=512,
                                         out=packed, **hwm)
            torch.cuda.synchronize()
            assert packed.x0.device.type == cuda.type
            assert_same_pack(packed, want,
                             equal=("x0", "src", "dst", "coef", "c_inf"),
                             ulp=("s_inf", "x_inf"))
        hwm = dict(s_bucket=want.n_pad, e_bucket=want.src.shape[0])
        x0 = store.gather_features(sup.nodes)
        _, s_host = support_stationary_factors(store, sup, x0, r)
        s_card = (tables.w[dsup.nodes][:, None]
                  * tables.features[dsup.nodes]).sum(0).cpu().numpy()
        # another order of the same float64 sum: ~n eps of the sum of
        # the terms' magnitudes apart
        w = (np.asarray(store.degrees[sup.nodes]) + 1.0) ** (1.0 - r)
        scale = (w[:, None] * np.abs(x0)).sum(0)
        np.testing.assert_array_less(np.abs(s_card - s_host),
                                     1e-11 * scale + 1e-300)
    assert packed.reused
    assert len(sampler.feature_tables().features) == store.n


def test_device_tables_that_do_not_fit_on_card(cuda, monkeypatch):
    """With too little free device memory for the feature tables the
    segment engine packs on the host, and serves as before."""
    g, cfg, nai, (plain, tight) = _arxiv_engines(cuda)
    free, total = torch.cuda.mem_get_info(cuda)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda *a: (1 << 20, total))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda *a: 0)
    assert tight._device_sampler.feature_tables() is None
    nodes = np.random.default_rng(4).choice(g.test_idx, size=1000,
                                            replace=False)
    pt, ot = _serve_all(tight, nodes)
    monkeypatch.undo()
    pp, op = _serve_all(plain, nodes)
    near = near_threshold(decision_distances, cfg, nai, g, nodes, 500)
    assert_orders_match(pp, op, pt, ot, near)
    assert tight.pack_place == {"device": 0, "host": 2}
    assert tight.sample_stats == {"device": 2, "host": 0}
    assert plain.pack_place == {"device": 2, "host": 0}


def test_device_pack_pool_in_flight_on_card(cuda):
    """Depth 2 over twice as many batches as the device pool has sets
    (a set is refilled while later batches are in flight) serves what
    depth 1 and the host-packed path serve, outside the threshold margin
    (segment sums with atomics)."""
    g, cfg, nai, (deep, host) = _arxiv_engines(cuda)
    host._device_sampler = None       # numpy sampler, host pack
    serial = NAIServingEngine(cfg, nai, deep.classifiers, deep.store,
                              device=cuda, max_wait_s=10.0, mode="compiled",
                              spmm_impl="segment", pipeline_depth=1)
    rng = np.random.default_rng(9)
    nodes = np.concatenate([rng.choice(g.test_idx, size=500, replace=False)
                            for _ in range(6)])
    pd, od = _serve_all(deep, nodes)
    ps, os_ = _serve_all(serial, nodes)
    ph, oh = _serve_all(host, nodes)
    near = near_threshold(decision_distances, cfg, nai, g, nodes, 500)
    assert_orders_match(pd, od, ps, os_, near)
    assert_orders_match(pd, od, ph, oh, near)
    assert deep.pack_place == {"device": 6, "host": 0}
    assert serial.pack_place == {"device": 6, "host": 0}
    assert host.pack_place == {"device": 0, "host": 6}
    assert [len(ring) for ring in deep._device_pool.values()] == [3]
