"""The port's production-mesh dry run (`repro_torch.launch.dryrun`,
`launch.cost_analysis`, `launch.roofline`, `launch.mesh`'s
`make_production_mesh`, `common.types`' `MeshConfig` and `H100_SXM`)
against the JAX package's (`repro.launch`): the model flops and active
parameters of every config and shape; the counted matmul flops of a
chain of products and of a smoke model's forward against the reference
HLO analyzer's; the linear extrapolation over repeats against direct
counts; the peak of live bytes; the abstract bytes a position against a
real placement's; B4's and B5's `cost()` against `PERF.md`'s bounds and
their `meta` outputs against the plain versions'; `lower_combo` on a
16 x 16 mesh of `meta` devices; long_500k's cache layouts on both
production meshes; and `main`'s files, skips and exit code.
Nothing here allocates a full-size tensor: full configs run on `meta`."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.common import INPUT_SHAPES as JAX_SHAPES
from repro.common import MeshConfig as JaxMeshConfig
from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import smoke as jax_smoke
from repro.launch import roofline as jax_roofline
from repro.launch.hlo_analysis import analyze as jax_analyze
from repro.models import decoder_lm as JM
from repro.nn.params import count_params as jax_count_params
from repro_torch.common import (H100_SXM, INPUT_SHAPES, MeshConfig,
                                ShapeConfig)
from repro_torch.configs import ARCHS, smoke
from repro_torch.kernels.flash_attention import cost as b4_cost
from repro_torch.kernels.flash_attention import flash_attention, ref_attention
from repro_torch.kernels.wkv6 import cost as b5_cost
from repro_torch.kernels.wkv6 import ref_wkv6, wkv6, wkv6_heads
from repro_torch.launch import dryrun
from repro_torch.launch.cost_analysis import analyze, extrapolate
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.launch.roofline import (active_params, model_flops,
                                         roofline_terms)
from repro_torch.models import decoder_lm as M
from repro_torch.nn.params import tree_bytes
from repro_torch.sharding import placement as pl
from repro_torch.sharding.logical import P


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_model_flops_and_active_params_match_reference(arch):
    """Parameters, active parameters and MODEL_FLOPS of every shape equal
    the reference's for the full config."""
    cfg, jcfg = ARCHS[arch], JAX_ARCHS[arch]
    n = dryrun._n_params(cfg)
    assert n == jax_count_params(JM.model_defs(jcfg))
    assert active_params(cfg, n) == jax_roofline.active_params(jcfg, n)
    for name, shape in INPUT_SHAPES.items():
        assert model_flops(cfg, shape, n, active_params(cfg, n)) == \
            jax_roofline.model_flops(jcfg, JAX_SHAPES[name], n,
                                     jax_roofline.active_params(jcfg, n))


def test_mesh_config_and_production_mesh():
    """`MeshConfig` as the reference's; `make_production_mesh` of `meta`
    devices 16 x 16 and 2 x 16 x 16, and raising without enough GPUs;
    the H100's data-sheet figures."""
    for mp in (False, True):
        assert MeshConfig(mp).shape == JaxMeshConfig(mp).shape
        assert MeshConfig(mp).axes == JaxMeshConfig(mp).axes
        n = 512 if mp else 256
        mesh = make_production_mesh(multi_pod=mp, devices=("meta",) * n)
        assert mesh.shape == dict(zip(MeshConfig(mp).axes,
                                      MeshConfig(mp).shape))
        assert all(d.type == "meta" for d in mesh.devices)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="GPUs"):
            make_production_mesh()
    assert (H100_SXM.peak_flops, H100_SXM.peak_flops_f32, H100_SXM.hbm_bw,
            H100_SXM.nvlink_bw, H100_SXM.hbm_bytes) == (
        989e12, 67e12, 3.35e12, 450e9, 80e9)


def test_chained_matmuls_count_as_the_reference_hlo():
    """Five chained 64 x 64 products: the reference's loop-aware HLO
    count of its scan (tests/test_infra.py) and the port's count of the
    same products, 5 * 2 * 64^3 each, exactly."""
    def f(x):
        def body(c, _):
            return c @ c, None
        y, _ = jax.lax.scan(body, x, None, length=5)
        return y
    comp = jax.jit(f).lower(jax.ShapeDtypeStruct((64, 64),
                                                 jnp.float32)).compile()
    want = jax_analyze(comp.as_text()).dot_flops

    def g(x):
        for _ in range(5):
            x = x @ x
        return x
    st = analyze(g, _meta(64, 64))
    assert st.dot_flops == want == 5 * 2 * 64 ** 3
    # each product's result written once and read once, the argument once
    assert st.traffic_bytes == 5 * 2 * 64 * 64 * 4 + 64 * 64 * 4
    assert st.collective_total == 0


def test_smoke_forward_counts_the_reference_dot_flops():
    """gemma-7b smoke, B 2 x S 128: the port's differentiable forward
    (`_sdpa`-style einsums over every query-key pair, as the reference's
    `_sdpa` under its mask) counts the reference analyzer's dot flops on
    the jitted forward exactly; the kernel path (B4's `cost()`, the pairs
    under the causal mask only) counts fewer by the masked-out pairs'
    4·B·H·hd·S(S-1)/2 a layer, exactly."""
    jcfg, cfg = jax_smoke(JAX_ARCHS["gemma-7b"]), smoke(ARCHS["gemma-7b"])
    B, S = 2, 128
    params = jax.eval_shape(lambda: JM.init_params(jcfg,
                                                   jax.random.PRNGKey(0)))
    text = jax.jit(lambda p, t: JM.forward(jcfg, p, t)[0]).lower(
        params, jax.ShapeDtypeStruct((B, S), jnp.int32)).compile().as_text()
    want = jax_analyze(text).dot_flops
    model = M.DecoderLM(cfg, torch.device("meta"))
    toks = _meta(B, S, dtype=torch.int32)
    plain = analyze(lambda: M.forward(cfg, model, toks,
                                      differentiable=True)).dot_flops
    kernel = analyze(lambda: M.forward(cfg, model, toks)).dot_flops
    H, hd = cfg.num_heads, cfg.resolved_head_dim
    assert plain == want
    assert want - kernel == cfg.num_layers * 4 * B * H * hd * S * (S - 1) // 2


def test_extrapolation_equals_direct_counts():
    """recurrentgemma smoke (pattern rglru, rglru, local and a remainder
    of two) at 3 and 4 repeats, training on a (1, 2) mesh of `meta`
    devices: the count extrapolated from 1 and 2 repeats equals the
    direct count in flops, traffic, collective and argument bytes, and
    the peak of live bytes."""
    base = smoke(ARCHS["recurrentgemma-9b"])
    P, rem = len(base.pattern), len(base.remainder)
    shape = ShapeConfig("t", 32, 4, "train")
    mesh = make_mesh(("meta",) * 2, {"data": 1, "model": 2})
    tc = dryrun._train_cfg(base)
    for R in (3, 4):
        cfg = dataclasses.replace(base, num_layers=R * P + rem)
        runs = dryrun.counted_models(cfg)
        assert [w for _, w, _ in runs] == [2.0 - R, R - 1.0]
        got = extrapolate([(lb, w, dryrun.count_step(c, shape, mesh, tc))
                           for lb, w, c in runs])
        direct = dryrun.count_step(cfg, shape, mesh, tc)
        assert got.dot_flops == direct.dot_flops > 0
        assert got.traffic_bytes == direct.traffic_bytes
        assert got.collective_bytes == direct.collective_bytes
        assert got.collective_total > 0
        assert got.param_bytes == direct.param_bytes
        assert got.peak_bytes == direct.peak_bytes
        assert got.loopless_flops < got.dot_flops


def test_counted_models_cover_exits_and_encoders():
    """The decoder is counted from the fewest repeats that hold every
    exit head; an encoder from one and two layers; a config no deeper
    than that is counted as it is."""
    g = dataclasses.replace(ARCHS["granite-34b"], num_layers=3)
    assert [(w, c.num_layers) for _, w, c in dryrun.counted_models(g)] == [
        (-1.0, 1), (2.0, 2)]
    ex = dataclasses.replace(g, adaptive=dataclasses.replace(
        g.adaptive, enabled=True, exit_layers=(0, 1)))
    assert [(w, c.num_layers) for _, w, c in dryrun.counted_models(ex)] == [
        (1.0, 3)]
    w = ARCHS["whisper-small"]
    assert [(wt, c.num_layers, c.encoder_layers)
            for _, wt, c in dryrun.counted_models(w)] == [
        (1.0 - 11 - 11, 1, 1), (11.0, 2, 1), (11.0, 1, 2)]


def test_peak_of_live_bytes():
    """A function whose live storage peaks at known bytes: two 4 KB
    temporaries, a view that holds one, then a 40 KB one beside the
    result."""
    def f(x):
        a = x * 2                      # 4 KB live
        b = a + 1                      # 8 KB
        del a                          # 4 KB
        c = b.view(-1)                 # a view: no storage
        d = c * 3                      # 8 KB
        e = torch.empty(10_000, device=x.device)   # 48 KB: the peak
        del e, b, c
        return d
    for dev in ("meta", "cpu"):
        st = analyze(f, torch.zeros(1024, device=dev))
        assert st.peak_bytes == 4096 + 4096 + 40_000
        assert st.param_bytes == 4096
        # three 4 KB results and the 40 KB one, each written and read once
        assert st.traffic_bytes == 2 * (3 * 4096 + 40_000) + 4096


@pytest.mark.parametrize("arch", ["whisper-small", "dbrx-132b", "rwkv6-3b"])
def test_abstract_placed_bytes_equal_a_real_placement(arch):
    """`abstract_placed` of the parameters and the moments on (2, 2) gives
    each position's bytes of a real CPU placement of the smoke model."""
    from repro_torch.optim import adamw_init
    cfg = smoke(ARCHS[arch])
    mesh = make_mesh(("cpu",) * 4, {"data": 2, "model": 2})
    params = pl.shard_params(M.init_params(cfg, torch.Generator().manual_seed(
        0), device="cpu"), mesh)
    tc = dryrun._train_cfg(cfg)
    opt = adamw_init(params, tc)
    axes = {"data": 2, "model": 2}
    want_p = tree_bytes(pl.abstract_placed(M.abstract_params(cfg),
                                           M.param_specs(cfg), axes))
    want_o = tree_bytes(pl.abstract_placed(dryrun.abstract_opt_state(cfg, tc),
                                           dryrun.opt_state_specs(cfg), axes))
    assert pl.position_bytes(params) == [want_p] * 4
    moments = [a + b for a, b in zip(pl.position_bytes(opt["mu"]),
                                     pl.position_bytes(opt["nu"]))]
    assert [m + 4 for m in moments] == [want_o] * 4     # + the int32 count


def test_kernel_costs_reproduce_the_recorded_bounds():
    """B4 and B5's `cost()` at 989e12 FLOP/s (bf16) / 67e12 (f32) and
    3.35e12 bytes/s give PERF.md's bounds: dbrx's causal 4 x 2048 (48 / 8
    heads of 128) 0.2086 ms, recurrentgemma's band (2 x 4096, 16 / 1 heads
    of 256, window 2048) 0.2085 ms, both by operations; rwkv6-3b's B5 (4 x
    2048 x 40 heads of 64) 0.1260 ms by bytes."""
    def bound_ms(flops, nbytes, peak):
        return round(1e3 * max(flops / peak, nbytes / H100_SXM.hbm_bw), 4)
    bf = torch.bfloat16
    q, kv = _meta(4, 2048, 48, 128, dtype=bf), _meta(4, 2048, 8, 128, dtype=bf)
    assert bound_ms(*b4_cost(q, kv, kv), H100_SXM.peak_flops) == 0.2086
    q, kv = _meta(2, 4096, 16, 256, dtype=bf), _meta(2, 4096, 1, 256, dtype=bf)
    assert bound_ms(*b4_cost(q, kv, kv, window=2048),
                    H100_SXM.peak_flops) == 0.2085
    r, u = _meta(4, 2048, 40, 64), _meta(40, 64)
    flops, nbytes = b5_cost(r, r, r, r, u)
    assert bound_ms(flops, nbytes, H100_SXM.peak_flops_f32) == 0.1260
    assert nbytes / H100_SXM.hbm_bw > flops / H100_SXM.peak_flops_f32
    # the flat layout counts the same work
    flat = _meta(4 * 40, 2048, 64)
    assert b5_cost(flat, flat, flat, flat, _meta(160, 64)) == (flops, nbytes)


@pytest.mark.parametrize("kw", [dict(), dict(window=48), dict(causal=False,
                                                              kv_len=200),
                                dict(q_offset=128)])
def test_meta_outputs_match_the_plain_versions(kw):
    """On `meta` inputs the wrappers return what their plain versions
    return on the CPU, in shape and dtype, and count their cost under
    `analyze`; the pairs counted are the ones the mask keeps."""
    g = torch.Generator().manual_seed(0)
    Sk = 256
    Sq = 128 if "q_offset" in kw else Sk
    for dt in (torch.float32, torch.bfloat16):
        q = torch.randn((2, Sq, 4, 32), generator=g).to(dt)
        k, v = (torch.randn((2, Sk, 2, 32), generator=g).to(dt)
                for _ in range(2))
        want = ref_attention(q, k, v, **kw)
        got = flash_attention(*(t.to("meta") for t in (q, k, v)), **kw)
        assert (got.shape, got.dtype, got.device.type) == (
            want.shape, want.dtype, "meta")
        st = analyze(lambda: flash_attention(*(t.to("meta")
                                               for t in (q, k, v)), **kw))
        assert st.dot_flops == b4_cost(q, k, v, **kw)[0]
    # the kept pairs: the plain version's weights that are not zero
    q, k, v = (torch.ones(1, n, 1, 32) for n in (Sq, Sk, Sk))
    from repro_torch.kernels.flash_attention.kernel import pairs
    kept = torch.ones(Sq, Sk, dtype=torch.bool)
    if kw.get("causal", True):
        qpos = torch.arange(Sq)[:, None] + kw.get("q_offset", 0)
        kpos = torch.arange(Sk)[None, :]
        kept = kpos <= qpos
        if kw.get("window"):
            kept &= kpos > qpos - kw["window"]
    kept[:, kw.get("kv_len", Sk):] = False
    assert pairs(Sq, Sk, **kw) == int(kept.sum())
    r, kk, vv = (torch.randn((6, 64, 32), generator=g) for _ in range(3))
    lw = -torch.rand((6, 64, 32), generator=g)
    u = torch.randn((6, 32), generator=g)
    want = ref_wkv6(r, kk, vv, lw, u)
    got = wkv6(*(t.to("meta") for t in (r, kk, vv, lw, u)))
    assert [(t.shape, t.dtype) for t in got] == [(t.shape, t.dtype)
                                                 for t in want]
    heads = [t.reshape(2, 3, 64, 32).transpose(1, 2).contiguous().to("meta")
             for t in (r, kk, vv, lw)]
    out, state = wkv6_heads(*heads, u[:3].to("meta"))
    assert out.shape == (2, 64, 3, 32) and state.shape == (2, 3, 32, 32)


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
def test_lower_combo_on_the_production_mesh(shape):
    """deepseek-coder-33b at full width, cut to one layer, on the 16 x 16
    mesh of `meta` devices: the reference's record keys, bytes a position
    from the placement, the roofline's terms on the H100 from the counted
    flops, traffic and collectives (56 heads over a "model" of 16: the
    rows split, so collectives run)."""
    cfg = dataclasses.replace(ARCHS["deepseek-coder-33b"], num_layers=1)
    rec = dryrun.lower_combo("deepseek-coder-33b", shape, cfg=cfg,
                             verbose=False)
    assert {"arch", "shape", "mesh", "chips", "mode", "lower_s",
            "compile_s", "params", "active_params", "memory", "fits_hbm",
            "roofline"} <= set(rec)
    assert (rec["mesh"], rec["chips"]) == ("16x16", 256)
    mem, r = rec["memory"], rec["roofline"]
    assert {"argument_bytes", "output_bytes", "temp_bytes",
            "per_chip_gb"} <= set(mem)
    assert mem["argument_bytes"] > 0 and mem["temp_bytes"] > 0
    assert rec["fits_hbm"] is True
    assert {"hlo_flops", "hlo_flops_per_chip", "hlo_bytes_per_chip",
            "collective_bytes_per_chip", "collectives", "t_compute_s",
            "t_memory_s", "t_collective_s", "dominant", "model_flops",
            "useful_ratio"} <= set(r)
    assert r["hlo_flops"] == 256 * r["hlo_flops_per_chip"] > 0
    assert r["t_compute_s"] == r["hlo_flops_per_chip"] / H100_SXM.peak_flops
    assert r["t_memory_s"] == r["hlo_bytes_per_chip"] / H100_SXM.hbm_bw
    assert r["t_collective_s"] == (r["collective_bytes_per_chip"]
                                   / H100_SXM.nvlink_bw) > 0
    if shape == "prefill_32k":      # B4's pairs under the causal mask
        n_att = 4 * 32 * 56 * 128 * (32768 * 32769 // 2)
        assert r["hlo_flops"] > n_att


def test_roofline_terms_of_counts():
    """The three terms, the dominant one and the reference's keys from a
    `CostStats`."""
    st = analyze(lambda x: x @ x, _meta(1024, 1024))
    t = roofline_terms(st, chips=4)
    assert t["hlo_flops"] == 4 * 2 * 1024 ** 3
    assert t["t_compute_s"] == 2 * 1024 ** 3 / 989e12
    assert t["dominant"] == "memory"      # 12 MB of traffic at 3.35 TB/s
    assert t["collectives"] == {k: 0.0 for k in t["collectives"]}


def test_main_writes_skips_and_fails(tmp_path, capsys):
    """`main` writes one JSON per combo, skips one that exists, and exits
    1 with the failures listed."""
    out = str(tmp_path / "dry")
    args = ["--arch", "gemma-7b", "--shape", "decode_32k", "--both-meshes",
            "--no-compile", "--out", out]
    dryrun.main(args)
    for tag in ("1pod", "2pod"):
        rec = json.loads((tmp_path / "dry" /
                          f"gemma-7b_decode_32k_{tag}.json").read_text())
        assert rec["mesh"] == ("16x16" if tag == "1pod" else "2x16x16")
        assert rec["memory"]["argument_bytes"] > 0
    dryrun.main(args)
    assert capsys.readouterr().out.count("[skip]") == 2
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "no-such-arch", "--shape", "decode_32k",
                     "--no-compile", "--out", out])
    assert e.value.code == 1
    assert "no-such-arch_decode_32k_1pod" in capsys.readouterr().out


def _long_500k_layout(arch, name, multi_pod):
    """ROADMAP C.9's table: each cache leaf's layout at long_500k (batch 1)
    on 16 x 16 and 2 x 16 x 16, the batch's axes moved by `fit_spec`."""
    seq = "pod" if multi_pod else "data"
    if arch == "rwkv6-3b":
        if name == "state":
            return P(None, "pod" if multi_pod else None, "data", "model")
        return P(None, seq)
    if name in ("h", "conv"):
        return P(None, "model") if name == "h" else P(None, None, "model")
    if arch == "gemma-7b":
        return P(None, seq, "model", "data" if multi_pod else None)
    if arch == "whisper-small" and name in ("xk", "xv") and not multi_pod:
        return P(None, None, None, "model")      # 1500 frames: no move
    return P(None, seq, None, "model")


@pytest.mark.parametrize("multi_pod", [False, True], ids=["1pod", "2pod"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_long_500k_lowers_with_the_fitted_cache_layouts(arch, multi_pod):
    """long_500k decodes one sequence: its cache's batch dim cannot take
    ("pod", "data"), so `fit_spec` moves the axes onto another dim (the
    KV caches' sequence, gemma's head dim, rwkv's state and shift
    states), which the layers run (split-key decode, rwkv's state over
    its key and value dims). The lowering places every leaf so, and the
    placed `init_cache` on `meta` devices takes the same layouts."""
    from repro_torch.sharding import use_mesh
    rec = dryrun.lower_combo(arch, "long_500k", multi_pod=multi_pod,
                             compile_=False, verbose=False)
    assert rec["memory"]["argument_bytes"] > 0 and "roofline" not in rec
    cfg = ARCHS[arch]
    L = M._decode_len(cfg, 524_288)
    mesh = make_production_mesh(multi_pod=multi_pod,
                                devices=("meta",) * (512 if multi_pod
                                                     else 256))
    with use_mesh(mesh):
        cache = M.init_cache(cfg, 1, L, device="meta")
    for layer in cache:
        for name, t in layer.items():
            assert t.spec == _long_500k_layout(arch, name, multi_pod), (
                name, t.spec)


@pytest.mark.parametrize("arch", ["granite-34b", "deepseek-coder-33b"])
def test_the_multi_pod_layout_decodes_as_the_unplaced_model(arch):
    """On a ("pod", "data", "model") mesh of 2 x 2 x 2 CPU positions the
    batch is split over ("pod", "data") as on 2 x 16 x 16; a smoke model
    whose KV heads do not divide "model" re-lays its keys out around that
    dim (the path `--multi-pod` decodes through): prefill and two decode
    steps equal the unplaced model's within tests/test_torch_lm_sharded.py's
    5e-5."""
    from repro_torch.sharding import use_mesh
    cfg = dataclasses.replace(smoke(ARCHS[arch]), num_kv_heads=1)
    model = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    mesh = make_mesh(("cpu",) * 8, {"pod": 2, "data": 2, "model": 2})
    params = pl.shard_params(model, mesh)
    toks = torch.randint(0, cfg.vocab_size, (4, 24),
                         generator=torch.Generator().manual_seed(1))
    want, cache = M.prefill_step(cfg, model, toks, length=32)
    with use_mesh(mesh):
        got, pcache = M.prefill_step(cfg, params, toks, length=32)
    assert pcache[0]["k"].spec[0] == ("pod", "data")
    torch.testing.assert_close(got, want, rtol=5e-5, atol=5e-5)
    tok = want.argmax(-1, keepdim=True)
    for pos in (24, 25):
        want, cache = M.decode_step(cfg, model, cache, tok, pos)
        with use_mesh(mesh):
            got, pcache = M.decode_step(cfg, params, pcache, tok, pos)
        torch.testing.assert_close(got, want, rtol=5e-5, atol=5e-5)
        tok = want[:, 0].argmax(-1, keepdim=True)
