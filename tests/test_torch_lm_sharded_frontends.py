"""The cross-attention and encoder kinds, the frontends and adaptive
decoding on a ("data", "model") mesh (`repro_torch.models.decoder_lm`,
`nn.attention`, `nn.blocks`, `core.adaptive_depth`, the "model"-on-d
fallback of `sharding.placement`), on meshes of the CPU repeated: (1, 2),
(1, 4), (2, 1) and (2, 2).

Configs, at `smoke()` size in f32 with the JAX package's weights
(`lm_params_from_numpy`), the `xattn` gates drawn non-zero and the
attention and cross-attention projections scaled to a fan-in of d_model
(tests/test_torch_encdec.py; the reference's initializer makes the
softmax a hard max, which turns the f32 rounding of a row-parallel sum
into 1e-4 of the logits): llama-3.2-vision-11b (`attn` + gated
`xattn` over 8 image rows), whisper-small (`enc` encoder layers over 16
frames, `encdec` decoder layers), "whisper-v511" (whisper-small with a
vocab of 511, odd like its 51,865, so that "model" moves onto d of the
embedding and the head: the embedding looks every id up in its columns
and all-gathers them, the head is row-parallel) and "granite-exits"
(granite-34b at 4 layers with exit heads at blocks 0, 1 and 2, as
tests/test_torch_adaptive.py builds it; its one KV head puts wk / wv's
"model" onto d).

Tolerances: the sharded model against the unsharded port at rtol = atol =
5e-5 (row-parallel products sum in another order, in f32); against the
JAX package at rtol = atol = 5e-4, as tests/test_torch_lm_models.py.
`seed_frontend_cache` against the placed prefill's `xk` / `xv`, two
sharded runs, the engine's tokens and the exit decisions: equal."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS, smoke as jax_smoke
from repro.core.adaptive_depth import adaptive_decode_step as jax_adaptive
from repro.models import decoder_lm as JM
from repro_torch.configs import ARCHS, smoke
from repro_torch.core.adaptive_depth import (adaptive_decode_step,
                                             adaptive_layers)
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import decoder_lm as M
from repro_torch.models.convert import lm_params_from_numpy
from repro_torch.serving import LMServingEngine
from repro_torch.sharding import placement as pl
from repro_torch.sharding import use_mesh
from repro_torch.sharding.logical import P

from test_torch_adaptive import _pair
from test_torch_encdec import _soft_attention, _with_gates

PORT = dict(rtol=5e-5, atol=5e-5)
REF = dict(rtol=5e-4, atol=5e-4)
MESHES = [(1, 2), (1, 4), (2, 1), (2, 2)]
CONFIGS = {
    "llama-3.2-vision-11b": ("llama-3.2-vision-11b", {}),
    "whisper-small": ("whisper-small", {}),
    "whisper-v511": ("whisper-small", dict(vocab_size=511)),
    "granite-exits": None,
}
FRONTENDS = ["llama-3.2-vision-11b", "whisper-small", "whisper-v511"]
B, S, N = 4, 24, 3                    # batch, prompt, decoded tokens


def _mesh(data, model):
    return make_mesh(("cpu",) * (data * model), {"data": data,
                                                 "model": model})


def _models(name):
    if CONFIGS[name] is None:
        return _pair(t_s=0.9)
    arch, kw = CONFIGS[name]
    jcfg = dataclasses.replace(jax_smoke(JAX_ARCHS[arch]), **kw)
    tcfg = dataclasses.replace(smoke(ARCHS[arch]), **kw)
    tree = _soft_attention(jcfg, _with_gates(jax.tree.map(
        np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(3)))))
    return jcfg, jax.tree.map(jnp.asarray, tree), tcfg, \
        lm_params_from_numpy(tcfg, tree, device="cpu")


def _frontend_of(cfg, seed=1, batch=B):
    n = cfg.encoder_seq if cfg.is_encdec else cfg.num_image_tokens
    if not n:
        return None
    return np.random.default_rng(seed).standard_normal(
        (batch, n, cfg.d_model)).astype(np.float32)


@pytest.fixture(scope="module")
def models():
    out = {}
    for name in CONFIGS:
        jcfg, jparams, cfg, model = _models(name)
        seq = np.random.default_rng(7).integers(
            0, cfg.vocab_size, (B, S + N)).astype(np.int32)
        fe = _frontend_of(cfg)
        jlogits = np.asarray(JM.forward(
            jcfg, jparams, jnp.asarray(seq),
            frontend=None if fe is None else jnp.asarray(fe))[0])
        out[name] = (cfg, model, torch.from_numpy(seq).long(),
                     None if fe is None else torch.from_numpy(fe), jlogits)
    return out


def _run(cfg, params, seq, fe):
    """forward on the prompt, then prefill + N decode steps of the next
    tokens: (forward logits, [prefill logits, decode logits...], cache)."""
    fwd, _ = M.forward(cfg, params, seq[:, :S], frontend=fe)
    logits, cache = M.prefill_step(cfg, params, seq[:, :S], frontend=fe,
                                   length=S + N)
    steps = [logits]
    for t in range(N):
        lg, cache = M.decode_step(cfg, params, cache, seq[:, S + t:S + t + 1],
                                  S + t)
        steps.append(lg[:, 0])
    return fwd, steps, cache


def _close(a, b, tol, what):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), err_msg=what,
                               **tol)


@pytest.mark.parametrize("mesh_shape", MESHES)
@pytest.mark.parametrize("name", list(CONFIGS))
def test_sharded_model_matches_the_port_and_the_reference(models, name,
                                                          mesh_shape):
    cfg, model, seq, fe, jlogits = models[name]
    mesh = _mesh(*mesh_shape)
    fwd0, steps0, cache0 = _run(cfg, model, seq, fe)
    params = pl.shard_params(model, mesh)
    with use_mesh(mesh) as scope:
        fwd, steps, cache = _run(cfg, params, seq, fe)
    _close(fwd, fwd0, PORT, f"{name} forward vs the port")
    _close(fwd, jlogits[:, :S], REF, f"{name} forward vs the reference")
    for t, (a, b) in enumerate(zip(steps, steps0)):
        _close(a, b, PORT, f"{name} step {t} vs the port")
        _close(a, jlogits[:, S - 1 + t], REF, f"{name} step {t} vs the "
               f"reference")
    specs = M.cache_specs(cfg, B, S + N)
    for i, (c, c0, cs) in enumerate(zip(cache, cache0, specs)):
        assert set(c) == set(c0)
        for n in c:
            assert c[n].spec == pl.fitted(cs[n], c0[n].shape, mesh)
            _close(pl.gather(c[n]), c0[n], PORT, f"{name} layer {i} {n}")
    if mesh_shape[1] > 1:
        assert scope.exchange["all_reduce_sum"]["copies"] > 0
        # the "model"-on-d fallback placements
        if name == "whisper-v511":
            assert params["embed"].spec == P(None, "model")
            assert params["lm_head"].spec == P("model", None)
        if name == "granite-exits":
            for w in ("wk", "wv"):
                assert params["layers"][0]["attn"][w].spec == \
                    P("model", None, None)


@pytest.mark.parametrize("mesh_shape", MESHES)
@pytest.mark.parametrize("name", FRONTENDS)
def test_seed_frontend_cache_is_the_placed_prefills(models, name,
                                                    mesh_shape):
    """`seed_frontend_cache` of a placed model into a cache that
    `init_cache` placed inside the mesh: `xk` / `xv` in the cache's
    layout, bit for bit the placed prefill's, and within PORT of the
    unplaced seed."""
    cfg, model, seq, fe, _ = models[name]
    mesh = _mesh(*mesh_shape)
    want = M.seed_frontend_cache(cfg, model, M.init_cache(cfg, B, S, "cpu"),
                                 fe)
    params = pl.shard_params(model, mesh)
    with use_mesh(mesh):
        _, prefilled = M.prefill_step(cfg, params, seq[:, :S], frontend=fe)
        fresh = M.init_cache(cfg, B, S, "cpu")
        seeded = M.seed_frontend_cache(cfg, params, fresh, fe)
    n_x = 0
    for kind, c, p, w, f in zip(cfg.layer_kinds, seeded, prefilled, want,
                                fresh):
        if kind not in ("xattn", "encdec"):
            continue
        n_x += 1
        for n in ("xk", "xv"):
            assert c[n].spec == p[n].spec == f[n].spec
            assert all(torch.equal(a, b) for a, b in zip(c[n].locals,
                                                         p[n].locals))
            _close(pl.gather(c[n]), w[n], PORT, f"{name} seeded {n}")
        if kind == "encdec":
            assert c["k"] is f["k"] and c["v"] is f["v"]
    assert n_x == cfg.layer_kinds.count("xattn") + \
        cfg.layer_kinds.count("encdec") > 0


@pytest.mark.parametrize("mesh_shape", [(1, 2), (2, 2)])
@pytest.mark.parametrize("name", FRONTENDS)
def test_engine_serves_a_seeded_cache_inside_use_mesh(models, name,
                                                      mesh_shape):
    """The engine takes no frontend: its cache is seeded by
    `seed_frontend_cache` before the first tick, placed inside the mesh,
    and gives the unplaced engine's tokens."""
    cfg, model, _, _, _ = models[name]
    prompts = np.random.default_rng(4).integers(0, cfg.vocab_size, (6, 5))
    fe = torch.from_numpy(_frontend_of(cfg, seed=6, batch=4))

    def serve(params):
        eng = LMServingEngine(cfg, params, slots=4, max_len=32, device="cpu")
        eng.cache = M.seed_frontend_cache(cfg, params, eng.cache, fe)
        for p in prompts:
            eng.submit(p.tolist(), max_new=5)
        eng.run_until_drained()
        return sorted((r.rid, r.out) for r in eng.completed), eng

    want, _ = serve(model)
    mesh = _mesh(*mesh_shape)
    with use_mesh(mesh):
        got, eng = serve(pl.shard_params(model, mesh))
    assert got == want and len(got) == 6
    assert all(pl.is_sharded(t) for c in eng.cache for t in c.values())


@pytest.mark.parametrize("name", ["llama-3.2-vision-11b", "whisper-v511"])
def test_two_sharded_runs_are_bitwise_equal(models, name):
    cfg, model, seq, fe, _ = models[name]
    mesh = _mesh(2, 2)
    params = pl.shard_params(model, mesh)
    with use_mesh(mesh):
        a = _run(cfg, params, seq, fe)
        b = _run(cfg, params, seq, fe)
    assert torch.equal(a[0], b[0])
    assert all(torch.equal(x, y) for x, y in zip(a[1], b[1]))


# ------------------------------------------------------------ adaptive
def _model_positions_agree(st):
    """Every "model" position holds the same block as the first position
    of its "data" row."""
    coords = list(pl.positions(st.mesh))
    first = {}
    for i, c in enumerate(coords):
        j = first.setdefault(c["data"], i)
        if not torch.equal(st.locals[i], st.locals[j]):
            return False
    return True


def _adaptive_both(t_s, mesh_shape, steps=4, **kw):
    """`steps` adaptive decode steps from fresh caches of the granite
    smoke model with exits: the JAX package, the unplaced port and the
    port placed on the mesh, the same tokens fed to each. Per step the
    placed run also reruns the step's layers (`adaptive_layers`, writing
    the same keys and values again) to read the placed exit decisions.
    Returns [(reference, port, placed, placed exit_block)]."""
    jcfg, jparams, cfg, model = _pair(t_s=t_s, **kw)
    Bsz = 6
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                             (steps, Bsz, 1)).astype(np.int32)
    mesh = _mesh(*mesh_shape)
    params = pl.shard_params(model, mesh)
    jcache = JM.init_cache(jcfg, Bsz, 16)
    cache0 = M.init_cache(cfg, Bsz, 16, "cpu")
    with use_mesh(mesh):
        cache = M.init_cache(cfg, Bsz, 16, "cpu")
    out = []
    for pos in range(steps):
        jl, jcache, ji = jax_adaptive(jcfg, jparams, jcache,
                                      jnp.asarray(toks[pos]), jnp.int32(pos))
        tok = torch.from_numpy(toks[pos]).long()
        l0, cache0, i0 = adaptive_decode_step(cfg, model, cache0, tok, pos)
        with use_mesh(mesh):
            lg, cache, info = adaptive_decode_step(cfg, params, cache, tok,
                                                   pos)
            ts = pl.shard_inputs(cfg, {"tokens": tok}, mesh)["tokens"]
            x = M._embed_tokens(cfg, params, ts, pl.local_map(
                lambda t: torch.full_like(t, pos), ts))
            plg, _, pblock, _ = adaptive_layers(cfg, params, cache, x, pos)
        out.append(((jl, ji), (l0, i0), (lg, info), (plg, pblock)))
    return out


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@pytest.mark.parametrize("mesh_shape", MESHES)
@pytest.mark.parametrize("t_s", [0.0, 0.6, 0.9, 1e9])
def test_placed_adaptive_decode_matches_the_port_and_the_reference(
        t_s, mesh_shape):
    """exit_block, flops_saved_frac equal to the unplaced port's and the
    reference's, saturation and logits within their tolerances; the exit
    decisions and the logits the same on every "model" position (a
    position that decided otherwise would drift silently)."""
    blocks = set()
    for (jl, ji), (l0, i0), (lg, info), (plg, pblock) in _adaptive_both(
            t_s, mesh_shape):
        sat = _np(ji["saturation"])
        assert not np.any(np.abs(sat - t_s) <= 1e-4 * max(t_s, 1e-9)), sat
        np.testing.assert_array_equal(_np(info["exit_block"]),
                                      _np(ji["exit_block"]))
        assert torch.equal(info["exit_block"], i0["exit_block"])
        assert float(info["flops_saved_frac"]) == \
            float(i0["flops_saved_frac"]) == float(ji["flops_saved_frac"])
        _close(info["saturation"], i0["saturation"], PORT, "saturation")
        _close(info["saturation"], sat, REF, "saturation vs reference")
        _close(lg, l0, PORT, "logits vs the port")
        _close(lg, _np(jl), REF, "logits vs the reference")
        assert pl.is_sharded(pblock) and pblock.spec == P("data")
        assert _model_positions_agree(pblock) and _model_positions_agree(plg)
        assert torch.equal(pl.gather(pblock), info["exit_block"])
        blocks |= set(_np(info["exit_block"]).tolist())
    # the thresholds span the dial: no exit, mixed depths, all at t_min
    assert blocks == {0.0: {-1}, 1e9: {0}}.get(t_s, blocks)
    if t_s == 0.6:
        assert len(blocks) >= 3, blocks


@pytest.mark.parametrize("mesh_shape", [(1, 2), (2, 2)])
def test_placed_adaptive_exits_only_at_a_block_with_a_head(mesh_shape):
    """ROADMAP C.6 on a mesh: exit heads at blocks 0 and 2, t_min 1,
    t_max 3, t_s 1e9: every token exits at block 2 (block 1, which the
    reference would take, has no head), by head 1, as unplaced."""
    kw = dict(exit_layers=(0, 2), t_min=1, t_max=3)
    (jl, ji), (l0, i0), (lg, info), _ = _adaptive_both(
        1e9, mesh_shape, steps=1, **kw)[0]
    assert (_np(ji["exit_block"]) == 1).all()       # the reference's fault
    assert (_np(info["exit_block"]) == 2).all()
    assert float(info["flops_saved_frac"]) == float(i0["flops_saved_frac"]) \
        == 0.25
    _close(lg, l0, PORT, "logits vs the port")


@pytest.mark.parametrize("mesh_shape", [(1, 2), (2, 2)])
def test_adaptive_engine_inside_use_mesh(mesh_shape):
    """The adaptive engine on the placed model: the unplaced engine's
    tokens, ticks and depth-FLOPs shares (over the whole batch)."""
    _, _, cfg, model = _pair(t_s=0.6)
    prompts = [[1 + i, 2, 3 + 2 * i] for i in range(5)]

    def serve(params):
        eng = LMServingEngine(cfg, params, slots=4, max_len=32,
                              adaptive=True, device="cpu")
        for p in prompts:
            eng.submit(p, max_new=4)
        return eng, eng.run_until_drained()

    eng0, stats0 = serve(model)
    mesh = _mesh(*mesh_shape)
    with use_mesh(mesh):
        eng, stats = serve(pl.shard_params(model, mesh))
    assert {r.rid: r.out for r in eng.completed} == \
        {r.rid: r.out for r in eng0.completed}
    assert stats["ticks"] == stats0["ticks"]
    assert eng.flops_saved == eng0.flops_saved
    assert stats["mean_depth_flops_saved"] > 0.0
