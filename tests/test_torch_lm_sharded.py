"""The dense `attn` LMs tensor-parallel over "model" and data-parallel over
"data" (`repro_torch.sharding.placement`, the sharded branches of
`decoder_lm`, `nn.attention` and `nn.basic`), on meshes of the CPU
repeated: (1, 2), (1, 4), (2, 1) and (2, 2).

Configs, at `smoke()` size in f32 with the JAX package's weights
(`lm_params_from_numpy`): gemma-7b, mistral-large-123b and
deepseek-coder-33b (4 query heads: wk / wv over KV heads, the decode cache
over the head dim), "mistral-hd" (16 query heads, 2 KV heads of 32: wk /
wv over the head dim, the reference's `cache_hd`, and at model 4 the KV
heads whole on every position) and "gemma-kvh" (16 query and KV heads of
16: the decode cache over KV heads, gemma-7b's layout at full size).

Tolerances: the sharded model against the unsharded port at rtol = atol =
5e-5 (row-parallel products and the head-dim-split decode logits sum in
another order, in f32, at logits of magnitude up to ~4.5); against the
JAX package at rtol = atol = 5e-4, as `tests/test_torch_lm_models.py`.
`shard` -> `gather`, the vocab-parallel embedding and logits, and two
sharded runs: bit for bit."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS, smoke as jax_smoke
from repro.models import decoder_lm as JM
from repro_torch.common import AdaptiveDepthConfig
from repro_torch.configs import ARCHS, smoke
from repro_torch.core.adaptive_depth import adaptive_decode_step
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import decoder_lm as M
from repro_torch.models.convert import lm_params_from_numpy
from repro_torch.serving import LMServingEngine
from repro_torch.sharding import placement as pl
from repro_torch.sharding import named, spec, use_mesh

PORT = dict(rtol=5e-5, atol=5e-5)
REF = dict(rtol=5e-4, atol=5e-4)
MESHES = [(1, 2), (1, 4), (2, 1), (2, 2)]
CONFIGS = {
    "gemma-7b": ("gemma-7b", {}),
    "mistral-large-123b": ("mistral-large-123b", {}),
    "deepseek-coder-33b": ("deepseek-coder-33b", {}),
    "mistral-hd": ("mistral-large-123b",
                   dict(num_heads=16, num_kv_heads=2, head_dim=32)),
    "gemma-kvh": ("gemma-7b", dict(num_heads=16, num_kv_heads=16,
                                   head_dim=16)),
}
B, S, N = 4, 24, 3                    # batch, prompt, decoded tokens


def _mesh(data, model):
    return make_mesh(("cpu",) * (data * model), {"data": data,
                                                 "model": model})


def _models(name):
    arch, kw = CONFIGS[name]
    jcfg = dataclasses.replace(jax_smoke(JAX_ARCHS[arch]), **kw)
    tcfg = dataclasses.replace(smoke(ARCHS[arch]), **kw)
    tree = jax.tree.map(np.asarray, JM.init_params(jcfg,
                                                   jax.random.PRNGKey(3)))
    return jcfg, jax.tree.map(jnp.asarray, tree), tcfg, \
        lm_params_from_numpy(tcfg, tree, device="cpu")


@pytest.fixture(scope="module")
def models():
    out = {}
    for name in CONFIGS:
        jcfg, jparams, cfg, model = _models(name)
        seq = np.random.default_rng(7).integers(
            0, cfg.vocab_size, (B, S + N)).astype(np.int32)
        jlogits = np.asarray(JM.forward(jcfg, jparams, jnp.asarray(seq))[0])
        out[name] = (cfg, model, torch.from_numpy(seq).long(), jlogits)
    return out


def _run(cfg, params, seq):
    """forward on the prompt, then prefill + N decode steps of the next
    tokens: (forward logits, [prefill logits, decode logits...], cache)."""
    fwd, _ = M.forward(cfg, params, seq[:, :S])
    logits, cache = M.prefill_step(cfg, params, seq[:, :S], length=S + N)
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
    cfg, model, seq, jlogits = models[name]
    mesh = _mesh(*mesh_shape)
    fwd0, steps0, cache0 = _run(cfg, model, seq)
    params = pl.shard_params(model, mesh)
    for (where, st), (_, t) in zip(_leaves(params), _leaves(
            {**{k: model.top[k] for k in model.top.defs},
             "layers": list(model.layers), "encoder": []})):
        assert torch.equal(pl.gather(st), t), where   # shard -> gather
    with use_mesh(mesh) as scope:
        fwd, steps, cache = _run(cfg, params, seq)
    _close(fwd, fwd0, PORT, f"{name} forward vs the port")
    _close(fwd, jlogits[:, :S], REF, f"{name} forward vs the reference")
    for t, (a, b) in enumerate(zip(steps, steps0)):
        _close(a, b, PORT, f"{name} step {t} vs the port")
        _close(a, jlogits[:, S - 1 + t], REF, f"{name} step {t} vs the "
               f"reference")
    specs = M.cache_specs(cfg, B, S + N)
    for c, c0, cs in zip(cache, cache0, specs):
        for n in ("k", "v"):
            assert list(c[n].spec) == list(pl.fitted(cs[n], c0[n].shape,
                                                     mesh))
            _close(pl.gather(c[n]), c0[n], PORT, f"{name} cache {n}")
    if mesh_shape[1] > 1:
        assert scope.exchange["all_reduce_sum"]["copies"] > 0


def _leaves(tree, where=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{where}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{where}[{i}]")
    elif isinstance(tree, torch.nn.Module):
        for k in tree.defs:
            yield from _leaves(tree[k], f"{where}.{k}")
    else:
        yield where, tree


@pytest.mark.parametrize("mesh_shape", MESHES)
@pytest.mark.parametrize("name", ["gemma-7b", "mistral-large-123b"])
def test_vocab_parallel_embedding_and_logits_are_bit_exact(models, name,
                                                           mesh_shape):
    """gemma-7b ties its head to the embedding and scales by sqrt(d)."""
    cfg, model, seq, _ = models[name]
    mesh = _mesh(*mesh_shape)
    params = pl.shard_params(model, mesh)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (B, 5, cfg.d_model)).astype(np.float32))
    pos = M._positions(seq)
    with use_mesh(mesh):
        toks = pl.shard_inputs(cfg, {"tokens": seq}, mesh)["tokens"]
        emb = M._embed_tokens(cfg, params, toks, pl.local_map(M._positions,
                                                              toks))
        xs = pl.shard(x, named(mesh, spec("batch", None, None), x.shape))
        logits = M._project_logits(cfg, params, xs)
    assert torch.equal(pl.gather(emb), M._embed_tokens(cfg, model, seq, pos))
    assert list(logits.spec) == ["data", None, None]
    assert torch.equal(pl.gather(logits), M._project_logits(cfg, model, x))


@pytest.mark.parametrize("mesh_shape", [(1, 4), (2, 2)])
def test_two_sharded_runs_are_bitwise_equal(models, mesh_shape):
    cfg, model, seq, _ = models["mistral-hd"]
    mesh = _mesh(*mesh_shape)
    params = pl.shard_params(model, mesh)
    with use_mesh(mesh):
        a = _run(cfg, params, seq)
        b = _run(cfg, params, seq)
    assert torch.equal(a[0], b[0])
    assert all(torch.equal(x, y) for x, y in zip(a[1], b[1]))


@pytest.mark.parametrize("mesh_shape", [(1, 2), (2, 2)])
@pytest.mark.parametrize("name", ["mistral-hd", "gemma-kvh"])
def test_engine_gives_the_same_tokens_inside_use_mesh(models, name,
                                                      mesh_shape):
    cfg, model, _, _ = models[name]
    prompts = np.random.default_rng(4).integers(0, cfg.vocab_size, (6, 5))

    def serve(params):
        eng = LMServingEngine(cfg, params, slots=4, max_len=32, device="cpu")
        for p in prompts:
            eng.submit(p.tolist(), max_new=5)
        eng.run_until_drained()
        return sorted((r.rid, r.out) for r in eng.completed), eng

    want, _ = serve(model)
    mesh = _mesh(*mesh_shape)
    with use_mesh(mesh):
        got, eng = serve(pl.shard_params(model, mesh))
    assert got == want
    assert all(pl.is_sharded(t) for c in eng.cache for t in c.values())


def _smoke_model(arch):
    """`smoke()` of `arch`, recurrentgemma-9b with the full model's 16
    query heads (the 4 of `smoke()` put its one KV head over the model
    axis: a fallback placement)."""
    cfg = smoke(ARCHS[arch])
    if arch == "recurrentgemma-9b":
        cfg = dataclasses.replace(cfg, num_heads=16)
    return cfg, M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def _soften(cfg, model):
    """wq, wk, wv of every attention and cross-attention scaled to a
    fan-in of d_model, and the `xattn` gates set to 1: the reference's
    initializer makes the softmax a hard max, which turns the f32
    rounding of a row-parallel sum into 1e-4 of the logits, and its zero
    gates switch cross-attention off."""
    scale = {"wq": (cfg.num_heads / cfg.d_model) ** 0.5,
             "wk": (cfg.num_kv_heads / cfg.d_model) ** 0.5,
             "wv": (cfg.num_kv_heads / cfg.d_model) ** 0.5}
    with torch.no_grad():
        for p in (*model.layers, *model.encoder):
            for group in ("attn", "xattn"):
                if group in p.defs:
                    for w, f in scale.items():
                        p[group][w].mul_(f)
            for gate in ("gate_attn", "gate_mlp"):
                if gate in p.defs:
                    p[gate].fill_(1.0)


@pytest.mark.parametrize("arch", ["rwkv6-3b", "recurrentgemma-9b",
                                  "dbrx-132b", "llama-3.2-vision-11b",
                                  "whisper-small"])
def test_every_layer_kind_runs_on_a_mesh(arch):
    """Every layer kind runs on a mesh of more than one position and
    equals the unsharded model: `rwkv`, `rglru`, `local`, `attn_moe`, and
    (with a frontend) `xattn`, `enc` and `encdec`; all run as unplaced
    on a mesh of one."""
    cfg, model = _smoke_model(arch)
    seq = torch.randint(0, cfg.vocab_size, (2, 8))
    n_fe = cfg.encoder_seq if cfg.is_encdec else cfg.num_image_tokens
    if n_fe:
        _soften(cfg, model)
    fe = (torch.randn((2, n_fe, cfg.d_model),
                      generator=torch.Generator().manual_seed(1))
          if n_fe else None)
    want = M.forward(cfg, model, seq, frontend=fe)[0]
    mesh = _mesh(1, 2)
    params = pl.shard_params(model, mesh)
    with use_mesh(mesh):
        got, _ = M.forward(cfg, params, seq, frontend=fe)
    _close(got, want, PORT, f"{arch} on (1, 2)")
    one = _mesh(1, 1)
    params = pl.shard_params(model, one)
    with use_mesh(one):
        got, _ = M.forward(cfg, params, seq, frontend=fe)
    assert torch.equal(got, want)


@pytest.mark.parametrize("arch,mesh_shape", [("recurrentgemma-9b", (1, 2)),
                                             ("rwkv6-3b", (1, 4))])
def test_fallback_placements_raise(arch, mesh_shape):
    """`smoke()` recurrentgemma-9b's one KV head, and rwkv6-3b's 2 heads at
    model 4, do not divide the model axis, so `fit_spec` moves it to
    another dim: d of recurrentgemma's wk / wv, their contracting dim;
    rwkv's state cache onto its key dim, while its weights place 32
    columns (half a head) a position. The layers run both layouts
    (`placement.FALLBACK_DIMS`; rwkv regroups its columns into whole
    (batch row, head) pairs): the model places, and its prefill and
    decode equal the unsharded model's."""
    cfg = smoke(ARCHS[arch])
    model = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    seq = torch.randint(0, cfg.vocab_size, (2, 16))
    mesh = _mesh(*mesh_shape)
    want = M.prefill_step(cfg, model, seq[:, :12], length=16)
    want = [want[0], M.decode_step(cfg, model, want[1], seq[:, 12:13],
                                   12)[0][:, 0]]
    params = pl.shard_params(model, mesh)
    if arch == "recurrentgemma-9b":
        assert params["layers"][2]["attn"]["wk"].spec == ("model", None, None)
    else:
        assert params["layers"][0]["tmix"]["w_r"].spec == (None, "model")
    with use_mesh(mesh):
        last, cache = M.prefill_step(cfg, params, seq[:, :12], length=16)
        got = [last, M.decode_step(cfg, params, cache, seq[:, 12:13],
                                   12)[0][:, 0]]
        if arch == "rwkv6-3b":
            assert cache[0]["state"].spec == ("data", None, "model", None)
            assert M.init_cache(cfg, 2, 16, "cpu")[0]["state"].spec == \
                cache[0]["state"].spec
    for a, b in zip(got, want):
        _close(a, b, PORT, f"{arch} on {mesh_shape}")


def test_placed_models_and_caches_are_checked(models):
    cfg, model, seq, _ = models["mistral-hd"]
    mesh = _mesh(1, 2)
    params = pl.shard_params(model, mesh)
    with pytest.raises(ValueError, match="use_mesh"):
        M.forward(cfg, params, seq)
    plain = M.init_cache(cfg, B, 8, "cpu")
    with use_mesh(mesh):
        with pytest.raises(TypeError, match="placed cache"):
            M.decode_step(cfg, params, plain, seq[:, :1], 0)
        cache = M.init_cache(cfg, B, 8, "cpu")
        assert [list(c["k"].spec) for c in cache] == \
            [["data", None, None, "model"]] * cfg.num_layers
        placed = pl.shard_cache(cfg, plain, mesh)
        for c, p in zip(cache, placed):
            for n in c:
                assert p[n].spec == c[n].spec
                assert torch.equal(pl.gather(p[n]), plain[0][n])
        # adaptive decoding runs on a placed model: without exit heads no
        # token exits, and the step is decode_step's
        acfg = dataclasses.replace(cfg, adaptive=AdaptiveDepthConfig(
            enabled=True, t_s=1e9))
        got, _, info = adaptive_decode_step(acfg, params, cache, seq[:, :1],
                                            0)
        want, _ = M.decode_step(cfg, params, cache, seq[:, :1], 0)
    assert torch.equal(got, want)
    assert (info["exit_block"] == -1).all() and info["exit_block"].shape \
        == (B,) and float(info["flops_saved_frac"]) == 0.0
