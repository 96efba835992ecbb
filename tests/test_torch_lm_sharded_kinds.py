"""The MoE and recurrent layer kinds on a ("data", "model") mesh: `attn_moe`
with its experts FSDP over "data" and tensor-parallel over "model"
(`repro_torch.nn.moe`), `rwkv` over its heads, `rglru` over its channels
and the banded `local` attention (`repro_torch.nn.rwkv`, `nn.rglru`,
`nn.attention`, `nn.blocks`), on meshes of the CPU repeated: (1, 2),
(1, 4), (2, 1) and (2, 2).

Configs, at `smoke()` size in f32 with the JAX package's weights
(`lm_params_from_numpy`): dbrx-132b (SiLU experts) and grok-1-314b (GELU
experts, soft-capped logits), 4 experts top-2; "rwkv-4h", rwkv6-3b with
4 heads of 64 (`smoke()`'s 2 heads do not divide model 4);
"recurrentgemma-16h", recurrentgemma-9b with the full model's 16 query
heads and one KV head (`smoke()`'s 4 query heads put wk / wv over KV
heads, and one KV head does not divide the model axis: a fallback
placement, which raises); "moe-drops", dbrx-132b with 2 experts top-2
and capacity factor 0.5, so that a decode step of 16 lanes drops
assignments.

Tolerances: the sharded model against the unsharded port at rtol = atol =
5e-5 (row-parallel products, the FSDP partials and the rglru gates sum
in another order, in f32); against the JAX package at rtol = atol =
5e-4, as `tests/test_torch_lm_models.py`. The routing (keep, slot, the
drop count), `reduce_scatter` against `all_reduce_sum`'s slice, the rglru
gates reduce-scattered against the all-reduce cut to each position's
channels, and two sharded runs: bit for bit."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS, smoke as jax_smoke
from repro.models import decoder_lm as JM
from repro_torch.configs import ARCHS, smoke
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import decoder_lm as M
from repro_torch.models.convert import lm_params_from_numpy
from repro_torch.nn import moe
from repro_torch.serving import LMServingEngine
from repro_torch.sharding import named, spec, use_mesh
from repro_torch.sharding import placement as pl

PORT = dict(rtol=5e-5, atol=5e-5)
REF = dict(rtol=5e-4, atol=5e-4)
MESHES = [(1, 2), (1, 4), (2, 1), (2, 2)]
CONFIGS = {
    "dbrx-132b": ("dbrx-132b", {}),
    "grok-1-314b": ("grok-1-314b", {}),
    "rwkv-4h": ("rwkv6-3b", dict(d_model=256, num_heads=4,
                                 num_kv_heads=4)),
    "recurrentgemma-16h": ("recurrentgemma-9b", dict(num_heads=16)),
    "moe-drops": ("dbrx-132b", dict(num_experts=2, experts_per_token=2,
                                    capacity_factor=0.5)),
}
KINDS = ["dbrx-132b", "grok-1-314b", "rwkv-4h", "recurrentgemma-16h"]
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


def _jax_steps(jcfg, jparams, seq):
    """The JAX package's logits (B, S + N, V) at positions S - 1 ..
    S + N - 1 from its prefill of S tokens (the KV cache padded to S + N)
    and N decode steps, the rest from its `forward`. A decode step routes
    the batch as one row, so where the forward's rows drop assignments
    the MoE models' decode logits differ from the forward's, in both
    packages."""
    logits = np.array(JM.forward(jcfg, jparams, seq)[0])
    last, cache = JM.prefill_step(jcfg, jparams, seq[:, :S])
    cache = jax.tree.map(lambda a: jnp.pad(a, [(0, 0), (0, 0), (0, N)]
                                           + [(0, 0)] * (a.ndim - 3)), cache)
    logits[:, S - 1] = np.asarray(last)
    for t in range(N):
        lg, cache = JM.decode_step(jcfg, jparams, cache,
                                   seq[:, S + t:S + t + 1], jnp.int32(S + t))
        logits[:, S + t] = np.asarray(lg)[:, 0]
    return logits


@pytest.fixture(scope="module")
def models():
    out = {}
    for name in CONFIGS:
        jcfg, jparams, cfg, model = _models(name)
        seq = np.random.default_rng(7).integers(
            0, cfg.vocab_size, (B, S + N)).astype(np.int32)
        jlogits = np.asarray(JM.forward(jcfg, jparams, jnp.asarray(seq))[0])
        jsteps = (_jax_steps(jcfg, jparams, jnp.asarray(seq))
                  if "attn_moe" in cfg.layer_kinds else jlogits)
        out[name] = (jcfg, cfg, model, torch.from_numpy(seq).long(), jlogits,
                     jsteps)
    return out


def _run(cfg, params, seq, s=S, n=N):
    """forward on the prompt s, then prefill + n decode steps of the next
    tokens: (forward logits, aux, [prefill logits, decode logits...],
    cache)."""
    fwd, aux = M.forward(cfg, params, seq[:, :s])
    logits, cache = M.prefill_step(cfg, params, seq[:, :s], length=s + n)
    steps = [logits]
    for t in range(n):
        lg, cache = M.decode_step(cfg, params, cache, seq[:, s + t:s + t + 1],
                                  s + t)
        steps.append(lg[:, 0])
    return fwd, aux, steps, cache


def _close(a, b, tol, what):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), err_msg=what,
                               **tol)


def _check_run(models, name, mesh_shape, s=S, n=N):
    """The sharded run against the unsharded port and the JAX package;
    returns the placed cache and the exchange counter."""
    jcfg, cfg, model, seq, jlogits, jsteps = models[name]
    mesh = _mesh(*mesh_shape)
    fwd0, aux0, steps0, cache0 = _run(cfg, model, seq, s, n)
    params = pl.shard_params(model, mesh)
    with use_mesh(mesh) as scope:
        fwd, aux, steps, cache = _run(cfg, params, seq, s, n)
    _close(fwd, fwd0, PORT, f"{name} forward vs the port")
    _close(fwd, jlogits[:, :s], REF, f"{name} forward vs the reference")
    _close(aux, aux0, PORT, f"{name} aux loss vs the port")
    for t, (a, b) in enumerate(zip(steps, steps0)):
        _close(a, b, PORT, f"{name} step {t} vs the port")
        _close(a, jsteps[:, s - 1 + t], REF, f"{name} step {t} vs the "
               f"reference")
    for c, c0 in zip(cache, cache0):
        for k in c:
            _close(pl.gather(c[k]), c0[k], PORT, f"{name} cache {k}")
    return cfg, jcfg, mesh, cache, scope


@pytest.mark.parametrize("mesh_shape", MESHES)
@pytest.mark.parametrize("name", KINDS)
def test_sharded_kind_matches_the_port_and_the_reference(models, name,
                                                         mesh_shape):
    cfg, jcfg, mesh, cache, scope = _check_run(models, name, mesh_shape)
    # the placed cache carries the reference's specs, as init_cache places
    # them inside use_mesh
    want = JM.cache_specs(jcfg, B, S + N)
    P, R = len(cfg.pattern), cfg.pattern_repeats
    with use_mesh(mesh):
        fresh = M.init_cache(cfg, B, S + N, "cpu")
    for i, (c, f) in enumerate(zip(cache, fresh)):
        w = want["blocks"][i % P] if i < P * R else want["rem"][i - P * R]
        for k in c:
            ref = tuple(w[k])[1:] if i < P * R else tuple(w[k])
            fit = pl.fitted(ref, c[k].shape, mesh)
            assert c[k].spec == fit and f[k].spec == fit, (i, k, c[k].spec)
            assert f[k].shape == c[k].shape
    if mesh_shape[1] > 1:
        assert scope.exchange["all_reduce_sum"]["copies"] > 0


@pytest.mark.parametrize("mesh_shape", MESHES)
@pytest.mark.parametrize("name", ["dbrx-132b", "grok-1-314b"])
def test_moe_gathers_the_weights_at_the_token_gate(models, name,
                                                   mesh_shape, monkeypatch):
    """The reference's `big` branch (B * S >= 8192, here lowered to 0 so
    that the smoke prompt takes it): each expert weight all-gathered over
    "data", the down-projection's partials reduce-scattered over "model"
    and y all-gathered; the same logits as the unsharded port."""
    monkeypatch.setattr(moe, "GATHER_WEIGHTS_AT", 0)
    cfg, _, _, _, scope = _check_run(models, name, mesh_shape)
    data, model = mesh_shape
    assert ("reduce_scatter" in scope.exchange) == (model > 1)
    if data > 1:    # each position gathers 3 expert weights a layer
        weights = 3 * cfg.num_experts * cfg.d_model * cfg.d_ff * 4
        assert scope.exchange["all_gather"]["bytes"] >= \
            cfg.num_layers * weights * (data - 1)


@pytest.mark.parametrize("window_side", ["below", "above"])
@pytest.mark.parametrize("mesh_shape", [(1, 2), (2, 2)])
def test_local_ring_and_head_dim_split_compose(models, mesh_shape,
                                               window_side):
    """recurrentgemma's `local` layers keep a ring of the window (16 at
    smoke size), placed over the head dim (`cache_hd`): a prompt shorter
    than the window (8, decoding past it to 20) and longer (24)."""
    s, n = (8, 12) if window_side == "below" else (24, 3)
    cfg, _, _, cache, _ = _check_run(models, "recurrentgemma-16h",
                                     mesh_shape, s, n)
    ring = [c["k"] for c, kind in zip(cache, cfg.layer_kinds)
            if kind == "local"][0]
    assert ring.shape[1] == cfg.sliding_window
    assert ring.spec[3] == "model"


@pytest.mark.parametrize("name", KINDS)
def test_two_sharded_runs_are_bitwise_equal(models, name):
    _, cfg, model, seq, _, _ = models[name]
    mesh = _mesh(2, 2)
    params = pl.shard_params(model, mesh)
    with use_mesh(mesh):
        a = _run(cfg, params, seq)
        b = _run(cfg, params, seq)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert all(torch.equal(x, y) for x, y in zip(a[2], b[2]))


@pytest.mark.parametrize("mesh_shape", [(1, 2), (2, 2)])
@pytest.mark.parametrize("name", KINDS)
def test_engine_gives_the_same_tokens_inside_use_mesh(models, name,
                                                      mesh_shape):
    _, cfg, model, *_ = models[name]
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


@pytest.mark.parametrize("mesh_shape", [(2, 1), (2, 2)])
def test_decode_routing_ranks_the_global_batch(models, mesh_shape):
    """A decode step routes the whole batch as one row: 16 lanes, 2
    experts top-2 and capacity 8 drop the last lanes' assignments. Every
    data position must rank the row as one device does; ranking only its
    own 8 lanes would keep them all (checked below), so keep, slot, the
    drops and the logits equal the unsharded model's only when the expert
    ids cross the data positions."""
    _, cfg, model, *_ = models["moe-drops"]
    lanes = 16
    seq = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (lanes, 6)))
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (lanes, 1, cfg.d_model)).astype(np.float32))
    p = model.layers[0]["moe"]
    _, _, _, keep0, slot0 = moe.route(cfg, p, x.transpose(0, 1))
    C = moe._capacity(cfg, lanes)
    assert C == 8 and int((~keep0).sum()) > 0
    eid = moe.route(cfg, p, x.transpose(0, 1))[2].reshape(1, -1)
    half = eid.shape[1] // 2
    alone = torch.cat([moe._slots(e, cfg.num_experts, C)[0]
                       for e in (eid[:, :half], eid[:, half:])], dim=1)
    assert not torch.equal(alone, keep0)   # the test tells the two apart

    mesh = _mesh(*mesh_shape)
    params = pl.shard_params(model, mesh)
    with use_mesh(mesh):
        xs = pl.shard(x, named(mesh, spec("batch", None, None), x.shape))
        *_, keep, slot = moe.sharded_route(
            cfg, params["layers"][0]["moe"], xs, decode=True)
    assert torch.equal(pl.gather(keep), keep0)
    assert torch.equal(pl.gather(slot), slot0)

    def decode(params, cache):
        moe.apply_moe.drops = []
        try:
            out = []
            for t in range(seq.shape[1]):
                lg, cache = M.decode_step(cfg, params, cache,
                                          seq[:, t:t + 1], t)
                out.append(lg[:, 0])
            return out, [(int(d), n) for d, n in moe.apply_moe.drops]
        finally:
            moe.apply_moe.drops = None

    want, drops0 = decode(model, M.init_cache(cfg, lanes, 8, "cpu"))
    assert sum(d for d, _ in drops0) > 0
    with use_mesh(mesh):
        got, drops = decode(params, M.init_cache(cfg, lanes, 8, "cpu"))
    assert drops == drops0
    for t, (a, b) in enumerate(zip(got, want)):
        _close(a, b, PORT, f"decode step {t}")


@pytest.mark.parametrize("axis,dim", [("model", 2), ("model", 1),
                                      ("data", 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_reduce_scatter_is_all_reduce_sums_slice(axis, dim, dtype):
    mesh = _mesh(2, 2)
    rng = np.random.default_rng(9)
    parts = [torch.from_numpy(rng.standard_normal((2, 8, 12)).astype(
        np.float32)).to(dtype) for _ in range(4)]
    st = pl.wrap(parts, (None, None, None), mesh)
    with use_mesh(mesh) as scope:
        full = pl.all_reduce_sum(st, axis)
        rs = pl.reduce_scatter(st, axis, dim)
    assert rs.spec[dim] == axis and rs.shape == st.shape
    for i in range(4):
        start, size = rs.block(i, dim)
        assert torch.equal(rs.locals[i],
                           full.locals[i].narrow(dim, start, size))
    ex = scope.exchange
    assert ex["reduce_scatter"]["bytes"] * 2 == ex["all_reduce_sum"]["bytes"]


@pytest.mark.parametrize("mesh_shape", [(1, 1), (2, 2)])
def test_shard_params_releases_the_model_as_it_places(models, mesh_shape):
    """`release=True` places the same blocks and empties each group of
    the model once it is placed."""
    _, cfg, model, *_ = models["dbrx-132b"]
    copy = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    copy.load_state_dict(model.state_dict())
    mesh = _mesh(*mesh_shape)
    want = pl.shard_params(model, mesh)
    got = pl.shard_params(copy, mesh, release=True)
    assert all(t.numel() == 0 for t in copy.parameters())
    assert all(t.numel() > 0 for t in model.parameters())
    flat = list(zip(pl._leaves(got), pl._leaves(want)))
    assert len(flat) == sum(1 for _ in model.parameters())
    for a, b in flat:
        assert a.spec == b.spec and all(
            torch.equal(x, y) for x, y in zip(a.locals, b.locals))


def test_deep_rwkv_in_f32_stays_with_one_device():
    """16 rwkv layers (4 heads of 64, the token-shift mixes drawn from
    U(0, 1)) on a (1, 2) mesh in f32 stay within 1e-4 relative L2 of one
    device (f32 sums in another order, grown over the layers): the
    distance a bf16 model shows on the card between meshes is its
    rounding grown by depth, not the sharding."""
    cfg = dataclasses.replace(smoke(ARCHS["rwkv6-3b"]), d_model=256,
                              num_heads=4, num_kv_heads=4, num_layers=16)
    g = torch.Generator().manual_seed(0)
    model = M.init_params(cfg, g, "cpu")
    with torch.no_grad():
        for p in model.layers:
            for name, w in p.named_parameters():
                if name.rsplit(".", 1)[-1].startswith("mu_"):
                    w.uniform_(0.0, 1.0, generator=g)
    toks = torch.randint(0, cfg.vocab_size, (4, 128),
                         generator=torch.Generator().manual_seed(1))
    want = M.prefill_step(cfg, model, toks)[0]
    mesh = _mesh(1, 2)
    params = pl.shard_params(model, mesh)
    with use_mesh(mesh):
        got = M.prefill_step(cfg, params, toks)[0]
    assert float((got - want).norm() / want.norm()) < 1e-4


@pytest.mark.parametrize("mesh_shape", MESHES)
@pytest.mark.parametrize("decode", [False, True])
def test_rglru_gates_reduce_scatter_the_all_reduce(mesh_shape, decode):
    """The rglru gates on a placed conv output: each product with w_a /
    w_i reduce-scattered onto the position's channels gives the bits of
    the f32 all-reduce cut to them (the reference's layout), for half
    its bytes at model 2."""
    from repro_torch.nn import rglru
    from repro_torch.sharding.logical import NamedSharding, P
    mesh = _mesh(*mesh_shape)
    rng = np.random.default_rng(11)
    w = 64
    shape, xspec = (((4, w), P("data", "model")) if decode else
                    ((4, 24, w), P("data", None, "model")))

    def place(a, s):
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        return pl.shard(t, NamedSharding(mesh, pl.fitted(s, t.shape, mesh)))
    xc = place(rng.standard_normal(shape), xspec)
    p = {k: place(0.1 * rng.standard_normal((w, w)), P("model", None))
         for k in ("w_a", "w_i")}
    p["lam"] = place(rng.standard_normal(w), P("model"))
    xf = pl.local_map(torch.Tensor.float, xc)
    eq = "btv,vw->btw" if not decode else "bv,vw->bw"
    with use_mesh(mesh) as ref_scope:
        za, zi = (pl.relayout(pl.einsum(eq, xf, pl.local_map(
            torch.Tensor.float, p[k])), xc.spec) for k in ("w_a", "w_i"))
    want = pl.local_map_n(rglru._gate_values, p, xf, za, zi,
                          specs=[xc.spec] * 2)
    with use_mesh(mesh) as scope:
        got = rglru._sharded_gates(p, xc)
    for g, h in zip(got, want):
        assert g.spec == h.spec == xc.spec
        assert all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(g.locals, h.locals))
    if mesh_shape[1] > 1:
        assert set(scope.exchange) == {"reduce_scatter"}
        assert scope.exchange["reduce_scatter"]["bytes"] * mesh_shape[1] \
            == ref_scope.exchange["all_reduce_sum"]["bytes"]
    else:
        assert not scope.exchange
