"""The fallback placements and the context-parallel attention on a
("data", "model") mesh (`repro_torch.sharding.placement.fitted` and
`FALLBACK_DIMS`, the query rows over "model" of `nn.attention`, rwkv's
(batch, head) pairs of `nn.rwkv`), on meshes of the CPU repeated, and B4's
query offset (`kernels/flash_attention`, plain version) on the CPU.

Where a config's query heads do not divide "model", `fit_spec` puts the
axis on d of `wq` and on the head dim of `wo`; where rwkv's heads do not,
on the key dim of its state. The layers run those layouts: the query rows
split over "model" (also where the reference's `_seq_shard` splits them,
`seq_shard_attn` at S >= 256), each position's rows against the whole
keys with its first row's position as the causal offset; rwkv's column
blocks regrouped into whole (batch row, head) pairs.

Configs, at `smoke()` size in f32 with the JAX package's weights
(`lm_params_from_numpy` of `test_torch_lm_train._tree`: the attention
projections softened, the xattn gates and the rwkv mixes non-zero):
"whisper-6h" (6 heads at model 4: the decoder's self- and
cross-attention and the encoder over 16 frames split their rows),
"deepseek-6h" (6 query / 2 KV heads at model 4, S = 256: wq on d) and
"deepseek-8h" (8 / 2 at model 4, S = 256: the heads divide, and the rows
split by the reference's `_seq_shard`), rwkv6-3b (2 heads of 64) at
model 4 and 16 (32 and 8 columns a position). At full width with the
depth cut: whisper-small on (1, 8) (1 + 1 layers, 1 x 224 tokens, 1500
frames) against the JAX package, and rwkv6-3b (one layer, the vocab cut
to 512) on (1, 16), its state over the key dim.

Tolerances: the placed model against the unplaced port at rtol = atol =
5e-5 (the row-parallel and reduce-scattered sums add in another order,
in f32; 2.5e-4 at whisper-small's full width, `WIDE`); against the JAX package's `forward` at rtol = atol = 5e-4;
the placed loss at rtol 5e-5 of the port's and 5e-4 of the JAX
package's, each synced gradient within 1e-4 relative L2 of the port's
and 5e-4 of `jax.value_and_grad`'s. B4's plain version with an offset
against the JAX package's `_sdpa` under `causal_mask(Sq, Sk, window,
offset)`: f32 at rtol = atol = 1e-5, bf16 at 2e-2 (the reference rounds
the scaled q and the softmax weights to bf16)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS, smoke as jax_smoke
from repro.models import decoder_lm as JM
from repro.nn import attention as JA
from repro_torch.configs import ARCHS, smoke
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 gqa_flash_attention,
                                                 ref_attention)
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.train import lm_batch
from repro_torch.models import decoder_lm as M
from repro_torch.models.convert import lm_params_from_numpy
from repro_torch.nn import attention
from repro_torch.sharding import placement as pl
from repro_torch.sharding import use_mesh
from repro_torch.sharding.logical import P, fit_spec, spec

from test_torch_lm_train import _batch, _tree

PORT = dict(rtol=5e-5, atol=5e-5)
REF = dict(rtol=5e-4, atol=5e-4)
GRAD_REL, JAX_GRAD_REL = 1e-4, 5e-4
# whisper-small at full width against the unplaced port: a (1, 2) mesh,
# whose heads divide and whose rows do not split, is 1.0e-4 away at
# logits up to 5.4, as far as the unplaced port is from the JAX package
# (1.1e-4): f32 sums of 768 and 3072 terms in another order
WIDE = dict(rtol=2.5e-4, atol=2.5e-4)
# name -> (arch, config overrides, mesh, prompt length)
CASES = {
    "whisper-6h": ("whisper-small", dict(num_heads=6, num_kv_heads=6),
                   (1, 4), 24),
    "deepseek-6h": ("deepseek-coder-33b", dict(num_heads=6, num_kv_heads=2),
                    (1, 4), 256),
    "deepseek-8h": ("deepseek-coder-33b", dict(num_heads=8, num_kv_heads=2),
                    (1, 4), 256),
    "rwkv-m4": ("rwkv6-3b", {}, (1, 4), 40),
    "rwkv-m16": ("rwkv6-3b", {}, (1, 16), 40),
}
B, N = 2, 2                           # batch, decoded tokens


def _mesh(data, model):
    return make_mesh(("cpu",) * (data * model), {"data": data,
                                                 "model": model})


def _close(a, b, tol, what):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), err_msg=what,
                               **tol)


def _rel(a, b) -> float:
    return float((a - b).norm() / b.norm())


# ------------------------------------------------------------- placements
@pytest.mark.parametrize("model_ax", [2, 4, 8, 16])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_every_config_places_at_full_width(arch, model_ax):
    """Every parameter of `model_defs` and every cache entry at full
    width, through `placement.fitted` on a model axis of 2, 4, 8 and 16:
    no raise, and the spec is `fit_spec`'s (fallback included)."""
    cfg, mesh = ARCHS[arch], {"data": 1, "model": model_ax}
    for path, d in pl.named_leaves(M.model_defs(cfg)):
        got = pl.fitted(spec(*d.logical), d.shape, mesh, d.logical)
        assert got == fit_spec(spec(*d.logical), d.shape, mesh), path
    for c, cs in zip(M.abstract_cache(cfg, 16, 64),
                     M.cache_specs(cfg, 16, 64)):
        for n, t in c.items():
            assert M.fit_cache(cfg, n, t.shape, mesh) == fit_spec(
                cs[n], t.shape, mesh), n
    if (arch, model_ax) in (("whisper-small", 8), ("deepseek-coder-33b", 16)):
        attn = M.model_defs(cfg)["layers"][0]["attn"]
        assert pl.fitted(spec(*attn["wq"].logical), attn["wq"].shape, mesh,
                         attn["wq"].logical) == P("model", None, None)
        assert pl.fitted(spec(*attn["wo"].logical), attn["wo"].shape, mesh,
                         attn["wo"].logical) == P(None, "model", None)
    if (arch, model_ax) == ("rwkv6-3b", 16):
        state = M.abstract_cache(cfg, 16, 64)[0]["state"]
        assert M.fit_cache(cfg, "state", state.shape, mesh) == P(
            "data", None, "model", None)


def test_a_move_no_layer_runs_still_raises():
    """A KV cache whose 3 KV heads do not divide "model" 4 would take the
    axis on its sequence dim; no layer runs that layout."""
    logical = ("batch", "cache_seq", "kv_heads", None)
    with pytest.raises(NotImplementedError, match="no layer runs"):
        pl.fitted(spec(*logical), (4, 64, 3, 8), {"data": 1, "model": 4},
                  logical)


# ------------------------------------------------------- B4's query offset
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Sq,Sk,offset,window", [
    (128, 128, 0, 0), (128, 256, 128, 0), (128, 384, 100, 0),
    (128, 512, 256, 64), (128, 256, 37, 16)])
def test_offset_plain_version_matches_the_reference(dtype, Sq, Sk, offset,
                                                    window):
    """`ref_attention` and, on the CPU, `flash_attention` with `q_offset`
    against the JAX package's `_sdpa` under its offset mask; queries as
    rows of the keys' sequence, GQA 4 / 2 heads of 32."""
    rng = np.random.default_rng(offset + window)
    q, k, v = (rng.standard_normal((2, s, h, 32)).astype(np.float32)
               for s, h in ((Sq, 4), (Sk, 2), (Sk, 2)))
    jcfg = jax_smoke(JAX_ARCHS["mistral-large-123b"])
    jt = [jnp.asarray(a, dtype=jnp.dtype(dtype)) for a in (q, k, v)]
    want = np.asarray(JA._sdpa(jcfg, *jt, JA.causal_mask(
        Sq, Sk, window, offset)).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype))
                  for a in (q, k, v))
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" \
        else dict(rtol=2e-2, atol=2e-2)
    for got in (ref_attention(tq, tk, tv, window=window, q_offset=offset),
                flash_attention(tq, tk, tv, window=window, q_offset=offset)):
        assert got.dtype == tq.dtype
        _close(got.float(), want, tol, f"offset {offset}")
    rows = gqa_flash_attention(tq[:, :100], tk[:, :Sk - 28],
                               tv[:, :Sk - 28], window=window,
                               q_offset=offset)
    cut = np.asarray(JA._sdpa(jcfg, jt[0][:, :100], jt[1][:, :Sk - 28],
                              jt[2][:, :Sk - 28], JA.causal_mask(
        100, Sk - 28, window, offset)).astype(jnp.float32))
    _close(rows.float(), cut, tol, f"padded rows at offset {offset}")


def test_offset_is_refused_where_it_has_no_meaning():
    q = torch.zeros((1, 128, 2, 32))
    k = torch.zeros((1, 256, 2, 32))
    with pytest.raises(ValueError, match="q_offset"):
        flash_attention(q, k, k, causal=False, q_offset=128)
    with pytest.raises(ValueError, match="q_offset"):
        flash_attention(q, k, k, q_offset=-1)
    with pytest.raises(ValueError, match="Sq == Sk"):
        flash_attention(q, k, k)


# ------------------------------------------------------- smoke models
def _configs(arch, kw):
    return (dataclasses.replace(jax_smoke(JAX_ARCHS[arch]), **kw),
            dataclasses.replace(smoke(ARCHS[arch]), **kw))


@pytest.fixture(scope="module")
def models():
    """Per case: the configs, the JAX weights, a batch of the prompt and
    N more tokens, and the JAX package's forward logits on it."""
    out = {}
    for name, (arch, kw, _, S) in CASES.items():
        jcfg, cfg = _configs(arch, kw)
        tree = _tree(jcfg)
        raw = _batch(jcfg, B, S + N, seed=7)
        jlogits = np.asarray(JM.forward(
            jcfg, jax.tree.map(jnp.asarray, tree),
            jnp.asarray(raw["tokens"]),
            frontend=(jnp.asarray(raw["frontend"]) if "frontend" in raw
                      else None))[0])
        out[name] = dict(jcfg=jcfg, cfg=cfg, tree=tree, raw=raw,
                         jlogits=jlogits)
    return out


def _run(cfg, params, seq, fe, S):
    fwd, _ = M.forward(cfg, params, seq[:, :S], frontend=fe)
    logits, cache = M.prefill_step(cfg, params, seq[:, :S], frontend=fe,
                                   length=S + N)
    steps = [logits]
    for t in range(N):
        lg, cache = M.decode_step(cfg, params, cache, seq[:, S + t:S + t + 1],
                                  S + t)
        steps.append(lg[:, 0])
    return fwd, steps, cache


@pytest.mark.parametrize("name", list(CASES))
def test_placed_model_matches_the_port_and_the_reference(models, name,
                                                         monkeypatch):
    """forward, prefill and N decode steps placed where the heads do not
    divide "model" (or the reference's `_seq_shard` splits the rows):
    against the unplaced port and the JAX package; each full-sequence
    attention split its rows over the positions, causal ones at their
    first row's offset; the cache placed by `fit_cache`."""
    m = models[name]
    cfg, (_, _, mesh_shape, S) = m["cfg"], CASES[name]
    seq = torch.from_numpy(m["raw"]["tokens"]).long()
    fe = (torch.from_numpy(m["raw"]["frontend"])
          if "frontend" in m["raw"] else None)
    model = lm_params_from_numpy(cfg, m["tree"], device="cpu")
    fwd0, steps0, cache0 = _run(cfg, model, seq, fe, S)
    mesh = _mesh(*mesh_shape)
    params = pl.shard_params(model, mesh)
    calls = []

    def record(q, k, v, **kw):
        calls.append((q.shape[1], kw["causal"], kw.get("q_offset")))
        return gqa_flash_attention(q, k, v, **kw)
    monkeypatch.setattr(attention, "gqa_flash_attention", record)
    with use_mesh(mesh) as scope:
        fwd, steps, cache = _run(cfg, params, seq, fe, S)
    _close(fwd, fwd0, PORT, f"{name} forward vs the port")
    _close(fwd, m["jlogits"][:, :S], REF, f"{name} forward vs the reference")
    for t, (a, b) in enumerate(zip(steps, steps0)):
        _close(a, b, PORT, f"{name} step {t} vs the port")
        _close(a, m["jlogits"][:, S - 1 + t], REF, f"{name} step {t} vs the "
               f"reference")
    for c, c0 in zip(cache, cache0):
        for n, t in c.items():
            assert t.spec == M.fit_cache(cfg, n, c0[n].shape, mesh), n
            _close(pl.gather(t), c0[n], PORT, f"{name} cache {n}")
    n = mesh_shape[1]
    if cfg.pattern == ("rwkv",):
        assert cache[0]["state"].spec == P("data", None, "model", None)
        assert scope.exchange["columns_to_pairs"]["calls"] > 0
        return
    rows = -(-S // n)
    causal = [c for c in calls if c[1]]
    assert causal and all(c[0] == rows for c in calls if c[1])
    assert sorted({c[2] for c in causal}) == [rows * i for i in range(n)]
    assert all(c[2] is None for c in calls if not c[1])
    assert ("reduce_scatter" in scope.exchange) == (cfg.num_heads % n != 0)


@pytest.mark.parametrize("name", list(CASES))
def test_placed_loss_and_gradients_match(models, name):
    """`loss_fn` on the placed model made trainable (the rows' plain
    attention under `causal_mask(..., offset)`, rwkv's pairs through
    `_wkv_chunked`), its gradients synced: against the unplaced port's
    and `jax.value_and_grad`'s."""
    m = models[name]
    cfg, jcfg, (_, _, mesh_shape, S) = m["cfg"], m["jcfg"], CASES[name]
    raw = {k: (v[:, :S] if k == "tokens" else v) for k, v in m["raw"].items()}
    (jl, _), jg = jax.value_and_grad(JM.loss_fn, argnums=1, has_aux=True)(
        jcfg, jax.tree.map(jnp.asarray, m["tree"]),
        {k: jnp.asarray(v) for k, v in raw.items()})
    jgrads = dict(lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jg),
                                       device="cpu").named_parameters())
    batch = lm_batch(cfg, raw, "cpu")
    model = lm_params_from_numpy(cfg, m["tree"], device="cpu"
                                 ).requires_grad_()
    loss0, _ = M.loss_fn(cfg, model, batch)
    loss0.backward()
    grads0 = {n: p.grad for n, p in model.named_parameters()}
    mesh = _mesh(*mesh_shape)
    params = pl.shard_params(lm_params_from_numpy(cfg, m["tree"],
                                                  device="cpu"), mesh,
                             trainable=True)
    with use_mesh(mesh):
        loss, _ = M.loss_fn(cfg, params, batch)
        loss.backward()
        grads = pl.sync_grads(params)
    np.testing.assert_allclose(float(loss.detach()), float(loss0.detach()),
                               **PORT)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=5e-4)
    for path, st in pl.named_leaves(grads):
        key = path if path.split(".")[0] in M.STACKS else f"top.{path}"
        assert pl.copies_equal(st), key
        g = pl.gather(st)
        assert _rel(g, grads0[key]) <= GRAD_REL, (name, key)
        assert float((g - jgrads[key]).norm()) <= JAX_GRAD_REL * float(
            jgrads[key].norm()) + 1e-12, (name, key)


# ------------------------------------------------------------ full width
def test_whisper_small_on_model_8_at_full_width():
    """whisper-small at full width (12 heads of 64 over "model" 8: wq on
    d, wo on the head dim), 1 decoder and 1 encoder layer, f32: forward
    on 224 tokens with 1500 frames, prefill and one decode step, against
    the unplaced port and the JAX package."""
    kw = dict(num_layers=1, encoder_layers=1, dtype="float32",
              param_dtype="float32")
    jcfg = dataclasses.replace(JAX_ARCHS["whisper-small"], **kw)
    cfg = dataclasses.replace(ARCHS["whisper-small"], **kw)
    tree = _tree(jcfg)
    raw = _batch(jcfg, 1, 225, seed=5)
    jlogits = np.asarray(JM.forward(
        jcfg, jax.tree.map(jnp.asarray, tree), jnp.asarray(raw["tokens"]),
        frontend=jnp.asarray(raw["frontend"]))[0])
    seq = torch.from_numpy(raw["tokens"]).long()
    fe = torch.from_numpy(raw["frontend"])
    model = lm_params_from_numpy(cfg, tree, device="cpu")
    mesh = _mesh(1, 8)
    params = pl.shard_params(model, mesh)
    assert params["layers"][0]["attn"]["wq"].spec == P("model", None, None)
    assert params["layers"][0]["xattn"]["wo"].spec == P(None, "model", None)
    with use_mesh(mesh) as scope:
        fwd, _ = M.forward(cfg, params, seq[:, :224], frontend=fe)
        last, cache = M.prefill_step(cfg, params, seq[:, :224], frontend=fe,
                                     length=225)
        step, _ = M.decode_step(cfg, params, cache, seq[:, 224:], 224)
    assert scope.exchange["reduce_scatter"]["calls"] > 0
    want, _ = M.forward(cfg, model, seq[:, :224], frontend=fe)
    _close(fwd, want, WIDE, "forward vs the port")
    _close(fwd, jlogits[:, :224], REF, "forward vs the reference")
    _close(last, jlogits[:, 223], REF, "prefill vs the reference")
    _close(step[:, 0], jlogits[:, 224], REF, "decode vs the reference")


def test_rwkv6_3b_state_on_model_16_at_full_width():
    """rwkv6-3b at full width (40 heads of 64, 160 columns a position: 2.5
    heads), one layer, the vocab cut to 512: the prefill's state placed
    over its key dim (4 rows a position) equals the unplaced state, and
    two decode steps from it the unplaced logits."""
    cfg = dataclasses.replace(ARCHS["rwkv6-3b"], num_layers=1,
                              vocab_size=512, dtype="float32",
                              param_dtype="float32")
    model = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    seq = torch.randint(0, 512, (4, 18),
                        generator=torch.Generator().manual_seed(1))
    last0, cache0 = M.prefill_step(cfg, model, seq[:, :16])
    state0 = cache0[0]["state"].clone()
    steps0 = [M.decode_step(cfg, model, cache0, seq[:, 16 + t:17 + t],
                            16 + t)[0] for t in range(2)]
    mesh = _mesh(1, 16)
    params = pl.shard_params(model, mesh)
    with use_mesh(mesh):
        last, cache = M.prefill_step(cfg, params, seq[:, :16])
        state = cache[0]["state"]
        assert state.spec == P("data", None, "model", None)
        assert state.locals[0].shape == (4, 40, 4, 64)
        _close(pl.gather(state), state0, PORT, "state")
        steps = [M.decode_step(cfg, params, cache, seq[:, 16 + t:17 + t],
                               16 + t)[0] for t in range(2)]
    _close(last, last0, PORT, "prefill")
    for a, b in zip(steps, steps0):
        _close(a, b, PORT, "decode")
