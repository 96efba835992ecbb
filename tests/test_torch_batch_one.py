"""Prefill and decode of a batch that the data axes do not divide (one
sequence) on a ("data", "model") and a ("pod", "data", "model") mesh of
the CPU repeated: the batch-one long-context path of every config.

At batch 1 the inputs and the prefill stay replicated over the data axes
(`placement.shard_inputs`), and each cache entry takes the layout that
`fit_spec` gives it, the batch's axes moved onto another dim
(`placement.FALLBACK_DIMS`): a KV cache's sequence (split-key decode:
each position scores its own key slice, and the (m, l, P.v) partials
are combined in axis order; the writing position alone writes the new
token), with "data" on the head dim where the KV heads take "model"
(gemma-7b on ("pod", "data", "model")); rwkv's state over its key dim
and its value dim (and its heads over "pod"), its shift states over d.

Configs, at `smoke()` size in f32 with the JAX package's weights
(`lm_params_from_numpy` of `test_torch_lm_train._tree`: the attention
projections softened, the xattn gates and the rwkv mixes non-zero), with
the widths chosen so that each layout of the production meshes occurs:
one KV head where the full model's KV heads do not divide "model" 16
(the cache over the head dim, the sequence over "data" or "pod"),
gemma-7b at 16 / 16 heads (the cache over its KV heads), rwkv6-3b at 3
heads of 64 (the heads divide no axis; on 2 x 2 x 2 its state goes over
("pod", "data") on its key and value dims) and, on a
("pod", "data", "model") mesh of 2 x 2 x 4, 6 heads of 64 (the state as
on 2 x 16 x 16: heads over "pod", keys over "data", values over
"model").

Tolerances: the placed model against the unplaced port at rtol = atol =
5e-5 (the split-key combine and the row-parallel sums add in another
order, in f32); against the JAX package at rtol = atol = 5e-4 (its
`forward` at the teacher-forced tokens; for the MoE configs its prefill
and decode steps, since a decode step routes the batch as one row). Two
placed runs: bit for bit."""
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
from repro_torch.sharding import placement as pl
from repro_torch.sharding import use_mesh
from repro_torch.sharding.logical import P

from test_torch_lm_train import _tree

PORT = dict(rtol=5e-5, atol=5e-5)
REF = dict(rtol=5e-4, atol=5e-4)
S, N, L = 24, 3, 32                   # prompt, decoded tokens, cache
DM = {"data": 2, "model": 2}
PDM = {"pod": 2, "data": 2, "model": 2}
# the widths: one KV head, except where noted in the module docstring
WIDTHS = {"gemma-7b": dict(num_heads=16, num_kv_heads=16),
          "recurrentgemma-9b": {}, "rwkv6-3b": dict(d_model=192)}
CASES = {arch: (arch, WIDTHS.get(arch, dict(num_kv_heads=1)))
         for arch in sorted(ARCHS)}
CASES["rwkv-6h"] = ("rwkv6-3b", dict(d_model=384))


def _kv(mesh, arch):
    """The layout of a k / v / xk / xv cache at batch 1 (the table of
    ROADMAP C.9 at these widths)."""
    seq = "pod" if "pod" in mesh else "data"
    if arch == "gemma-7b":
        return P(None, seq, "model", None if seq == "data" else "data")
    return P(None, seq, None, "model")


def expected(arch, mesh) -> dict:
    """Each cache entry's layout at batch 1 by its name."""
    if arch.startswith("rwkv"):
        if mesh.get("model") == 4:
            state = P(None, "pod", "data", "model")
        elif "pod" in mesh:
            state = P(None, None, "pod", "data")
        else:
            state = P(None, None, "data", "model")
        shift = P(None, "pod" if "pod" in mesh else "data")
        return {"state": state, "x_t": shift, "x_c": shift}
    return {"k": _kv(mesh, arch), "v": _kv(mesh, arch),
            "xk": _kv(mesh, arch), "xv": _kv(mesh, arch),
            "h": P(None, "model"), "conv": P(None, None, "model")}


def _models(name):
    arch, kw = CASES[name]
    jcfg = dataclasses.replace(jax_smoke(JAX_ARCHS[arch]), **kw)
    tcfg = dataclasses.replace(smoke(ARCHS[arch]), **kw)
    tree = _tree(jcfg, seed=3)
    return jcfg, jax.tree.map(jnp.asarray, tree), tcfg, \
        lm_params_from_numpy(tcfg, tree, device="cpu")


def _jax_logits(jcfg, jparams, seq, fe):
    """The JAX package's logits (1, S + N, V): its `forward`, or for the
    MoE configs its prefill of S tokens (the KV cache padded to S + N)
    and N decode steps at positions S - 1 .. S + N - 1."""
    fe = None if fe is None else jnp.asarray(fe)
    logits = np.array(JM.forward(jcfg, jparams, seq, frontend=fe)[0])
    if "attn_moe" not in jcfg.layer_kinds:
        return logits
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
    for name in CASES:
        jcfg, jparams, cfg, model = _models(name)
        rng = np.random.default_rng(7)
        seq = rng.integers(0, cfg.vocab_size, (1, S + N)).astype(np.int32)
        n = cfg.encoder_seq if cfg.is_encdec else cfg.num_image_tokens
        fe = (rng.standard_normal((1, n, cfg.d_model)).astype(np.float32)
              if n else None)
        out[name] = (cfg, model, torch.from_numpy(seq).long(),
                     None if fe is None else torch.from_numpy(fe),
                     _jax_logits(jcfg, jparams, jnp.asarray(seq), fe))
    return out


def _mesh(axes):
    return make_mesh(("cpu",) * int(np.prod(list(axes.values()))), axes)


def _run(cfg, params, seq, fe):
    """prefill of S tokens into a cache of L, then N decode steps of the
    next tokens: ([prefill logits, decode logits...], cache)."""
    logits, cache = M.prefill_step(cfg, params, seq[:, :S], frontend=fe,
                                   length=L)
    steps = [logits]
    for t in range(N):
        lg, cache = M.decode_step(cfg, params, cache, seq[:, S + t:S + t + 1],
                                  S + t)
        steps.append(lg[:, 0])
    return steps, cache


def _close(a, b, tol, what):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), err_msg=what,
                               **tol)


@pytest.mark.parametrize("axes", [DM, PDM], ids=["data-model",
                                                 "pod-data-model"])
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_batch_one_matches_the_port_and_the_reference(models, name, axes):
    """Prefill and decode of one sequence: the logits against the unplaced
    port and the JAX package, each cache entry in its table layout and
    equal to the unplaced cache, the placed `init_cache` laid out as the
    prefill's cache, and the prefill's inputs replicated."""
    cfg, model, seq, fe, jlogits = models[name]
    mesh = _mesh(axes)
    steps0, cache0 = _run(cfg, model, seq, fe)
    params = pl.shard_params(model, mesh)
    with use_mesh(mesh):
        steps, cache = _run(cfg, params, seq, fe)
        fresh = M.init_cache(cfg, 1, L, "cpu")
        toks = pl.shard_inputs(cfg, {"tokens": seq}, mesh)["tokens"]
    assert toks.spec == P(None, None)
    for t, (a, b) in enumerate(zip(steps, steps0)):
        _close(a, b, PORT, f"{name} step {t} vs the port")
        _close(a, jlogits[:, S - 1 + t], REF,
               f"{name} step {t} vs the reference")
    want = expected(name, axes)
    for i, (c, c0, f) in enumerate(zip(cache, cache0, fresh)):
        for n in c:
            assert c[n].spec == want[n], (name, i, n, c[n].spec)
            assert f[n].spec == c[n].spec, (name, i, n)
            _close(pl.gather(c[n]), c0[n], PORT, f"{name} layer {i} {n}")
    assert any(e is not None and e != "model" for c in cache
               for t in c.values() for e in t.spec[1:]), name


def test_rwkv_state_over_heads_keys_and_values(models):
    """rwkv6-3b at 6 heads on ("pod", "data", "model") 2 x 2 x 4: its
    state over "pod" (heads), "data" (keys) and "model" (values), as on
    2 x 16 x 16; its time-mix columns (1.5 heads a position) regrouped
    into (batch row, head) pairs in the prefill."""
    cfg, model, seq, fe, jlogits = models["rwkv-6h"]
    axes = {"pod": 2, "data": 2, "model": 4}
    mesh = _mesh(axes)
    steps0, cache0 = _run(cfg, model, seq, fe)
    params = pl.shard_params(model, mesh)
    with use_mesh(mesh):
        steps, cache = _run(cfg, params, seq, fe)
    for t, (a, b) in enumerate(zip(steps, steps0)):
        _close(a, b, PORT, f"step {t} vs the port")
        _close(a, jlogits[:, S - 1 + t], REF, f"step {t} vs the reference")
    for i, (c, c0) in enumerate(zip(cache, cache0)):
        for n in c:
            assert c[n].spec == expected("rwkv-6h", axes)[n], (i, n)
            _close(pl.gather(c[n]), c0[n], PORT, f"layer {i} {n}")


@pytest.mark.parametrize("name", ["mistral-large-123b", "gemma-7b",
                                  "recurrentgemma-9b", "rwkv6-3b"])
def test_two_batch_one_runs_are_bitwise_equal(models, name):
    """The combine runs in axis order on every position: two placed runs
    give the same bits, and every copy of a replicated block holds its
    first holder's bits."""
    cfg, model, seq, fe, _ = models[name]
    mesh = _mesh(PDM)
    params = pl.shard_params(model, mesh)
    with use_mesh(mesh):
        a, ca = _run(cfg, params, seq, fe)
        b, _ = _run(cfg, params, seq, fe)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert pl.copies_equal(ca)


def test_split_key_decode_writes_one_position(models):
    """A decode step writes the new token into the one position whose
    block of the sequence holds its slot; the other positions' blocks
    keep their bits, and no collective gathers the cache."""
    cfg, model, seq, fe, _ = models["mistral-large-123b"]
    mesh = _mesh(DM)
    params = pl.shard_params(model, mesh)
    with use_mesh(mesh):
        _, cache = M.prefill_step(cfg, params, seq[:, :S], length=1024)
        before = [t.clone() for t in cache[0]["k"].locals]
        with use_mesh(mesh) as scope:
            M.decode_step(cfg, params, cache, seq[:, S:S + 1], S)
    k = cache[0]["k"]
    for i, (old, new) in enumerate(zip(before, k.locals)):
        start, size = k.block(i, 1)
        if start <= S < start + size:
            assert not torch.equal(old[:, S - start], new[:, S - start])
            new = torch.cat([new[:, :S - start], new[:, S - start + 1:]], 1)
            old = torch.cat([old[:, :S - start], old[:, S - start + 1:]], 1)
        assert torch.equal(old, new), i
    cache_bytes = sum(t.numel() * t.element_size() for t in k.locals)
    assert scope.exchange["all_gather"]["bytes"] < cache_bytes
