"""The port's cross-attention and encoder LMs (llama-3.2-vision-11b:
`attn` + gated `xattn` layers over image embeddings; whisper-small:
`enc` encoder layers + `encdec` decoder layers, sinusoidal positions)
against the JAX package on the CPU at `smoke()` sizes, with the same
weights carried over by `lm_params_from_numpy`; and B4's key bound, which
cross-attention and bidirectional attention need (keys padded to a
multiple of the block past the true Sk).

The reference initializes the `xattn` gates to 0, where tanh(0) = 0 hides
the cross-attention layers entirely; here they are drawn non-zero in the
JAX tree before it is carried across (`_with_gates`).

Tolerances: rtol = atol = 5e-4 on activations, logits and caches in f32
(as tests/test_torch_lm_models.py: attention and the MLPs sum in another
order, at magnitudes up to ~60 with random weights); B4's plain version
against the reference's `_sdpa` at rtol = 2e-4, atol = 2e-5 (the bound of
`repro`'s own flash-attention sweep); bf16 per position as
`test_bf16_per_position` says."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS, smoke as jax_smoke
from repro.models import decoder_lm as JM
from repro.nn import blocks as JB
from repro.nn.attention import _sdpa as jax_sdpa
from repro_torch.configs import ARCHS, smoke
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 gqa_flash_attention,
                                                 ref_attention)
from repro_torch.models import decoder_lm as M
from repro_torch.models.convert import lm_params_from_numpy
from repro_torch.nn import blocks as TB

TOL = dict(rtol=5e-4, atol=5e-4)
ARCHS_X = ("llama-3.2-vision-11b", "whisper-small")
# (arch, layer index) of each kind in the smoke configs; `enc` layers are
# the encoder's
LAYER_OF_KIND = {"xattn": ("llama-3.2-vision-11b", 4),
                 "encdec": ("whisper-small", 0),
                 "enc": ("whisper-small", None)}


def _close(a, b, what=""):
    a = a.detach().float().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_allclose(a, b, err_msg=what, **TOL)


def _with_gates(tree, seed=4):
    """The `xattn` layers' gates drawn from U(0.5, 1.5) with a random sign
    (init_params leaves them at 0), in the tree's dtype."""
    rng = np.random.default_rng(seed)

    def walk(t):
        if isinstance(t, dict):
            return {k: ((rng.uniform(0.5, 1.5, np.shape(v))
                         * rng.choice([-1, 1], np.shape(v))).astype(
                             np.asarray(v).dtype)
                        if k.startswith("gate_") else walk(v))
                    for k, v in t.items()}
        if isinstance(t, (tuple, list)):
            return type(t)(walk(v) for v in t)
        return t
    return walk(tree)


def _soft_attention(cfg, tree):
    """wq, wk, wv of every attention and cross-attention scaled to a
    fan-in of d_model (the reference's initializer takes it from the
    heads axis, so random logits make the softmax a hard max whose winner
    one bf16 rounding can flip), as `chip_smoke.py` scales them."""
    scale = {"wq": (cfg.num_heads / cfg.d_model) ** 0.5,
             "wk": (cfg.num_kv_heads / cfg.d_model) ** 0.5,
             "wv": (cfg.num_kv_heads / cfg.d_model) ** 0.5}

    def walk(t, attn=False):
        if isinstance(t, dict):
            return {k: ((np.asarray(v, np.float32) * scale[k]).astype(
                np.asarray(v).dtype) if attn and k in scale
                else walk(v, k in ("attn", "xattn"))) for k, v in t.items()}
        if isinstance(t, (tuple, list)):
            return type(t)(walk(v) for v in t)
        return t
    return walk(tree)


def _models(arch, dtype="float32", seed=2):
    """(jax cfg, jax params, port cfg, port model) with equal weights and
    non-zero gates; in bf16 the projections are softened."""
    kw = dict(dtype=dtype, param_dtype=dtype)
    jcfg = dataclasses.replace(jax_smoke(JAX_ARCHS[arch]), **kw)
    tcfg = dataclasses.replace(smoke(ARCHS[arch]), **kw)
    tree = _with_gates(jax.tree.map(np.asarray, JM.init_params(
        jcfg, jax.random.PRNGKey(seed))))
    if dtype == "bfloat16":
        tree = _soft_attention(jcfg, tree)
    return (jcfg, jax.tree.map(jnp.asarray, tree), tcfg,
            lm_params_from_numpy(tcfg, tree, device="cpu"))


@pytest.fixture(scope="module")
def models():
    return {a: _models(a) for a in ARCHS_X}


def _frontend(cfg, B, seed=1):
    n = cfg.encoder_seq if cfg.is_encdec else cfg.num_image_tokens
    return np.random.default_rng(seed).standard_normal(
        (B, n, cfg.d_model)).astype(np.float32)


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                (B, S)).astype(np.int32)


def _jax_layer(jcfg, jparams, i):
    P, R = len(jcfg.pattern), jcfg.pattern_repeats
    r, j = divmod(i, P)
    return jax.tree.map(lambda a: a[r], jparams["blocks"][j])


def _jax_cache_layers(jcfg, cache):
    P, R = len(jcfg.pattern), jcfg.pattern_repeats
    return [jax.tree.map(lambda a: a[r], cache["blocks"][j])
            for r in range(R) for j in range(P)] + list(cache["rem"])


def _layer(models, kind):
    arch, i = LAYER_OF_KIND[kind]
    jcfg, jparams, tcfg, model = models[arch]
    if i is None:
        return (jcfg, jax.tree.map(lambda a: a[0], jparams["encoder"]),
                tcfg, model.encoder[0])
    return jcfg, _jax_layer(jcfg, jparams, i), tcfg, model.layers[i]


# ----------------------------------------------------------- B4's key bound
@pytest.mark.parametrize("Sq,Sk,H,KV,hd", [(24, 16, 4, 4, 32),
                                           (40, 200, 8, 2, 32),
                                           (1, 150, 4, 1, 64),
                                           (130, 129, 4, 2, 32)])
def test_unmasked_attention_with_key_bound_matches_sdpa(rng, Sq, Sk, H, KV,
                                                        hd):
    """Cross / bidirectional attention at Sq != Sk: the GQA wrapper (keys
    padded to a multiple of 128, the true Sk as the bound) and the plain
    version over keys padded by hand with kv_len = Sk, against the
    reference's `_sdpa` with no mask over the unpadded keys; then the
    padding filled with NaN gives the same bits as zero padding."""
    cfg = jax_smoke(JAX_ARCHS["whisper-small"])
    q = rng.standard_normal((2, Sq, H, hd)).astype(np.float32)
    k = rng.standard_normal((2, Sk, KV, hd)).astype(np.float32)
    v = rng.standard_normal((2, Sk, KV, hd)).astype(np.float32)
    want = np.asarray(jax_sdpa(cfg, *map(jnp.asarray, (q, k, v)), None))
    tq, tk, tv = map(torch.tensor, (q, k, v))
    got = gqa_flash_attention(tq, tk, tv, causal=False)
    assert got.shape == tq.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-5)
    Sp = -(-Sk // 128) * 128
    pad = (0, 0, 0, 0, 0, Sp - Sk)
    kz, vz = (torch.nn.functional.pad(t, pad) for t in (tk, tv))
    kn, vn = (torch.nn.functional.pad(t, pad, value=float("nan"))
              for t in (tk, tv))
    by_ref = ref_attention(tq, kz, vz, causal=False, kv_len=Sk)
    np.testing.assert_allclose(by_ref.numpy(), want, rtol=2e-4, atol=2e-5)
    assert torch.equal(ref_attention(tq, kn, vn, causal=False, kv_len=Sk),
                       by_ref)
    if Sq % 128 == 0:
        return
    qp = torch.nn.functional.pad(tq, (0, 0, 0, 0, 0, -(-Sq // 128) * 128
                                      - Sq))
    zero = flash_attention(qp, kz, vz, causal=False, kv_len=Sk)
    nan = flash_attention(qp, kn, vn, causal=False, kv_len=Sk)
    assert torch.isfinite(nan).all() and torch.equal(nan, zero)
    assert torch.equal(zero[:, :Sq], got)


# ------------------------------------------------------------------ layers
@pytest.mark.parametrize("kind", ["xattn", "encdec", "enc"])
def test_layer_full_mode_matches_reference(models, kind):
    """Prefill mode against `repro.nn.blocks.apply_layer`: the output and
    every cache entry (`xattn`: xk / xv; `encdec`: k, v, xk, xv; `enc`:
    none); train mode gives the same output and no cache."""
    jcfg, jp, tcfg, p = _layer(models, kind)
    S = 20
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, S, jcfg.d_model)).astype(np.float32)
    fe = _frontend(jcfg, 2) if kind != "enc" else None
    pos = np.broadcast_to(np.arange(S)[None], (2, S))
    jx, jc, _ = JB.apply_layer(
        jcfg, kind, jp, jnp.asarray(x), mode="prefill",
        positions=jnp.asarray(pos),
        frontend=None if fe is None else jnp.asarray(fe))
    tfe = None if fe is None else torch.tensor(fe)
    tx, tc, aux = TB.apply_layer(tcfg, kind, p, torch.tensor(x),
                                 mode="prefill", positions=torch.tensor(pos),
                                 frontend=tfe)
    assert aux == 0.0
    _close(tx, jx, f"{kind} output")
    if kind == "enc":
        assert jc is None and tc is None
    else:
        assert set(tc) == set(jc)
        for name in jc:
            _close(tc[name], jc[name], f"{kind} cache {name}")
    tx2, none, _ = TB.apply_layer(tcfg, kind, p, torch.tensor(x),
                                  mode="train", positions=torch.tensor(pos),
                                  frontend=tfe)
    assert none is None and torch.equal(tx2, tx)


@pytest.mark.parametrize("kind,pos", [("xattn", 0), ("xattn", 9),
                                      ("encdec", 0), ("encdec", 13)])
def test_layer_decode_mode_matches_reference(models, kind, pos):
    """One decode step over a random cache: the output and the new cache
    (`encdec` writes k / v at pos and keeps xk / xv; `xattn` returns its
    cache as it was)."""
    jcfg, jp, tcfg, p = _layer(models, kind)
    rng = np.random.default_rng(pos)
    cache = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32),
        JB.init_layer_cache(jcfg, kind, 2, 24, jnp.float32))
    x = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
    jx, jc, _ = JB.apply_layer(jcfg, kind, jp, jnp.asarray(x), mode="decode",
                               cache=jax.tree.map(jnp.asarray, cache),
                               pos=jnp.int32(pos))
    tcache = {k: torch.tensor(v) for k, v in cache.items()}
    tx, tc, _ = TB.apply_layer(tcfg, kind, p, torch.tensor(x), mode="decode",
                               pos=pos, cache=tcache)
    _close(tx, jx, f"{kind} decode output")
    assert set(tc) == set(jc)
    for name in jc:
        _close(tc[name], jc[name], f"{kind} decode cache {name}")
    assert tc["xk"] is tcache["xk"] and tc["xv"] is tcache["xv"]


def test_init_layer_cache_shapes_match_reference():
    for arch in ARCHS_X:
        jcfg, tcfg = jax_smoke(JAX_ARCHS[arch]), smoke(ARCHS[arch])
        for kind in set(tcfg.layer_kinds):
            jc = JB.init_layer_cache(jcfg, kind, 3, 10, jnp.float32)
            tc = TB.init_layer_cache(tcfg, kind, 3, 10, torch.float32, "cpu")
            assert {n: tuple(t.shape) for n, t in tc.items()} == \
                {n: a.shape for n, a in jc.items()}, (arch, kind)


# ------------------------------------------------------------------- model
def test_run_encoder_matches_reference(models):
    jcfg, jparams, tcfg, model = models["whisper-small"]
    fe = _frontend(jcfg, 2, seed=5)
    _close(M._run_encoder(tcfg, model, torch.tensor(fe)),
           JM._run_encoder(jcfg, jparams, jnp.asarray(fe)), "encoder output")


def test_sinusoid_and_embedding_match_reference(models):
    jcfg, jparams, tcfg, model = models["whisper-small"]
    pos = np.arange(30)[None].repeat(2, 0)
    _close(M._sinusoid(torch.tensor(pos), tcfg.d_model),
           JM._sinusoid(jnp.asarray(pos), jcfg.d_model), "sinusoid")
    toks = _tokens(jcfg, 2, 30)
    _close(M._embed_tokens(tcfg, model, torch.tensor(toks).long(),
                           torch.tensor(pos)),
           JM._embed_tokens(jcfg, jparams, jnp.asarray(toks),
                            jnp.asarray(pos)), "token + position embedding")


@pytest.mark.parametrize("arch", ARCHS_X)
def test_forward_and_prefill_match_reference(models, arch):
    """Logits of `forward` and `prefill_step` and every prefill cache
    entry; the gates matter (the logits move when they are zeroed)."""
    jcfg, jparams, tcfg, model = models[arch]
    toks, fe = _tokens(jcfg, 2, 20), _frontend(jcfg, 2)
    jt, jf = jnp.asarray(toks), jnp.asarray(fe)
    tt, tf = torch.tensor(toks).long(), torch.tensor(fe)
    jl, _, _ = JM.forward(jcfg, jparams, jt, frontend=jf)
    tl, aux = M.forward(tcfg, model, tt, frontend=tf)
    _close(tl, jl, "forward logits")
    assert float(aux) == 0.0
    jl, jcache = JM.prefill_step(jcfg, jparams, jt, frontend=jf)
    tl, tcache = M.prefill_step(tcfg, model, tt, frontend=tf)
    _close(tl, jl, "prefill last logits")
    jlayers = _jax_cache_layers(jcfg, jcache)
    assert len(tcache) == len(jlayers) == tcfg.num_layers
    for i, (kind, tc, jc) in enumerate(zip(tcfg.layer_kinds, tcache,
                                           jlayers)):
        assert set(tc) == set(jc), kind
        for name in jc:
            _close(tc[name], jc[name], f"layer {i} {kind} {name}")
    if "xattn" in tcfg.layer_kinds:
        p = model.layers[tcfg.layer_kinds.index("xattn")]
        gates = (p["gate_attn"].clone(), p["gate_mlp"].clone())
        with torch.no_grad():
            p["gate_attn"].zero_()
            p["gate_mlp"].zero_()
        try:
            off = M.forward(tcfg, model, tt, frontend=tf)[0]
        finally:
            with torch.no_grad():
                p["gate_attn"].copy_(gates[0])
                p["gate_mlp"].copy_(gates[1])
        assert (off - M.forward(tcfg, model, tt, frontend=tf)[0]
                ).abs().max() > 0.1


@pytest.mark.parametrize("arch", ARCHS_X)
def test_decode_steps_match_reference(models, arch):
    """Prefill 12 tokens (cache sized 16), then 4 decode steps, logits and
    the final cache against the reference's, which pads its prefill cache
    the same way by hand."""
    jcfg, jparams, tcfg, model = models[arch]
    S, L = 12, 16
    toks, fe = _tokens(jcfg, 2, L, seed=3), _frontend(jcfg, 2, seed=2)
    _, jcache = JM.prefill_step(jcfg, jparams, jnp.asarray(toks[:, :S]),
                                frontend=jnp.asarray(fe))
    jcache = jax.tree_util.tree_map_with_path(
        lambda path, a: jnp.pad(a, [(0, 0), (0, 0), (0, L - S), (0, 0),
                                    (0, 0)])
        if path[-1].key in ("k", "v") else a, jcache)
    _, tcache = M.prefill_step(tcfg, model, torch.tensor(toks[:, :S]).long(),
                               frontend=torch.tensor(fe), length=L)
    step = jax.jit(lambda p, c, t, pos: JM.decode_step(jcfg, p, c, t, pos))
    for t in range(S, L):
        jl, jcache = step(jparams, jcache, jnp.asarray(toks[:, t:t + 1]),
                          jnp.int32(t))
        tl, tcache = M.decode_step(tcfg, model, tcache,
                                   torch.tensor(toks[:, t:t + 1]).long(), t)
        _close(tl, jl, f"decode logits at step {t}")
    for i, (tc, jc) in enumerate(zip(tcache, _jax_cache_layers(jcfg,
                                                               jcache))):
        for name in jc:
            _close(tc[name], jc[name], f"layer {i} cache {name}")


@pytest.mark.parametrize("arch", ARCHS_X)
def test_seed_frontend_cache_matches_reference_and_prefill(models, arch):
    """`seed_frontend_cache` fills xk / xv of a fresh cache as the
    reference does, equal to the prefill's; decoding from it at position
    0 (the reference launcher's path) gives the reference's logits."""
    jcfg, jparams, tcfg, model = models[arch]
    fe, toks = _frontend(jcfg, 2, seed=6), _tokens(jcfg, 2, 8, seed=7)
    jcache = JM.seed_frontend_cache(jcfg, jparams, JM.init_cache(jcfg, 2, 8),
                                    jnp.asarray(fe))
    fresh = M.init_cache(tcfg, 2, 8, device="cpu")
    tcache = M.seed_frontend_cache(tcfg, model, fresh, torch.tensor(fe))
    _, pcache = M.prefill_step(tcfg, model, torch.tensor(toks).long(),
                               frontend=torch.tensor(fe))
    for i, (kind, tc, jc, pc) in enumerate(zip(
            tcfg.layer_kinds, tcache, _jax_cache_layers(jcfg, jcache),
            pcache)):
        assert set(tc) == set(jc)
        for name in jc:
            _close(tc[name], jc[name], f"layer {i} seeded {name}")
        if kind in ("xattn", "encdec"):
            for name in ("xk", "xv"):
                assert torch.equal(tc[name], pc[name]), (i, name)
    for pos in range(3):
        jl, jcache = JM.decode_step(jcfg, jparams, jcache,
                                    jnp.asarray(toks[:, pos:pos + 1]),
                                    jnp.int32(pos))
        tl, tcache = M.decode_step(tcfg, model, tcache,
                                   torch.tensor(toks[:, pos:pos + 1]).long(),
                                   pos)
        _close(tl, jl, f"decode from the seeded cache at {pos}")


@pytest.mark.parametrize("arch,S", [("llama-3.2-vision-11b", 12),
                                    ("whisper-small", 12),
                                    ("whisper-small", 1)])
def test_prefill_then_decode_equals_forward(models, arch, S):
    """Inside the port, prefill (cache padded to the whole length) then
    decode continues where `forward` on the whole sequence is."""
    jcfg, jparams, tcfg, model = models[arch]
    L = S + 5
    tt = torch.tensor(_tokens(jcfg, 2, L, seed=9)).long()
    tf = torch.tensor(_frontend(jcfg, 2, seed=8))
    full = M.forward(tcfg, model, tt, frontend=tf)[0]
    last, cache = M.prefill_step(tcfg, model, tt[:, :S], frontend=tf,
                                 length=L)
    err = float((last - full[:, S - 1]).abs().max())
    for t in range(S, L):
        logits, cache = M.decode_step(tcfg, model, cache, tt[:, t:t + 1], t)
        err = max(err, float((logits[:, 0] - full[:, t]).abs().max()))
    assert err < 1e-4, err


def test_prefill_length_pads_self_attention_only(models):
    """`length` pads an `encdec` layer's k / v to the decode length; its
    xk / xv keep the encoder's length."""
    jcfg, _, tcfg, model = models["whisper-small"]
    _, cache = M.prefill_step(tcfg, model,
                              torch.tensor(_tokens(jcfg, 2, 6)).long(),
                              frontend=torch.tensor(_frontend(jcfg, 2)),
                              length=11)
    for c in cache:
        assert c["k"].shape[1] == c["v"].shape[1] == 11
        assert c["xk"].shape[1] == c["xv"].shape[1] == tcfg.encoder_seq
        assert (c["k"][:, 6:] == 0).all()


def _rel_rows(a, b):
    a, b = (t.float().numpy() if isinstance(t, torch.Tensor)
            else np.asarray(t, np.float32) for t in (a, b))
    return np.linalg.norm(a - b, axis=-1) / np.linalg.norm(b, axis=-1)


@pytest.mark.parametrize("arch", ARCHS_X)
def test_bf16_per_position(arch):
    """At dtype = param_dtype = bfloat16 (the configs' own types), with
    the projections softened: per position of `forward`, the port's
    relative L2 error against the reference's bf16 logits and against its
    f32 logits on the same weights stays within 2 e, e the reference's
    own bf16-against-f32 error at that position (two packages rounding
    the same f32 function at different points differ by about sqrt(2) e),
    plus 2^-8 (one bf16 rounding of the logits), at every position;
    `prefill_step`'s last logits and every cache entry in bf16."""
    jcfg, jparams, tcfg, model = _models(arch, dtype="bfloat16")
    jcfg32 = dataclasses.replace(jcfg, dtype="float32",
                                 param_dtype="float32")
    jparams32 = jax.tree.map(lambda a: a.astype(jnp.float32), jparams)
    toks, fe = _tokens(jcfg, 2, 20), _frontend(jcfg, 2)
    jt, jf = jnp.asarray(toks), jnp.asarray(fe, jnp.bfloat16)
    tt = torch.tensor(toks).long()
    tf = torch.tensor(fe).to(torch.bfloat16)
    jl = JM.forward(jcfg, jparams, jt, frontend=jf)[0]
    j32 = JM.forward(jcfg32, jparams32, jt, frontend=jf.astype(
        jnp.float32))[0]
    tl = M.forward(tcfg, model, tt, frontend=tf)[0]
    assert tl.dtype == torch.bfloat16
    e = _rel_rows(jl, j32)
    assert (0 < e).all() and (e < 0.1).all(), e
    for other in (jl, j32):
        r = _rel_rows(tl, other)
        assert (r <= 2 * e + 2 ** -8).all(), (r, e)
    last, cache = M.prefill_step(tcfg, model, tt, frontend=tf)
    assert (_rel_rows(last, tl[:, -1]) <= 2 ** -8).all()
    assert all(t.dtype == torch.bfloat16 for c in cache for t in c.values())
