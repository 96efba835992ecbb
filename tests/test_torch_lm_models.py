"""The port's LM layers and model against the JAX package, on the CPU at
`smoke()` sizes (float32), with the same weights carried over by
`lm_params_from_numpy`; and, inside the port, prefill-then-decode against
`forward` on the whole sequence.

Tolerances: rtol = atol = 5e-4 on activations, logits and caches (f32
at magnitudes up to ~60 with random weights; attention and the MLPs sum
in another order, the WKV recurrence runs the chunked factorization with
exp(+-80)-sized factors, and the RG-LRU scan combines in another tree
than `associative_scan`).

Two faults of the reference are not copied (ROADMAP C): the rwkv prefill
cache's `x_t` (the reference stores norm1 of the layer's output, decode
stores norm1 of its input) and the order of the `local` prefill cache
(the reference keeps the last keys in sequence order; decode reads a
ring with position p in slot p % window). Those entries are compared
with what the reference's decode path would store, and the ring after
un-rolling."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS, smoke as jax_smoke
from repro.models import decoder_lm as JM
from repro.nn import blocks as JB
from repro.nn.basic import apply_norm as jax_apply_norm
from repro_torch.common import LAYER_KINDS
from repro_torch.configs import ARCHS, smoke
from repro_torch.models import decoder_lm as M
from repro_torch.models.convert import lm_params_from_numpy
from repro_torch.nn import blocks as TB

TOL = dict(rtol=5e-4, atol=5e-4)
ARCH_OF_KIND = {"rwkv": ("rwkv6-3b", 0), "rglru": ("recurrentgemma-9b", 0),
                "local": ("recurrentgemma-9b", 2), "attn": ("granite-34b", 0)}


def _close(a, b, what=""):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.detach().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_allclose(a, b, err_msg=what, **TOL)


def _with_mixes(tree, seed=5):
    """Non-zero token-shift mixes (init_params leaves them at 0, which
    hides fault 1): every mu_* drawn from U(0, 1), in the tree's dtype."""
    rng = np.random.default_rng(seed)

    def walk(t):
        if isinstance(t, dict):
            return {k: (rng.random(np.shape(v)).astype(np.asarray(v).dtype)
                        if k.startswith("mu_") else walk(v))
                    for k, v in t.items()}
        if isinstance(t, (tuple, list)):
            return type(t)(walk(v) for v in t)
        return t
    return walk(tree)


def _soft_attention(cfg, tree):
    """wq, wk, wv scaled to a fan-in of d_model. The reference's
    initializer takes their fan-in from the heads axis, so random q.k
    logits are large and the softmax is close to a hard max, whose winner
    one bf16 rounding can flip at a single position."""
    scale = {"wq": (cfg.num_heads / cfg.d_model) ** 0.5,
             "wk": (cfg.num_kv_heads / cfg.d_model) ** 0.5,
             "wv": (cfg.num_kv_heads / cfg.d_model) ** 0.5}

    def walk(t, attn=False):
        if isinstance(t, dict):
            return {k: ((np.asarray(v, np.float32) * scale[k]).astype(
                np.asarray(v).dtype) if attn and k in scale
                else walk(v, k == "attn")) for k, v in t.items()}
        if isinstance(t, (tuple, list)):
            return type(t)(walk(v) for v in t)
        return t
    return walk(tree)


def _models(arch, layers=None, seed=2, dtype="float32"):
    """(jax cfg, jax params, port cfg, port model) with equal weights;
    `dtype` sets both the activations' and the parameters' type, and in
    bf16 the attention projections are scaled by `_soft_attention`."""
    jcfg, tcfg = jax_smoke(JAX_ARCHS[arch]), smoke(ARCHS[arch])
    kw = dict(dtype=dtype, param_dtype=dtype)
    if layers:
        kw["num_layers"] = layers
    jcfg = dataclasses.replace(jcfg, **kw)
    tcfg = dataclasses.replace(tcfg, **kw)
    tree = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(
        seed)))
    if "rwkv" in jcfg.pattern:
        tree = _with_mixes(tree)
    if dtype == "bfloat16":
        tree = _soft_attention(jcfg, tree)
    jparams = jax.tree.map(jnp.asarray, tree)
    return jcfg, jparams, tcfg, lm_params_from_numpy(tcfg, tree, device="cpu")


def _jax_layer(jcfg, jparams, i):
    P, R = len(jcfg.pattern), jcfg.pattern_repeats
    if i < P * R:
        r, j = divmod(i, P)
        return jax.tree.map(lambda a: a[r], jparams["blocks"][j])
    return jparams["rem"][i - P * R]


def _jax_cache_layers(jcfg, cache):
    """The reference's stacked cache as one dict per layer."""
    P, R = len(jcfg.pattern), jcfg.pattern_repeats
    out = [jax.tree.map(lambda a: a[r], cache["blocks"][j])
           for r in range(R) for j in range(P)]
    return out + list(cache["rem"])


def _unroll(ring, S):
    """A port ring cache (position p in slot p % W) in sequence order."""
    W = ring.shape[1]
    return ring[:, :S] if S < W else torch.roll(ring, -(S % W), dims=1)


MOE_ARCHS = ("dbrx-132b", "grok-1-314b")


@pytest.fixture(scope="module")
def models():
    return {a: _models(a, layers=2 if a in ("rwkv6-3b",) + MOE_ARCHS
                       else None)
            for a in ("rwkv6-3b", "recurrentgemma-9b", "granite-34b")
            + MOE_ARCHS}


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                (B, S)).astype(np.int32)


# ------------------------------------------------------------------ layers
@pytest.mark.parametrize("kind", ["rwkv", "rglru", "local", "attn"])
def test_layer_full_mode_matches_reference(models, kind):
    arch, i = ARCH_OF_KIND[kind]
    jcfg, jparams, tcfg, model = models[arch]
    jp = _jax_layer(jcfg, jparams, i)
    S = 24                                   # not a multiple of the window
    x = np.random.default_rng(1).standard_normal(
        (2, S, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S)[None], (2, S))
    jx, jc, _ = JB.apply_layer(jcfg, kind, jp, jnp.asarray(x),
                               mode="prefill", positions=jnp.asarray(pos))
    tx, tc, aux = TB.apply_layer(tcfg, kind, model.layers[i],
                                 torch.tensor(x), mode="prefill",
                                 positions=torch.tensor(pos))
    assert aux == 0.0
    _close(tx, jx, f"{kind} output")
    for name in jc:
        if kind == "rwkv" and name == "x_t":     # fault 1: decode's x_t
            want = jax_apply_norm(jcfg, jp["norm1"], jnp.asarray(x))[:, -1]
            _close(tc[name], want, "rwkv x_t = norm1(input)[:, -1]")
        elif kind == "local":                    # fault 2: ring order
            _close(_unroll(tc[name], S), jc[name], f"local {name}")
        else:
            _close(tc[name], jc[name], f"{kind} cache {name}")
    tx2, none, _ = TB.apply_layer(tcfg, kind, model.layers[i],
                                  torch.tensor(x), mode="train",
                                  positions=torch.tensor(pos))
    assert none is None and torch.equal(tx2, tx)


@pytest.mark.parametrize("kind,pos", [("rwkv", 7), ("rglru", 7),
                                      ("local", 5), ("local", 21),
                                      ("attn", 9)])
def test_layer_decode_mode_matches_reference(models, kind, pos):
    arch, i = ARCH_OF_KIND[kind]
    jcfg, jparams, tcfg, model = models[arch]
    jp = _jax_layer(jcfg, jparams, i)
    rng = np.random.default_rng(pos)
    cache = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32),
        JB.init_layer_cache(jcfg, kind, 2, 24, jnp.float32))
    x = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
    jx, jc, _ = JB.apply_layer(jcfg, kind, jp, jnp.asarray(x), mode="decode",
                               cache=jax.tree.map(jnp.asarray, cache),
                               pos=jnp.int32(pos))
    tx, tc, _ = TB.apply_layer(tcfg, kind, model.layers[i],
                               torch.tensor(x), mode="decode", pos=pos,
                               cache={k: torch.tensor(v)
                                      for k, v in cache.items()})
    _close(tx, jx, f"{kind} decode output")
    assert set(tc) == set(jc)
    for name in jc:
        _close(tc[name], jc[name], f"{kind} decode cache {name}")


def test_unported_kinds_raise():
    """Every kind of the reference is ported (ROADMAP A10.2 added `xattn`,
    `encdec` and `enc`); a kind that neither package knows raises
    ValueError in both, from `layer_defs` and `init_layer_cache`."""
    cfg = smoke(ARCHS["llama-3.2-vision-11b"])
    jcfg = jax_smoke(JAX_ARCHS["llama-3.2-vision-11b"])
    for layer_defs in (TB.layer_defs, JB.layer_defs):
        with pytest.raises(ValueError, match="unknown layer kind"):
            layer_defs(cfg if layer_defs is TB.layer_defs else jcfg, "conv")
    with pytest.raises(ValueError):
        TB.init_layer_cache(cfg, "conv", 1, 4, torch.float32, "cpu")
    with pytest.raises(ValueError):
        JB.init_layer_cache(jcfg, "conv", 1, 4, jnp.float32)


@pytest.mark.parametrize("kind", LAYER_KINDS)
def test_layer_defs_match_reference(kind):
    """`layer_defs` of every kind has the reference's names and shapes
    and initializers (at the smoke size of a config that holds the kind;
    llama-3.2-vision's for `attn` and `xattn`), and the scalar
    gates of `xattn` are initialized to 0 as the reference's are."""
    arch = {"rwkv": "rwkv6-3b", "rglru": "recurrentgemma-9b",
            "local": "recurrentgemma-9b", "attn_moe": "dbrx-132b",
            "encdec": "whisper-small", "enc": "whisper-small"}.get(
                kind, "llama-3.2-vision-11b")
    jcfg, tcfg = jax_smoke(JAX_ARCHS[arch]), smoke(ARCHS[arch])

    def flat(defs, prefix=""):
        out = {}
        for k, v in defs.items():
            if isinstance(v, dict):
                out.update(flat(v, f"{prefix}{k}."))
            else:
                out[prefix + k] = (tuple(v.shape), v.init)
        return out
    got, want = flat(TB.layer_defs(tcfg, kind)), flat(JB.layer_defs(jcfg,
                                                                     kind))
    assert got == want
    if kind == "xattn":
        assert got["gate_attn"] == got["gate_mlp"] == ((), "zeros")
        p = M.init_params(tcfg, torch.Generator().manual_seed(0),
                          device="cpu").layers[4]
        assert float(p["gate_attn"]) == float(p["gate_mlp"]) == 0.0


# ------------------------------------------------------------------- model
def _rel_rows(a, b):
    """Relative L2 error of a against b per position (last axis), f32."""
    a, b = (t.float().numpy() if isinstance(t, torch.Tensor)
            else np.asarray(t, np.float32) for t in (a, b))
    return np.linalg.norm(a - b, axis=-1) / np.linalg.norm(b, axis=-1)


def _rel(a, b):
    """Relative L2 error of a against b, both cast to f32."""
    a = a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(
        a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("arch", ["rwkv6-3b", "recurrentgemma-9b",
                                  "granite-34b", "dbrx-132b",
                                  "grok-1-314b"])
def test_bf16_forward_and_prefill_match_reference(arch):
    """At dtype = param_dtype = bfloat16 (the configs' own types) the
    port's logits from `forward` and `prefill_step` are held against the
    reference's bf16 logits and against its f32 logits on the same
    weights (bf16 weights widen to f32 exactly), and every prefill cache
    entry has the reference's dtype. The attention projections are scaled
    to a fan-in of d (`_soft_attention`), as `chip_smoke.py` scales them.

    Tolerance: the reference's own bf16 logits differ from its f32 logits
    by e (2-5% relative L2 here: bf16 keeps 8 significant bits, and random
    weights amplify the roundings layer by layer). Two packages that round
    the same f32 function at slightly different points differ by about
    sqrt(2) e; the port must stay within 2 e of the reference's bf16
    logits and of the f32 logits.

    With MoE layers (dbrx, grok) the router's top-k is a discontinuous
    function: at these widths the reference's "small" router init gives
    near-uniform probabilities (0.2-0.3 over 4 experts), a bf16 rounding
    of the router's input can flip a near-tie (the reference's own bf16
    logits flip against its f32 ones for about one seed in four), and one
    flipped token moves the whole tensor's error to ~5%. So for them the
    rule holds per position of `forward`: the median position's relative
    error within 2 e_med (e_med the median position's error of the
    reference's bf16 against its f32 logits), and at most one position in
    16 beyond it (a flipped token); `prefill_step`'s last logits are held
    to `forward`'s last position in each package (one bf16 rounding,
    2^-8), which the rule above covers."""
    jcfg, jparams, tcfg, model = _models(
        arch, layers=2 if arch in ("rwkv6-3b",) + MOE_ARCHS else None,
        dtype="bfloat16")
    jcfg32 = dataclasses.replace(jcfg, dtype="float32",
                                 param_dtype="float32")
    jparams32 = jax.tree.map(lambda a: a.astype(jnp.float32), jparams)
    toks = _tokens(jcfg, 2, 24)
    jt, tt = jnp.asarray(toks), torch.tensor(toks).long()
    assert next(model.parameters()).dtype == torch.bfloat16
    outs = {
        "forward": (JM.forward(jcfg, jparams, jt)[0],
                    JM.forward(jcfg32, jparams32, jt)[0],
                    M.forward(tcfg, model, tt)[0]),
        "prefill": (JM.prefill_step(jcfg, jparams, jt)[0],
                    JM.prefill_step(jcfg32, jparams32, jt)[0],
                    M.prefill_step(tcfg, model, tt)[0])}
    for what, (jl, j32, tl) in outs.items():
        assert jl.dtype == jnp.bfloat16 and tl.dtype == torch.bfloat16
        e = _rel(jl, j32)
        assert 0 < e < 0.1, (what, e)
        if "attn_moe" not in tcfg.layer_kinds:
            assert _rel(tl, jl) <= 2 * e, (what, _rel(tl, jl), e)
            assert _rel(tl, j32) <= 2 * e, (what, _rel(tl, j32), e)
            continue
        if what == "prefill":
            for a, b in ((tl, outs["forward"][2][:, -1]),
                         (jl, outs["forward"][0][:, -1])):
                assert (_rel_rows(a, b) <= 2 ** -8).all(), (a, b)
            continue
        e_med = float(np.median(_rel_rows(jl, j32)))
        for other in (jl, j32):
            r = _rel_rows(tl, other)
            assert np.median(r) <= 2 * e_med, (what, np.median(r), e_med)
            assert (r > 2 * e_med).sum() <= r.size // 16, (what, r, e_med)
    _, jcache = JM.prefill_step(jcfg, jparams, jt)
    _, tcache = M.prefill_step(tcfg, model, tt)
    for i, (tc, jc) in enumerate(zip(tcache, _jax_cache_layers(jcfg,
                                                               jcache))):
        for name in jc:
            assert str(tc[name].dtype).split(".")[-1] == str(jc[name].dtype), \
                (i, name, tc[name].dtype, jc[name].dtype)


@pytest.mark.parametrize("arch", ["rwkv6-3b", "recurrentgemma-9b",
                                  "granite-34b", "dbrx-132b",
                                  "grok-1-314b"])
def test_forward_and_prefill_match_reference(models, arch):
    """Logits, every cache entry and the MoE aux loss (summed over the
    layers; 0 without `attn_moe`, in both packages; rtol 1e-6)."""
    jcfg, jparams, tcfg, model = models[arch]
    S = 24
    toks = _tokens(jcfg, 2, S)
    jl, jaux, _ = JM.forward(jcfg, jparams, jnp.asarray(toks), mode="train")
    tl, aux = M.forward(tcfg, model, torch.tensor(toks).long())
    _close(tl, jl, "forward logits")
    assert aux.dtype == torch.float32 and aux.shape == ()
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6, atol=0)
    assert (float(aux) > 0) == ("attn_moe" in tcfg.layer_kinds)
    jl, jcache = JM.prefill_step(jcfg, jparams, jnp.asarray(toks))
    tl, tcache = M.prefill_step(tcfg, model, torch.tensor(toks).long())
    _close(tl, jl, "prefill last logits")
    jlayers = _jax_cache_layers(jcfg, jcache)
    assert len(tcache) == len(jlayers) == tcfg.num_layers
    x = M._embed_tokens(tcfg, model, torch.tensor(toks).long())
    for i, (kind, tc, jc) in enumerate(zip(tcfg.layer_kinds, tcache,
                                           jlayers)):
        assert set(tc) == set(jc), kind
        for name in jc:
            if kind == "rwkv" and name == "x_t":
                want = TB.apply_norm(tcfg, model.layers[i]["norm1"], x)[:, -1]
                _close(tc[name], want, f"layer {i} x_t = norm1(input)")
            elif kind == "local":
                _close(_unroll(tc[name], S), jc[name], f"layer {i} {name}")
            else:
                _close(tc[name], jc[name], f"layer {i} {kind} {name}")
        x, _, _ = TB.apply_layer(tcfg, kind, model.layers[i], x,
                                 mode="train",
                                 positions=torch.arange(S)[None].expand(2, S))


@pytest.mark.parametrize("arch", ["rwkv6-3b", "recurrentgemma-9b",
                                  "granite-34b", "dbrx-132b",
                                  "grok-1-314b"])
def test_decode_steps_match_reference(models, arch):
    jcfg, jparams, tcfg, model = models[arch]
    toks = _tokens(jcfg, 2, 18, seed=3)     # past the window of 16
    jcache = JM.init_cache(jcfg, 2, 32)
    tcache = M.init_cache(tcfg, 2, 32, device="cpu")
    step = _jax_decode(jcfg)
    for t in range(toks.shape[1]):
        jl, jcache = step(jparams, jcache, jnp.asarray(toks[:, t:t + 1]),
                          jnp.int32(t))
        tl, tcache = M.decode_step(tcfg, model, tcache,
                                   torch.tensor(toks[:, t:t + 1]).long(), t)
        _close(tl, jl, f"decode logits at step {t}")
    for i, (tc, jc) in enumerate(zip(tcache,
                                     _jax_cache_layers(jcfg, jcache))):
        for name in jc:
            _close(tc[name], jc[name], f"layer {i} cache {name}")


def _jax_decode(jcfg):
    return jax.jit(lambda p, c, t, pos: JM.decode_step(jcfg, p, c, t, pos))


def _continuation_error(forward_logits, prefill, decode, toks, S):
    """max |prefill-then-decode logits - forward logits| over positions
    S-1 .. end, for any package's three functions."""
    full = np.asarray(forward_logits(toks))
    last, cache = prefill(toks[:, :S])
    err = np.abs(np.asarray(last) - full[:, S - 1]).max()
    for t in range(S, toks.shape[1]):
        logits, cache = decode(cache, toks[:, t:t + 1], t)
        err = max(err, np.abs(np.asarray(logits)[:, 0] - full[:, t]).max())
    return float(err)


@pytest.mark.parametrize("arch,S", [("rwkv6-3b", 32),
                                    ("recurrentgemma-9b", 24),
                                    ("recurrentgemma-9b", 10)])
def test_prefill_then_decode_equals_forward(models, arch, S):
    """Inside the port, prefill + decode continues exactly where `forward`
    on the whole sequence is, with non-zero token-shift mixes (rwkv) and at
    S not a multiple of the window (24) or below it (10; window 16). The
    reference fails each: on a copy of the tree at these sizes its first
    rwkv logits after a 32-token prefill were off by up to 3.92, its second
    local-attention token after S = 24 by 3.59 (ROADMAP C); its error is
    computed beside the port's."""
    jcfg, jparams, tcfg, model = models[arch]
    toks = _tokens(jcfg, 2, S + 4, seed=9)
    tt = torch.tensor(toks).long()
    err = _continuation_error(
        lambda t: M.forward(tcfg, model, t)[0],
        lambda t: M.prefill_step(tcfg, model, t),
        lambda c, t, pos: M.decode_step(tcfg, model, c, t, pos), tt, S)
    assert err < 1e-4, err
    if S < jcfg.sliding_window:
        return          # the reference's decode cannot index its cache
    ref_err = _continuation_error(
        jax.jit(lambda t: JM.forward(jcfg, jparams, t)[0]),
        jax.jit(lambda t: JM.prefill_step(jcfg, jparams, t)),
        lambda c, t, pos: _jax_decode(jcfg)(jparams, c, t, jnp.int32(pos)),
        jnp.asarray(toks), S)
    assert ref_err > 1e-2, ref_err       # the fault, beside the port's err


@pytest.mark.parametrize("window", [0, 8])
def test_sdpa_with_causal_mask_matches_kernel_path(models, window):
    """`causal_mask` equals the reference's, and `_sdpa` under it (the
    decode-time formula) equals the kernel's plain version (the prefill
    path), f32."""
    from repro.nn.attention import causal_mask as jax_causal_mask
    from repro_torch.kernels.flash_attention import gqa_flash_attention
    from repro_torch.nn.attention import _sdpa, causal_mask
    np.testing.assert_array_equal(causal_mask(20, 20, window).numpy(),
                                  np.asarray(jax_causal_mask(20, 20, window)))
    tcfg = models["recurrentgemma-9b"][2]
    g = torch.Generator().manual_seed(window)
    q = torch.randn((2, 20, 4, 32), generator=g)
    k = torch.randn((2, 20, 1, 32), generator=g)
    v = torch.randn((2, 20, 1, 32), generator=g)
    _close(_sdpa(tcfg, q, k, v, causal_mask(20, 20, window)),
           gqa_flash_attention(q, k, v, window=window), "sdpa vs kernel")
