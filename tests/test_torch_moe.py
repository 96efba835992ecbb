"""The port's Mixture-of-Experts FFN (`repro_torch.nn.moe`) and its
`attn_moe` layer against the JAX package's (`repro.nn.moe`,
`repro.nn.blocks`), on the CPU at `smoke()` sizes in float32, for both
expert activations: SiLU (swiglu, dbrx-132b) and the gated tanh-GELU
(grok-1-314b, whose attention also soft-caps its logits). Inputs and
weights come from numpy (the reference's initializers, carried over by
`lm_params_from_numpy` for the layer).

Tolerances: y, layer outputs and caches at rtol = atol = 5e-4 (f32 sums
in another order, as tests/test_torch_lm_models.py); the aux loss at
1e-6 relative (f32 means of the same probabilities). Random f32 router
logits have no ties, so both packages pick the same experts. The
capacity binds where the inputs are skewed towards one expert: there the
test counts the dropped assignments with the port's own routing and
requires some."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS, smoke as jax_smoke
from repro.models import decoder_lm as JM
from repro.nn import blocks as JB
from repro.nn import moe as JMOE
from repro.nn.params import init_tree
from repro_torch.configs import ARCHS, smoke
from repro_torch.models.convert import lm_params_from_numpy
from repro_torch.nn import blocks as TB
from repro_torch.nn import moe

TOL = dict(rtol=5e-4, atol=5e-4)
ARCH_OF_MLP = {"swiglu": "dbrx-132b", "gelu": "grok-1-314b"}


def _np(a):
    return (a.detach().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(a))


def _cfgs(arch):
    return jax_smoke(JAX_ARCHS[arch]), smoke(ARCHS[arch])


def _moe_params(jcfg, seed):
    """The reference's initializers (router 'small', experts fan-in), as
    numpy f32."""
    tree = init_tree(jax.random.PRNGKey(seed), JMOE.moe_defs(jcfg),
                     "float32")
    return {k: np.asarray(v, np.float32) for k, v in tree.items()}


def _inputs(p, shape, skew, seed):
    """x ~ N(0, 1), plus (skew) a direction that adds 3 to every token's
    router logit of expert 0: most tokens then pick expert 0 first, more
    than its capacity."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)
    if skew:
        r0 = p["router"][:, 0]
        x = x + (3.0 * r0 / (r0 @ r0)).astype(np.float32)
    return x


def _drops(tcfg, p, x):
    return int((~moe.route(tcfg, p, x)[3]).sum())


@pytest.mark.parametrize("skew", [False, True], ids=["no_drops", "drops"])
@pytest.mark.parametrize("mlp", ["swiglu", "gelu"])
def test_apply_moe_matches_reference(mlp, skew):
    jcfg, tcfg = _cfgs(ARCH_OF_MLP[mlp])
    assert tcfg.mlp_kind == mlp
    p = _moe_params(jcfg, seed=1)
    x = _inputs(p, (2, 40, tcfg.d_model), skew, seed=2)
    tp = {k: torch.tensor(v) for k, v in p.items()}
    drops = _drops(tcfg, tp, torch.tensor(x))
    assert (drops > 0) == skew, drops        # C = 32 of 80 assignments a row
    jy, jaux = JMOE.apply_moe(jcfg, {k: jnp.asarray(v) for k, v in
                                     p.items()}, jnp.asarray(x))
    moe.apply_moe.drops = []
    try:
        ty, taux = moe.apply_moe(tcfg, tp, torch.tensor(x))
        (dropped, total), = moe.apply_moe.drops
    finally:
        moe.apply_moe.drops = None
    assert (int(dropped), total) == (drops, 2 * 40 * tcfg.experts_per_token)
    assert ty.dtype == torch.float32 and ty.shape == x.shape
    np.testing.assert_allclose(_np(ty), _np(jy), **TOL)
    assert taux.dtype == torch.float32 and taux.shape == ()
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6, atol=0)


@pytest.mark.parametrize("B,skew", [(8, False), (12, True)],
                         ids=["no_drops", "drops"])
@pytest.mark.parametrize("mlp", ["swiglu", "gelu"])
def test_apply_moe_decode_matches_reference(mlp, B, skew):
    """Decode routes the batch as one row, at C = 8: 8 tokens cannot
    overflow it (each names an expert at most once), 12 skewed ones do."""
    jcfg, tcfg = _cfgs(ARCH_OF_MLP[mlp])
    p = _moe_params(jcfg, seed=3)
    x = _inputs(p, (B, 1, tcfg.d_model), skew, seed=4)
    tp = {k: torch.tensor(v) for k, v in p.items()}
    assert moe._capacity(tcfg, B) == 8
    drops = _drops(tcfg, tp, torch.tensor(x).transpose(0, 1))
    assert (drops > 0) == skew, drops
    jy, jaux = JMOE.apply_moe_decode(jcfg, {k: jnp.asarray(v) for k, v in
                                            p.items()}, jnp.asarray(x))
    ty, taux = moe.apply_moe_decode(tcfg, tp, torch.tensor(x))
    assert ty.shape == x.shape
    np.testing.assert_allclose(_np(ty), _np(jy), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6, atol=0)


def test_capacity_matches_reference():
    """Per-row capacity, at smoke sizes and at the full configs (C = 640
    at the chip's prefill of 2048 tokens, 688 at its gate's 2200, 8 for a
    decode batch of 4)."""
    for arch in ARCH_OF_MLP.values():
        for jcfg, tcfg in (_cfgs(arch), (JAX_ARCHS[arch], ARCHS[arch])):
            for S in (1, 4, 5, 24, 40, 100, 2048, 2200):
                assert moe._capacity(tcfg, S) == JMOE._capacity(jcfg, S)
        full = ARCHS[arch]
        assert [moe._capacity(full, S) for S in (2048, 2200, 4)] == [
            640, 688, 8]


def test_route_orders_and_normalises():
    """Top-k in descending probability, gate weights summing to 1, slots
    counted per expert in token-major, rank-minor order."""
    jcfg, tcfg = _cfgs("dbrx-132b")
    p = {k: torch.tensor(v) for k, v in _moe_params(jcfg, seed=5).items()}
    x = torch.tensor(_inputs(_moe_params(jcfg, seed=5), (1, 40, 128), True,
                             seed=6))
    probs, gate_w, idx, keep, slot = moe.route(tcfg, p, x)
    top = torch.gather(probs, -1, idx)
    assert (top[..., :-1] >= top[..., 1:]).all()
    torch.testing.assert_close(gate_w.sum(-1), torch.ones(1, 40))
    eid = idx.reshape(1, -1)[0]
    C = moe._capacity(tcfg, 40)
    seen = {}
    for a, e in enumerate(eid.tolist()):
        n = seen.get(e, 0)
        seen[e] = n + 1
        assert bool(keep[0, a]) == (n < C) and int(slot[0, a]) == min(n,
                                                                      C - 1)


# ------------------------------------------------------------------ layer
@pytest.fixture(scope="module")
def layers():
    """Per arch: (jax cfg, jax params, port cfg, port model), 2 layers."""
    out = {}
    for arch in ARCH_OF_MLP.values():
        jcfg, tcfg = _cfgs(arch)
        jcfg = jcfg.scaled(num_layers=2)
        tcfg = tcfg.scaled(num_layers=2)
        tree = jax.tree.map(np.asarray, JM.init_params(
            jcfg, jax.random.PRNGKey(7)))
        out[arch] = (jcfg, jax.tree.map(jnp.asarray, tree), tcfg,
                     lm_params_from_numpy(tcfg, tree, device="cpu"))
    return out


def _jax_layer(jparams, r):
    return jax.tree.map(lambda a: a[r], jparams["blocks"][0])


@pytest.mark.parametrize("arch", list(ARCH_OF_MLP.values()))
def test_attn_moe_layer_full_mode_matches_reference(layers, arch):
    jcfg, jparams, tcfg, model = layers[arch]
    S = 24
    x = np.random.default_rng(8).standard_normal(
        (2, S, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S)[None], (2, S))
    jx, jc, jaux = JB.apply_layer(jcfg, "attn_moe", _jax_layer(jparams, 1),
                                  jnp.asarray(x), mode="prefill",
                                  positions=jnp.asarray(pos), aux=0.5)
    tx, tc, taux = TB.apply_layer(tcfg, "attn_moe", model.layers[1],
                                  torch.tensor(x), mode="prefill",
                                  positions=torch.tensor(pos), aux=0.5)
    np.testing.assert_allclose(_np(tx), _np(jx), **TOL)
    assert set(tc) == set(jc) == {"k", "v"}
    for name in jc:
        np.testing.assert_allclose(_np(tc[name]), _np(jc[name]), **TOL)
    assert float(taux) > 0.5                 # the layer's aux added
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6, atol=0)


@pytest.mark.parametrize("arch", list(ARCH_OF_MLP.values()))
def test_attn_moe_layer_decode_mode_matches_reference(layers, arch):
    jcfg, jparams, tcfg, model = layers[arch]
    rng = np.random.default_rng(9)
    cache = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32),
        JB.init_layer_cache(jcfg, "attn_moe", 3, 24, jnp.float32))
    x = rng.standard_normal((3, 1, jcfg.d_model)).astype(np.float32)
    jx, jc, jaux = JB.apply_layer(jcfg, "attn_moe", _jax_layer(jparams, 0),
                                  jnp.asarray(x), mode="decode",
                                  cache=jax.tree.map(jnp.asarray, cache),
                                  pos=jnp.int32(11))
    tx, tc, taux = TB.apply_layer(tcfg, "attn_moe", model.layers[0],
                                  torch.tensor(x), mode="decode", pos=11,
                                  cache={k: torch.tensor(v)
                                         for k, v in cache.items()})
    np.testing.assert_allclose(_np(tx), _np(jx), **TOL)
    for name in jc:
        np.testing.assert_allclose(_np(tc[name]), _np(jc[name]), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6, atol=0)


def test_lm_params_from_numpy_carries_stacked_experts(layers):
    """On a 2-layer dbrx smoke tree the experts sit under blocks[0]
    stacked as (R, E, d, f); layer r gets slice r of each, exactly."""
    jcfg, jparams, tcfg, model = layers["dbrx-132b"]
    stacked = jparams["blocks"][0]["moe"]
    E, d, f = tcfg.num_experts, tcfg.d_model, tcfg.d_ff
    assert stacked["w_gate"].shape == (2, E, d, f)
    assert stacked["w_down"].shape == (2, E, f, d)
    for r, layer in enumerate(model.layers):
        for name in ("router", "w_gate", "w_up", "w_down"):
            np.testing.assert_array_equal(_np(layer["moe"][name]),
                                          np.asarray(stacked[name][r]))
