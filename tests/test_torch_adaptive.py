"""The port's adaptive-depth decoding against the JAX package, on the CPU
at `smoke()` sizes (float32): `exit_logits`, `adaptive_decode_step` at
four thresholds, the reference's fault 5 (ROADMAP C.6) beside the
port's repair, and the adaptive `LMServingEngine`.

The model is granite-34b smoke at 4 layers with exit heads at blocks 0,
1 and 2, t_min 0 and t_max 2 (the reference's own adaptive tests), so
every block a token may exit at carries a head and the port must give
the reference's exits exactly. Weights come from the JAX package's
`init_params` through `lm_params_from_numpy`, the attention projections
softened as in tests/test_torch_lm_train.py, the exit adapters drawn at
unit fan-in scale so that the exit heads' logits differ from the
trunk's.

Tolerances: logits and saturation distances within 1e-5 (f32, the same
layers summed in another order); exit blocks and the FLOPs share equal,
with no saturation distance within 1e-4 of the threshold (checked).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common import AdaptiveDepthConfig as JaxAdaptive
from repro.configs import ARCHS as JAX_ARCHS, smoke as jax_smoke
from repro.core.adaptive_depth import adaptive_decode_step as jax_adaptive
from repro.models import decoder_lm as JM
from repro.nn import blocks as JB
from repro.nn.basic import apply_norm as jax_norm
from repro.serving.lm_engine import LMServingEngine as JaxLMEngine
from repro_torch.common import AdaptiveDepthConfig
from repro_torch.configs import ARCHS, smoke
from repro_torch.core.adaptive_depth import adaptive_decode_step
from repro_torch.models import decoder_lm as M
from repro_torch.models.convert import lm_params_from_numpy
from repro_torch.serving import LMServingEngine

from test_torch_lm_models import _soft_attention

TOL = dict(rtol=1e-5, atol=1e-5)


def _pair(t_s=0.9, exit_layers=(0, 1, 2), t_min=0, t_max=2, layers=4):
    kw = dict(enabled=True, exit_layers=exit_layers, t_s=t_s, t_min=t_min,
              t_max=t_max)
    jcfg = dataclasses.replace(jax_smoke(JAX_ARCHS["granite-34b"]),
                               num_layers=layers,
                               adaptive=JaxAdaptive(**kw))
    tcfg = dataclasses.replace(smoke(ARCHS["granite-34b"]),
                               num_layers=layers,
                               adaptive=AdaptiveDepthConfig(**kw))
    tree = _soft_attention(jcfg, jax.tree.map(
        np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(3))))
    rng = np.random.default_rng(4)
    n, d = len(exit_layers), jcfg.d_model
    tree["exits"]["adapter"] = (rng.standard_normal((n, d, d))
                                / np.sqrt(d)).astype(np.float32)
    return (jcfg, jax.tree.map(jnp.asarray, tree), tcfg,
            lm_params_from_numpy(tcfg, tree, device="cpu"))


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def test_exit_logits_matches_reference():
    jcfg, jparams, tcfg, model = _pair()
    state = np.random.default_rng(0).standard_normal(
        (3, 5, jcfg.d_model)).astype(np.float32)
    for i in range(3):
        got = M.exit_logits(tcfg, model, torch.tensor(state), i)
        want = JM.exit_logits(jcfg, jparams, jnp.asarray(state), i)
        np.testing.assert_allclose(_np(got), _np(want), **TOL)


def _decode_both(t_s, steps=4, **kw):
    """`steps` adaptive decode steps from a fresh cache in both packages,
    the same tokens fed to both; returns the per-step (port, reference)
    outputs."""
    jcfg, jparams, tcfg, model = _pair(t_s=t_s, **kw)
    B = 5
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size,
                                             (steps, B, 1)).astype(np.int32)
    jcache = JM.init_cache(jcfg, B, 16)
    tcache = M.init_cache(tcfg, B, 16, device="cpu")
    out = []
    for pos in range(steps):
        jl, jcache, ji = jax_adaptive(jcfg, jparams, jcache,
                                      jnp.asarray(toks[pos]), jnp.int32(pos))
        tl, tcache, ti = adaptive_decode_step(
            tcfg, model, tcache, torch.tensor(toks[pos]).long(), pos)
        out.append(((tl, ti), (jl, ji)))
    return (jcfg, jparams, tcfg, model), out


@pytest.mark.parametrize("t_s", [0.0, 0.6, 0.9, 1e9])
def test_adaptive_decode_step_matches_reference(t_s):
    _, out = _decode_both(t_s)
    blocks = set()
    for (tl, ti), (jl, ji) in out:
        sat = _np(ji["saturation"])
        assert not np.any(np.abs(sat - t_s) <= 1e-4 * max(t_s, 1e-9)), sat
        np.testing.assert_array_equal(_np(ti["exit_block"]),
                                      _np(ji["exit_block"]))
        np.testing.assert_allclose(_np(ti["saturation"]), sat, **TOL)
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
        assert float(ti["flops_saved_frac"]) == float(ji["flops_saved_frac"])
        blocks |= set(_np(ti["exit_block"]).tolist())
    # the thresholds span the dial: no exit, mixed depths (0.6 on these
    # weights), all at t_min
    assert blocks == {0.0: {-1}, 1e9: {0}}.get(t_s, blocks)
    if t_s == 0.6:
        assert len(blocks) >= 3, blocks


def test_fault5_exit_at_a_block_without_a_head():
    """Exit heads at blocks 0 and 2, t_min 1, t_max 3, t_s 1e9: the
    reference lets every token exit at block 1, which has no head, and
    classifies it by the trunk head on the state frozen after block 1
    (its fault 5); the port lets it exit only at block 2, by head 1 on
    the state after block 2. The reference's output is held beside the
    port's: each equals what its rule computes, and the two differ."""
    kw = dict(exit_layers=(0, 2), t_min=1, t_max=3)
    (jcfg, jparams, tcfg, model), out = _decode_both(1e9, steps=1, **kw)
    (tl, ti), (jl, ji) = out[0]
    assert (_np(ji["exit_block"]) == 1).all()       # no head at block 1
    assert (_np(ti["exit_block"]) == 2).all()
    np.testing.assert_allclose(float(ji["flops_saved_frac"]), 0.5)
    np.testing.assert_allclose(float(ti["flops_saved_frac"]), 0.25)
    # the states after blocks 1 and 2 of the first decode step
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size,
                                             (1, 5, 1)).astype(np.int32)[0]
    cache = JM.init_cache(jcfg, 5, 16)
    x = JM._embed_tokens(jcfg, jparams, jnp.asarray(toks),
                         jnp.zeros((5, 1), jnp.int32))
    states = []
    for r in range(3):
        p = jax.tree.map(lambda a: a[r], jparams["blocks"][0])
        c = jax.tree.map(lambda a: a[r], cache["blocks"][0])
        x, _, _ = JB.apply_layer(jcfg, "attn", p, x, mode="decode", cache=c,
                                 pos=jnp.int32(0))
        states.append(x)
    trunk_on_frozen = JM._project_logits(
        jcfg, jparams, jax_norm(jcfg, jparams["final_norm"], states[1]))
    np.testing.assert_allclose(_np(jl), _np(trunk_on_frozen), **TOL)
    head_after_2 = JM.exit_logits(jcfg, jparams, states[2], 1)
    np.testing.assert_allclose(_np(tl), _np(head_after_2), **TOL)
    assert float(np.abs(_np(tl) - _np(jl)).max()) > 0.1


@pytest.mark.parametrize("t_s", [0.6, 1e9])
def test_adaptive_engine_matches_reference(t_s):
    """The same 5 requests (3 slots, max_len 32) through both packages'
    engines with adaptive depth on: the same tokens per request and the
    same mean depth-FLOPs share saved."""
    jcfg, jparams, tcfg, model = _pair(t_s=t_s)
    prompts = [[1 + i, 2, 3 + 2 * i] for i in range(5)]
    engines = (JaxLMEngine(jcfg, jparams, slots=3, max_len=32,
                           adaptive=True),
               LMServingEngine(tcfg, model, slots=3, max_len=32,
                               adaptive=True, device="cpu"))
    stats = []
    for eng in engines:
        assert eng.adaptive
        for p in prompts:
            eng.submit(p, max_new=4)
        stats.append(eng.run_until_drained())
    ref = {r.rid: r.out for r in engines[0].completed}
    got = {r.rid: r.out for r in engines[1].completed}
    assert got == ref and len(got) == 5
    assert stats[1]["ticks"] == stats[0]["ticks"]
    np.testing.assert_allclose(stats[1]["mean_depth_flops_saved"],
                               stats[0]["mean_depth_flops_saved"],
                               rtol=1e-6)
    assert stats[1]["mean_depth_flops_saved"] > 0.0
    # per tick, to f32 rounding (the reference rounds 1 - 1.0 to -3e-8)
    assert engines[1].flops_saved == pytest.approx(engines[0].flops_saved,
                                                   abs=1e-6)
