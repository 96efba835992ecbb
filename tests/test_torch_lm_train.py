"""The port's LM training path against the JAX package, on the CPU at
`smoke()` sizes (float32): `loss_fn`'s value and gradients against
`jax.value_and_grad(loss_fn)` for every layer kind and for granite with
exit heads, `transformer_inception_loss`, `synthetic_stream`, remat,
the in-place AdamW, a few training steps against the reference's loop,
the loss falling over 40 steps, and B4 / B5 refusing inputs that
require grad.

Weights come from the JAX package's `init_params` and go across through
`lm_params_from_numpy`, with non-zero rwkv token-shift mixes and xattn
gates (which the initializer leaves at 0, hiding those paths) and the
attention projections scaled to a fan-in of d_model (`_soft_attention`):
the initializer takes their fan-in from the heads axis, so random q.k
logits are large and the softmax is near a hard max, where two f32 sums
in another order move granite smoke's gradients by ~3% (measured). With
the softer projections they agree to ~1.5e-6.

Tolerances: the loss within 1e-5 relative and each gradient within
1e-4 relative L2 (f32 sums in another order through the layers and
their backward passes); training losses within 1e-4 relative.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common import AdaptiveDepthConfig as JaxAdaptive
from repro.common import TrainConfig as JaxTrainConfig
from repro.configs import ARCHS as JAX_ARCHS, smoke as jax_smoke
from repro.core.inception_distill import \
    transformer_inception_loss as jax_inception_loss
from repro.data import synthetic_stream as jax_stream
from repro.models import decoder_lm as JM
from repro.optim import adamw_init as jax_adamw_init
from repro.optim import adamw_update as jax_adamw_update
from repro.optim import make_schedule as jax_schedule
from repro_torch.common import AdaptiveDepthConfig, TrainConfig
from repro_torch.configs import ARCHS, smoke
from repro_torch.core.inception_distill import transformer_inception_loss
from repro_torch.data import synthetic_stream
from repro_torch.launch.train import lm_batch, lm_train_step
from repro_torch.models import decoder_lm as M
from repro_torch.models.convert import lm_params_from_numpy
from repro_torch.optim import (adamw_init, adamw_update, adamw_update_,
                               make_schedule)

from test_torch_encdec import _with_gates
from test_torch_lm_models import _soft_attention, _with_mixes

EXITS = dict(enabled=True, exit_layers=(0, 1, 2), t_min=0, t_max=2)


def _configs(arch, layers=None, exits=False):
    jcfg, tcfg = jax_smoke(JAX_ARCHS[arch]), smoke(ARCHS[arch])
    if layers:
        jcfg = dataclasses.replace(jcfg, num_layers=layers)
        tcfg = dataclasses.replace(tcfg, num_layers=layers)
    if exits:
        jcfg = dataclasses.replace(jcfg, adaptive=JaxAdaptive(**EXITS))
        tcfg = dataclasses.replace(tcfg, adaptive=AdaptiveDepthConfig(
            **EXITS))
    return jcfg, tcfg


def _tree(jcfg, seed=1):
    tree = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(
        seed)))
    return _soft_attention(jcfg, _with_gates(_with_mixes(tree)))


def _batch(jcfg, B=2, S=24, seed=0):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, jcfg.vocab_size, (B, S)).astype(
        np.int32)}
    if jcfg.is_encdec or jcfg.num_image_tokens:
        n = jcfg.encoder_seq if jcfg.is_encdec else jcfg.num_image_tokens
        out["frontend"] = rng.standard_normal(
            (B, n, jcfg.d_model)).astype(np.float32)
    return out


def _port_loss(tcfg, model, batch, remat=True):
    loss, metrics = M.loss_fn(tcfg, model, lm_batch(tcfg, batch, "cpu"),
                              remat=remat)
    loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return loss.detach(), metrics, grads


# ------------------------------------------------------------------- loss
@pytest.mark.parametrize("arch,layers,exits", [
    ("rwkv6-3b", 2, False),               # rwkv
    ("recurrentgemma-9b", None, False),   # rglru + local
    ("granite-34b", None, False),         # attn
    ("dbrx-132b", 2, False),              # attn_moe (aux loss)
    ("llama-3.2-vision-11b", None, False),    # attn + xattn
    ("whisper-small", None, False),       # encdec + the enc encoder
    ("granite-34b", 4, True),             # exit heads + inception term
], ids=lambda v: str(v))
def test_loss_and_gradients_match_reference(arch, layers, exits):
    jcfg, tcfg = _configs(arch, layers, exits)
    tree = _tree(jcfg)
    batch = _batch(jcfg)
    (jl, jm), jg = jax.value_and_grad(JM.loss_fn, argnums=1, has_aux=True)(
        jcfg, jax.tree.map(jnp.asarray, tree),
        {k: jnp.asarray(v) for k, v in batch.items()})
    model = lm_params_from_numpy(tcfg, tree, device="cpu").requires_grad_()
    loss, metrics, grads = _port_loss(tcfg, model, batch)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    assert set(metrics) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(metrics[k]), float(jm[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    want = lm_params_from_numpy(tcfg, jax.tree.map(np.asarray, jg),
                                device="cpu")
    for name, g in want.named_parameters():
        err = float((grads[name] - g).norm())
        assert err <= 1e-4 * float(g.norm()) + 1e-12, (name, err,
                                                        float(g.norm()))


def test_transformer_inception_loss_matches_reference():
    """The loss and its gradients with respect to the block states, the
    trunk logits and the exit parameters, on random inputs."""
    jcfg, tcfg = _configs("granite-34b", 4, exits=True)
    tree = _tree(jcfg)
    rng = np.random.default_rng(3)
    B, S, d, V = 2, 10, jcfg.d_model, jcfg.vocab_size
    states = rng.standard_normal((4, B, S, d)).astype(np.float32)
    logits = (3 * rng.standard_normal((B, S, V))).astype(np.float32)
    labels = rng.integers(0, V, (B, S - 1)).astype(np.int32)

    def jfn(st, lg, ex):
        params = dict(jax.tree.map(jnp.asarray, tree), exits=ex)
        return jax_inception_loss(jcfg, params, st, lg, jnp.asarray(labels))

    (jl, jm), jg = jax.value_and_grad(jfn, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(states), jnp.asarray(logits),
        jax.tree.map(jnp.asarray, tree["exits"]))
    model = lm_params_from_numpy(tcfg, tree, device="cpu").requires_grad_()
    st = torch.tensor(states, requires_grad=True)
    lg = torch.tensor(logits, requires_grad=True)
    loss, metrics = transformer_inception_loss(
        tcfg, model, list(st), lg, torch.tensor(labels).long())
    loss.backward()
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["inception_loss"]), float(jl),
                               rtol=1e-5)
    for got, want in ((st.grad, jg[0]), (lg.grad, jg[1])) + tuple(
            (model["exits"][k].grad, jg[2][k]) for k in jg[2]):
        want = torch.tensor(np.asarray(want))
        assert float((got - want).norm()) <= 1e-4 * float(want.norm())


# -------------------------------------------------------------------- data
@pytest.mark.parametrize("arch", ["granite-34b", "whisper-small",
                                  "llama-3.2-vision-11b"])
def test_synthetic_stream_equals_reference(arch):
    jcfg, tcfg = jax_smoke(JAX_ARCHS[arch]), smoke(ARCHS[arch])
    ours, ref = (synthetic_stream(7, 3, 20, tcfg.vocab_size, tcfg),
                 jax_stream(7, 3, 20, jcfg.vocab_size, jcfg))
    for _ in range(3):
        a, b = next(ours), next(ref)
        assert set(a) == set(b)
        for k in b:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


# ------------------------------------------------------------ remat, adamw
def test_remat_equals_no_remat():
    """Per-block rematerialisation gives the same loss and gradients bit
    for bit (same operations, recomputed in the backward pass)."""
    jcfg, tcfg = _configs("granite-34b", 4, exits=True)
    model = lm_params_from_numpy(tcfg, _tree(jcfg), device="cpu"
                                 ).requires_grad_()
    batch = _batch(jcfg)
    l1, _, g1 = _port_loss(tcfg, model, batch, remat=True)
    l0, _, g0 = _port_loss(tcfg, model, batch, remat=False)
    assert torch.equal(l1, l0)
    assert all(torch.equal(g1[k], g0[k]) for k in g0)


@pytest.mark.parametrize("dtype,moments,clip", [
    ("float32", "float32", 1.0), ("bfloat16", "float32", 1.0),
    ("bfloat16", "bfloat16", 0.0)])
def test_inplace_adamw_is_bit_equal_to_adamw_update(dtype, moments, clip):
    tc = TrainConfig(learning_rate=3e-3, warmup_steps=2, total_steps=10,
                     weight_decay=0.01, grad_clip=clip,
                     moment_dtype=moments)
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(0)
    shapes = {"a": (7, 5), "b": (13,), "c": ()}
    params = {k: torch.randn(s, generator=g).to(dt) for k, s in
              shapes.items()}
    ours = {k: p.clone() for k, p in params.items()}
    state = adamw_init(params, tc)
    state_ = adamw_init(ours, tc)
    sched = make_schedule(tc)
    for _ in range(4):
        grads = {k: (3 * torch.randn(s, generator=g)).to(dt)
                 for k, s in shapes.items()}
        before = {k: p.clone() for k, p in params.items()}
        mu_before = {k: m.clone() for k, m in state["mu"].items()}
        old_state, old_params = state, params
        params, state, m = adamw_update(grads, state, params, tc,
                                        sched(state["count"]))
        # the functional update leaves its inputs as they were
        assert all(torch.equal(old_params[k], before[k]) for k in shapes)
        assert all(torch.equal(old_state["mu"][k], mu_before[k])
                   for k in shapes)
        m_ = adamw_update_(grads, state_, ours, tc, sched(state_["count"]))
        assert torch.equal(m["grad_norm"], m_["grad_norm"])
        assert torch.equal(state["count"], state_["count"])
        for k in shapes:
            assert torch.equal(params[k], ours[k]), k
            assert torch.equal(state["mu"][k], state_["mu"][k]), k
            assert torch.equal(state["nu"][k], state_["nu"][k]), k


# ---------------------------------------------------------------- training
def test_training_steps_match_reference():
    """5 steps of the reference's jitted loop (loss_fn, adamw_update,
    the cosine schedule) and of `lm_train_step` (in-place AdamW) from the
    same weights on the same stream: every step's loss within 1e-4
    relative, granite smoke with exit heads."""
    jcfg, tcfg = _configs("granite-34b", 4, exits=True)
    tree = _tree(jcfg)
    kw = dict(learning_rate=3e-3, warmup_steps=1, total_steps=5,
              weight_decay=0.01)
    jtc, tc = JaxTrainConfig(**kw), TrainConfig(**kw)
    jparams = jax.tree.map(jnp.asarray, tree)
    jopt = jax_adamw_init(jparams, jtc)
    jsched = jax_schedule(jtc)

    @jax.jit
    def jstep(params, opt, tokens):
        (loss, _), grads = jax.value_and_grad(JM.loss_fn, argnums=1,
                                              has_aux=True)(
            jcfg, params, {"tokens": tokens})
        params, opt, _ = jax_adamw_update(grads, opt, params, jtc,
                                          jsched(opt["count"]))
        return params, opt, loss

    model = lm_params_from_numpy(tcfg, tree, device="cpu").requires_grad_()
    opt = adamw_init(dict(model.named_parameters()), tc)
    sched = make_schedule(tc)
    stream = synthetic_stream(0, 4, 32, tcfg.vocab_size)
    for _ in range(5):
        raw = next(stream)
        jparams, jopt, jl = jstep(jparams, jopt, jnp.asarray(raw["tokens"]))
        m = lm_train_step(tcfg, model, opt, tc, sched,
                          lm_batch(tcfg, raw, "cpu"))
        np.testing.assert_allclose(float(m["loss"]), float(jl), rtol=1e-4)


def test_lm_training_loss_decreases():
    """40 steps on the synthetic Markov stream reduce the loss by more
    than 0.5 (the reference's test_lm_training_loss_decreases: gemma-7b
    smoke, lr 3e-3, 5 warmup steps, batch 8 x 64)."""
    cfg = smoke(ARCHS["gemma-7b"])
    tc = TrainConfig(learning_rate=3e-3, warmup_steps=5, total_steps=40,
                     schedule="cosine", weight_decay=0.01)
    model = M.init_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu").requires_grad_()
    opt = adamw_init(dict(model.named_parameters()), tc)
    sched = make_schedule(tc)
    stream = synthetic_stream(0, 8, 64, cfg.vocab_size)
    losses = [float(lm_train_step(cfg, model, opt, tc, sched, lm_batch(
        cfg, next(stream), "cpu"))["loss"]) for _ in range(40)]
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.5, losses[::8]


# ---------------------------------------------------------- no backward
def test_kernels_refuse_inputs_that_require_grad():
    """B4 and B5 (and, on the CPU, their plain versions in their place)
    have no backward: with grad mode on, an input that requires grad
    raises; under no_grad, or with no input requiring grad, they run.
    So do the layers that call them, unless asked for the
    differentiable path."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.wkv6 import wkv6, wkv6_heads
    from repro_torch.nn import blocks as TB
    q = torch.randn((1, 128, 2, 32), requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention(q, q, q)
    r = torch.zeros((2, 16, 16), requires_grad=True)
    u = torch.zeros((2, 16))
    with pytest.raises(RuntimeError, match="no backward"):
        wkv6(r, r, r, r, u)
    with pytest.raises(RuntimeError, match="no backward"):
        wkv6_heads(*(torch.zeros((1, 5, 2, 16), requires_grad=True),) * 4,
                   u)
    with torch.no_grad():
        flash_attention(q, q, q)
        wkv6(r, r, r, r, u)
    flash_attention(q.detach(), q.detach(), q.detach())
    for arch in ("granite-34b", "rwkv6-3b"):
        cfg = smoke(ARCHS[arch])
        model = M.init_params(cfg, torch.Generator().manual_seed(0),
                              device="cpu").requires_grad_()
        x = torch.randn((1, 16, cfg.d_model))
        pos = torch.arange(16)[None]
        kind = cfg.layer_kinds[0]
        with pytest.raises(RuntimeError, match="no backward"):
            TB.apply_layer(cfg, kind, model.layers[0], x, positions=pos)
        y, _, _ = TB.apply_layer(cfg, kind, model.layers[0], x,
                                 positions=pos, differentiable=True)
        y.sum().backward()
        assert all(p.grad is not None
                   for p in model.layers[0].parameters())
