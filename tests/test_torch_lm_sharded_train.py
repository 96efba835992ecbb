"""Training a placed LM (ROADMAP A item 4a): `loss_fn`, its gradients,
`placement.sync_grads` and the placed AdamW (`optim.adamw_update_`,
`launch.train.lm_train_step`, `launch.dryrun.build_train_step`) on
("data", "model") meshes of the CPU repeated: (1, 2), (2, 1), (2, 2) and
(1, 4).

This file holds the dense `attn` models and what every family shares:
gemma-7b (the tied embedding), mistral-large-123b, "mistral-hd" (16
query heads, 2 KV heads of 32: wk / wv over the head dim, the
reference's `cache_hd`, and at model 4 the KV heads whole on every
position) and "granite-exits" (granite-34b at 4 layers with exit heads
at blocks 0-2: one KV head, so wk / wv put "model" on d, and the
Inception Distillation term on the placed states); the dry run's
train-step half (`_train_cfg` against the reference's rule, the
optimizer state's shapes and specs); rwkv's half head, whose placed loss
and gradients equal the unplaced ones. `test_torch_lm_sharded_train_kinds.py` and
`test_torch_lm_sharded_train_frontends.py` run the same checks on the
MoE and recurrent kinds and on the frontend kinds.

Weights: the JAX package's, through `lm_params_from_numpy`, at
`smoke()` size in f32, with the attention projections softened, the
rwkv mixes and the xattn gates non-zero (`test_torch_lm_train._tree`).
B4 and B5 are replaced by functions that raise: a placed training step
must not reach them.

Tolerances: the placed loss and metrics against the unsharded port at
rtol 5e-5 (row-parallel products and the gradient sync add in another
order, in f32); each logical gradient (synced, gathered) within 1e-4
relative L2 of the unsharded port's and within 1e-4 of its norm of the
JAX package's `value_and_grad(loss_fn)` (`test_torch_lm_train`); the
global norm at rtol 5e-5 of the unsharded one (1.2e-5 measured); after
one AdamW step each parameter within `STEP_REL` relative L2 of the
unsharded step's, and within `SAME_STEP_REL` when the placed optimizer
is fed the unsharded gradients;
three `lm_train_step` losses at rtol 1e-4 of the unsharded port's.
Replicas of a block, and two placed runs: bit for bit."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common import AdaptiveDepthConfig as JaxAdaptive
from repro.common import TrainConfig as JaxTrainConfig
from repro.configs import ARCHS as JAX_ARCHS, smoke as jax_smoke
from repro.models import decoder_lm as JM
from repro.nn.params import count_params as jax_count_params
from repro_torch.common import AdaptiveDepthConfig, TrainConfig
from repro_torch.configs import ARCHS, get_config, smoke
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.train import lm_batch, lm_train_step
from repro_torch.models import decoder_lm as M
from repro_torch.models.convert import lm_params_from_numpy
from repro_torch.nn import attention, rwkv
from repro_torch.optim import adamw_init, adamw_update_, make_schedule
from repro_torch.optim.adamw import global_norm
from repro_torch.sharding import placement as pl
from repro_torch.sharding import use_mesh

from test_torch_lm_train import _batch, _tree

PORT = dict(rtol=5e-5, atol=5e-5)
GRAD_REL = 1e-4
NORM_RTOL = 5e-5
# after one AdamW step at LR, each parameter's relative L2 distance to the
# unsharded step's: about twice the largest measured over every family
# and mesh of these files (1.88e-4, llama-3.2-vision-11b's wk at (1, 4)).
# The first step moves each element by about lr * g / (|g| + eps), so an
# element whose gradient is as small as the gradients' rounding moves by
# another amount; fed the unsharded gradients (placed), the placed
# optimizer is within SAME_STEP_REL (7.9e-8 measured: the global norm's
# sum order changes the clip's scale in its last bit)
STEP_REL = 4e-4
SAME_STEP_REL = 5e-7
LR = 3e-3
TC = TrainConfig(learning_rate=LR, warmup_steps=1, total_steps=10,
                 weight_decay=0.01)
MESHES = [(1, 2), (2, 1), (2, 2), (1, 4)]
EXITS = dict(enabled=True, exit_layers=(0, 1, 2), t_min=0, t_max=2)
# name -> (arch, config overrides, exit heads)
CONFIGS = {
    "gemma-7b": ("gemma-7b", {}, False),
    "mistral-large-123b": ("mistral-large-123b", {}, False),
    "mistral-hd": ("mistral-large-123b",
                   dict(num_heads=16, num_kv_heads=2, head_dim=32), False),
    "granite-exits": ("granite-34b", dict(num_layers=4), True),
}
B, S = 4, 24


def mesh_of(data, model):
    return make_mesh(("cpu",) * (data * model), {"data": data,
                                                 "model": model})


def configs(arch, kw, exits):
    jcfg = dataclasses.replace(jax_smoke(JAX_ARCHS[arch]), **kw)
    tcfg = dataclasses.replace(smoke(ARCHS[arch]), **kw)
    if exits:
        jcfg = dataclasses.replace(jcfg, adaptive=JaxAdaptive(**EXITS))
        tcfg = dataclasses.replace(tcfg, adaptive=AdaptiveDepthConfig(
            **EXITS))
    return jcfg, tcfg


def module_name(path: str) -> str:
    """A placed tree's leaf path as the `DecoderLM` parameter's name."""
    return path if path.split(".")[0] in M.STACKS else f"top.{path}"


def map_named(fn, tree, prefix=""):
    """fn(path, leaf) over a nested dict / list, keeping its structure."""
    if isinstance(tree, dict):
        return {k: map_named(fn, v, f"{prefix}.{k}" if prefix else k)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_named(fn, v, f"{prefix}.{i}") for i, v in
                enumerate(tree)]
    return fn(prefix, tree)


def _no_kernels(*_, **__):
    raise AssertionError("a placed training step launched B4 or B5")


@pytest.fixture
def no_kernels(monkeypatch):
    """B4 and B5 as the layers call them replaced by functions that
    raise."""
    monkeypatch.setattr(attention, "gqa_flash_attention", _no_kernels)
    monkeypatch.setattr(rwkv, "wkv6_heads", _no_kernels)


class Reference:
    """One config's weights, batch, the JAX package's loss and gradients
    and the unsharded port's loss, gradients, global norm, one AdamW step
    and three `lm_train_step` losses, each computed once."""

    def __init__(self, configs_):
        self.configs = configs_
        self.done = {}

    def __call__(self, name):
        if name not in self.done:
            self.done[name] = self._make(name)
        return self.done[name]

    def _make(self, name):
        arch, kw, exits = self.configs[name]
        jcfg, tcfg = configs(arch, kw, exits)
        tree, raw = _tree(jcfg), _batch(jcfg, B, S)
        (jl, _), jg = jax.value_and_grad(JM.loss_fn, argnums=1,
                                         has_aux=True)(
            jcfg, jax.tree.map(jnp.asarray, tree),
            {k: jnp.asarray(v) for k, v in raw.items()})
        jgrads = dict(lm_params_from_numpy(
            tcfg, jax.tree.map(np.asarray, jg), device="cpu"
        ).named_parameters())
        batch = lm_batch(tcfg, raw, "cpu")
        model = lm_params_from_numpy(tcfg, tree, device="cpu"
                                     ).requires_grad_()
        loss, metrics = M.loss_fn(tcfg, model, batch)
        loss.backward()
        params = dict(model.named_parameters())
        grads = {n: p.grad.clone() for n, p in params.items()}
        opt = adamw_init(params, TC)
        step = adamw_update_(grads, opt, params, TC, LR)
        stepped = {n: p.detach().clone() for n, p in params.items()}
        model = lm_params_from_numpy(tcfg, tree, device="cpu"
                                     ).requires_grad_()
        opt = adamw_init(dict(model.named_parameters()), TC)
        sched = make_schedule(TC)
        losses = [float(lm_train_step(tcfg, model, opt, TC, sched, batch)[
            "loss"]) for _ in range(3)]
        return dict(jcfg=jcfg, cfg=tcfg, tree=tree, batch=batch,
                    jloss=float(jl), jgrads=jgrads, loss=loss.detach(),
                    metrics={k: v.detach() for k, v in metrics.items()},
                    grads=grads, grad_norm=step["grad_norm"],
                    stepped=stepped, losses=losses)


def placed(ref, mesh_shape):
    """The reference's weights placed trainable on a mesh."""
    model = lm_params_from_numpy(ref["cfg"], ref["tree"], device="cpu")
    mesh = mesh_of(*mesh_shape)
    return mesh, pl.shard_params(model, mesh, trainable=True)


def check_step(ref, mesh_shape, what):
    """The placed loss, gradients, sync and one AdamW step against the
    unsharded port and the JAX package (module docstring)."""
    cfg = ref["cfg"]
    mesh, params = placed(ref, mesh_shape)
    with use_mesh(mesh) as scope:
        loss, metrics = M.loss_fn(cfg, params, ref["batch"])
        loss.backward()
        grads = pl.sync_grads(params)
    loss = loss.detach()
    np.testing.assert_allclose(float(loss), float(ref["loss"]), err_msg=what,
                               **PORT)
    np.testing.assert_allclose(float(loss), ref["jloss"], rtol=1e-5,
                               err_msg=what)
    assert set(metrics) == set(ref["metrics"])
    for k, v in ref["metrics"].items():
        np.testing.assert_allclose(float(metrics[k].detach()), float(v),
                                   err_msg=f"{what} {k}", **PORT)
    assert scope.exchange["grad_sync"]["copies"] > 0
    assert all(b.grad is None for _, st in pl.named_leaves(params)
               for b in st.locals)
    for (path, st), (_, p) in zip(pl.named_leaves(grads),
                                  pl.named_leaves(params)):
        name = module_name(path)
        assert st.spec == p.spec
        assert pl.copies_equal(st), f"{what} {name}: replicas differ"
        g, want, jwant = pl.gather(st), ref["grads"][name], \
            ref["jgrads"][name]
        assert float(want.norm()) > 0, name
        err = float((g - want).norm())
        assert err <= GRAD_REL * float(want.norm()), (what, name, err)
        jerr = float((g - jwant).norm())
        assert jerr <= GRAD_REL * float(jwant.norm()) + 1e-12, (what, name,
                                                                jerr)
    np.testing.assert_allclose(float(global_norm(grads)),
                               float(ref["grad_norm"]), rtol=NORM_RTOL,
                               err_msg=what)
    opt = adamw_init(params, TC)
    for (_, p), (_, mu) in zip(pl.named_leaves(params),
                               pl.named_leaves(opt["mu"])):
        assert mu.spec == p.spec and mu.dtype == torch.float32
    m = adamw_update_(grads, opt, params, TC, LR)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(ref["grad_norm"]), rtol=NORM_RTOL)
    for (path, st), (_, mu), (_, nu) in zip(
            pl.named_leaves(params), pl.named_leaves(opt["mu"]),
            pl.named_leaves(opt["nu"])):
        name = module_name(path)
        assert pl.copies_equal((st, mu, nu)), f"{what} {name}"
        want = ref["stepped"][name]
        err = float((pl.gather(st).detach() - want).norm())
        assert err <= STEP_REL * float(want.norm()) + 1e-12, (what, name,
                                                              err)
    # the optimizer alone: the unsharded gradients placed as the
    # parameters, one step on a fresh placement
    _, fresh = placed(ref, mesh_shape)
    same = map_named(lambda path, st: pl.shard(
        ref["grads"][module_name(path)], st.sharding), fresh)
    opt = adamw_init(fresh, TC)
    adamw_update_(same, opt, fresh, TC, LR)
    for path, st in pl.named_leaves(fresh):
        name = module_name(path)
        want = ref["stepped"][name]
        err = float((pl.gather(st).detach() - want).norm())
        assert err <= SAME_STEP_REL * float(want.norm()) + 1e-12, (
            what, name, err)


REFERENCE = Reference(CONFIGS)


@pytest.mark.parametrize("mesh_shape", MESHES)
@pytest.mark.parametrize("name", list(CONFIGS))
def test_placed_step_matches_the_port_and_the_reference(name, mesh_shape,
                                                        no_kernels):
    check_step(REFERENCE(name), mesh_shape, f"{name} on {mesh_shape}")


def three_steps(ref, mesh_shape, what):
    """Three `build_train_step` steps (`lm_train_step`) on the placed
    tree: the losses against the unsharded port's, every copy of every
    block (parameters and moments) equal after each step."""
    cfg = ref["cfg"]
    step, tc = dryrun.build_train_step(
        cfg, learning_rate=TC.learning_rate, warmup_steps=TC.warmup_steps,
        total_steps=TC.total_steps, weight_decay=TC.weight_decay)
    assert tc == TC
    mesh, params = placed(ref, mesh_shape)
    opt = adamw_init(params, tc)
    losses = []
    with use_mesh(mesh):
        for _ in range(3):
            params, opt, m = step(params, opt, ref["batch"])
            losses.append(float(m["loss"]))
            for tree in (params, opt["mu"], opt["nu"]):
                assert pl.copies_equal(tree), what
    assert int(opt["count"]) == 3
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-4,
                               err_msg=what)


@pytest.mark.parametrize("name", ["gemma-7b", "granite-exits"])
def test_three_placed_steps_keep_replicas_equal(name, no_kernels):
    three_steps(REFERENCE(name), (2, 2), name)


def test_two_placed_runs_are_bitwise_equal():
    ref = REFERENCE("granite-exits")
    out = []
    for _ in range(2):
        mesh, params = placed(ref, (2, 2))
        with use_mesh(mesh):
            loss, _ = M.loss_fn(ref["cfg"], params, ref["batch"])
            loss.backward()
            out.append((loss.detach(), pl.sync_grads(params)))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    for (_, a), (_, b) in zip(pl.named_leaves(g0), pl.named_leaves(g1)):
        assert all(torch.equal(x, y) for x, y in zip(a.locals, b.locals))


@pytest.mark.parametrize("mesh_shape", [(1, 2), (2, 2)])
def test_collect_states_on_a_mesh_equals_the_unplaced_states(mesh_shape):
    """Placed states (the batch over "data"), gathered, against the
    unplaced forward's, with and without autograd; remat changes no
    bit."""
    ref = REFERENCE("granite-exits")
    cfg, toks = ref["cfg"], ref["batch"]["tokens"]
    model = lm_params_from_numpy(cfg, ref["tree"], device="cpu")
    _, _, want = M.forward(cfg, model, toks, collect_states=True)
    mesh, params = placed(ref, mesh_shape)
    with use_mesh(mesh):
        runs = [M.forward(cfg, params, toks, collect_states=True,
                          differentiable=d, remat=r)
                for d, r in ((False, True), (True, True), (True, False))]
    for logits, _, states in runs:
        assert len(states) == len(want) == cfg.pattern_repeats
        for s, w in zip(states, want):
            assert pl.is_sharded(s) and s.spec[0] == "data"
            np.testing.assert_allclose(pl.gather(s).detach(), w, **PORT)
    assert all(torch.equal(a.detach(), b.detach()) for a, b in
               zip(runs[1][2][0].locals, runs[2][2][0].locals))


def test_global_norm_counts_each_block_once():
    """A replicated leaf's copies count once: the placed norm equals the
    global tensor's, not the sum over every position's block."""
    mesh = mesh_of(2, 2)
    g = torch.Generator().manual_seed(0)
    tree = {"rep": torch.randn((6, 4), generator=g),
            "col": torch.randn((4, 8), generator=g),
            "both": torch.randn((4, 8), generator=g)}
    specs = {"rep": pl.P(None, None), "col": pl.P(None, "model"),
             "both": pl.P("data", "model")}
    placed_ = {k: pl.shard(t, pl.NamedSharding(mesh, specs[k]))
               for k, t in tree.items()}
    np.testing.assert_allclose(float(global_norm(placed_)),
                               float(global_norm(tree)), rtol=1e-6)
    blind = torch.sqrt(sum(torch.sum(b * b) for t in placed_.values()
                           for b in t.locals))
    assert float(blind) > 1.2 * float(global_norm(tree))


def test_sync_grads_sums_over_the_free_axes():
    """Each copy of a block ends with the f32 sum of every copy's
    gradient over the axes its spec leaves free, in position order; a
    block held once keeps its own; the exchange counts the copies."""
    mesh = mesh_of(2, 2)
    specs = {"rep": pl.P(None, None), "col": pl.P(None, "model"),
             "both": pl.P("data", "model")}
    tree = {k: pl.wrap([torch.zeros((2, 2), dtype=torch.bfloat16)
                        for _ in range(4)], s_, mesh)
            for k, s_ in specs.items()}
    for k, st in tree.items():
        for i, b in enumerate(st.locals):
            b.grad = torch.full((2, 2), float(i + 1), dtype=torch.bfloat16)
            b.grad[0, 0] = 2.0 ** -9 if i else 1.0   # rounds in bf16 sums
    with use_mesh(mesh) as scope:
        out = pl.sync_grads(tree)
    # rep: all four; col: over data (positions 0+2, 1+3); both: its own
    want = {"rep": [[0, 1, 2, 3]] * 4, "col": [[0, 2], [1, 3]] * 2,
            "both": [[i] for i in range(4)]}
    for k, st in out.items():
        for i, b in enumerate(st.locals):
            group = want[k][i]
            acc = torch.zeros((2, 2))
            for j in group:
                g = torch.full((2, 2), float(j + 1))
                g[0, 0] = 2.0 ** -9 if j else 1.0
                acc += g
            assert b.dtype == torch.bfloat16
            assert torch.equal(b, acc.to(torch.bfloat16)), (k, i)
    assert scope.exchange["grad_sync"] == dict(calls=2, copies=16,
                                               bytes=16 * 8)
    assert pl.copies_equal(out)
    out["col"].locals[2][1, 1] += 1.0          # position 0's block's copy
    assert not pl.copies_equal(out)
    assert all(b.grad is None for st in tree.values() for b in st.locals)


def test_rwkv_half_head_trains():
    """rwkv6-3b smoke's 2 heads at model 4 (half a head a position): the
    placed `loss_fn` regroups the columns into whole (batch row, head)
    pairs, and its loss and synced gradients equal the unplaced ones."""
    cfg = smoke(ARCHS["rwkv6-3b"])
    seq = torch.randint(0, cfg.vocab_size, (2, 16),
                        generator=torch.Generator().manual_seed(2))
    model = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with torch.no_grad():
        for p in model.layers:
            for n in ("mu_r", "mu_k", "mu_v", "mu_g", "mu_w"):
                p["tmix"][n].uniform_(0.1, 0.9)
    params = pl.shard_params(model, mesh_of(1, 4), trainable=True)
    model.requires_grad_()
    want, _ = M.loss_fn(cfg, model, {"tokens": seq})
    want.backward()
    with use_mesh(mesh_of(1, 4)):
        loss, _ = M.loss_fn(cfg, params, {"tokens": seq})
        loss.backward()
        grads = pl.sync_grads(params)
    np.testing.assert_allclose(float(loss.detach()), float(want.detach()),
                               **PORT)
    for (path, st) in pl.named_leaves(grads):
        g0 = dict(model.named_parameters())[module_name(path)].grad
        assert float((pl.gather(st) - g0).norm()) <= GRAD_REL * float(
            g0.norm()) + 1e-12, path


# ------------------------------------------------------------- the dry run
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_train_cfg_follows_the_reference_rule(arch):
    """bf16 moments above 60e9 parameters, f32 below, by the reference's
    count of its own `model_defs` (`repro.launch.dryrun._train_cfg`,
    which sets XLA_FLAGS at import and is not imported here); every
    other field the reference's default."""
    n = jax_count_params(JM.model_defs(JAX_ARCHS[arch]))
    tc = dryrun._train_cfg(get_config(arch))
    assert tc.moment_dtype == ("bfloat16" if n > 60e9 else "float32")
    ref = dataclasses.asdict(JaxTrainConfig(moment_dtype=tc.moment_dtype))
    assert dataclasses.asdict(tc) == ref


@pytest.mark.parametrize("arch", ["granite-34b", "grok-1-314b"])
def test_opt_state_shapes_and_specs(arch):
    """`abstract_opt_state` shapes the moments as the parameters in the
    moment dtype; `opt_state_specs` gives each moment its parameter's
    spec; the moments of a placed smoke model are placed so."""
    cfg = get_config(arch)
    tc = dryrun._train_cfg(cfg)
    ab = dryrun.abstract_opt_state(cfg, tc)
    specs = dryrun.opt_state_specs(cfg)
    params_ab, params_specs = M.abstract_params(cfg), M.param_specs(cfg)
    assert ab["count"].dtype == torch.int32 and ab["count"].shape == ()
    assert specs["count"] == pl.P()
    for key in ("mu", "nu"):
        got = list(pl.named_leaves(ab[key]))
        want = list(pl.named_leaves(params_ab))
        assert [p for p, _ in got] == [p for p, _ in want]
        assert all(t.shape == w.shape and t.device.type == "meta"
                   and t.dtype == getattr(torch, tc.moment_dtype)
                   for (_, t), (_, w) in zip(got, want))
        assert list(pl.named_leaves(specs[key])) == list(
            pl.named_leaves(params_specs))
    small = smoke(ARCHS[arch])
    model = M.init_params(small, torch.Generator().manual_seed(0), "cpu")
    params = pl.shard_params(model, mesh_of(2, 2), trainable=True)
    opt = adamw_init(params, dryrun._train_cfg(small))
    for (path, p), (_, mu), (_, nu) in zip(pl.named_leaves(params),
                                           pl.named_leaves(opt["mu"]),
                                           pl.named_leaves(opt["nu"])):
        assert mu.spec == nu.spec == p.spec and mu.shape == p.shape, path
        assert all(b.requires_grad for b in p.locals)
