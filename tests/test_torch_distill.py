"""The port's trainer against the JAX package's: the Inception
Distillation losses and their gradients, the AdamW update and schedules,
training dropout, one `_fit`, `train_nai` end to end, and heads carried
between the packages (`params_to_numpy` / `params_from_numpy`).

Geometry of tests/test_distill.py: flickr-like at scale 0.02, k=3,
hidden 32. Tolerances: losses within 1e-6 and their gradients within 1e-5
(f32, other summation orders); ten AdamW steps within 1e-6; a fit's loss
trajectory within 1e-4 relative and >= 99% equal test predictions (Adam
turns a rounding-sized gradient of either sign into a full step of +-lr,
so the parameters are printed, not gated); end to end, every order's test
accuracy within 0.02 and the `info` losses within 1e-2 relative. The
port's initialisers are patched to return the JAX package's initial
heads and ensemble projection, and dropout is 0 where trajectories are
compared (the two cannot draw the same masks)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.inception_distill as J
import repro.gnn.distill as JD
from repro.common import TrainConfig as JTrainConfig
from repro.gnn import GNNConfig as JGNNConfig
from repro.gnn import load_dataset as j_load
from repro.gnn.models import apply_classifier as j_apply
from repro.gnn.models import init_classifiers as j_init
from repro.gnn.nai import NAIConfig as JNAIConfig
from repro.optim import adamw_init as j_adamw_init
from repro.optim import adamw_update as j_adamw_update
from repro.optim import make_schedule as j_make_schedule
from repro.serving import NAIServingEngine as JEngine

import repro_torch.core.inception_distill as T
import repro_torch.gnn.distill as TD
from repro_torch.common import TrainConfig
from repro_torch.gnn import (Classifiers, DistillConfig, GNNConfig,
                             NAIConfig, evaluate_classifier, init_classifiers,
                             load_dataset, params_from_numpy, params_to_numpy)
from repro_torch.gnn.graph import propagated_series
from repro_torch.gnn.nai import decision_distances
from repro_torch.optim import adamw_init, adamw_update, make_schedule
from repro_torch.serving import NAIServingEngine

from torch_parity import assert_orders_match, near_threshold

torch.set_num_threads(1)
LOSS_TOL = dict(rtol=1e-6, atol=1e-6)
GRAD_TOL = dict(rtol=1e-5, atol=1e-5)
EPOCHS = dict(epochs_base=30, epochs_offline=20, epochs_online=20)


def _np(t):
    return t.detach().cpu().numpy()


# ------------------------------------------------------------------ losses
def _logits(seed, n=64, c=7):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, c)).astype(np.float32) * 3,
            rng.standard_normal((n, c)).astype(np.float32) * 3,
            rng.integers(0, c, n).astype(np.int32),
            rng.random(n) < 0.4)


def _loss_pairs():
    """name -> (JAX loss of (student, teacher), port loss of the same)."""
    _, _, y, m = _logits(0)
    yj, yt = jnp.asarray(y), torch.from_numpy(y).long()
    mj, mt = jnp.asarray(m), torch.from_numpy(m)
    s_j = jnp.asarray(np.random.default_rng(9).standard_normal((7, 1)),
                      jnp.float32)
    s_t = torch.tensor(np.asarray(s_j))
    kw = dict(temperature=1.2, lam=0.9)
    return {
        "soft_ce": (lambda a, b: J.soft_ce(a, b, 1.2),
                    lambda a, b: T.soft_ce(a, b, 1.2)),
        "hard_ce": (lambda a, b: J.hard_ce(a, yj),
                    lambda a, b: T.hard_ce(a, yt)),
        "hard_ce_mask": (lambda a, b: J.hard_ce(a, yj, mj),
                         lambda a, b: T.hard_ce(a, yt, mt)),
        "offline_loss": (lambda a, b: J.offline_loss(a, b, yj, **kw),
                         lambda a, b: T.offline_loss(a, b, yt, **kw)),
        "offline_loss_mask": (
            lambda a, b: J.offline_loss(a, b, yj, label_mask=mj, **kw),
            lambda a, b: T.offline_loss(a, b, yt, label_mask=mt, **kw)),
        "ensemble_teacher": (
            lambda a, b: jnp.sum(jnp.sin(J.ensemble_teacher([a, b], s_j))),
            lambda a, b: torch.sum(torch.sin(T.ensemble_teacher([a, b],
                                                                 s_t)))),
        "online_loss": (
            lambda a, b: J.online_loss(a, J.ensemble_teacher([a, b], s_j),
                                       yj, **kw),
            lambda a, b: T.online_loss(a, T.ensemble_teacher([a, b], s_t),
                                       yt, **kw)),
    }


@pytest.mark.parametrize("name", sorted(_loss_pairs()))
def test_losses_and_gradients_match_jax(name):
    jf, tf = _loss_pairs()[name]
    a, b, _, _ = _logits(1)
    lj, (gaj, gbj) = jax.value_and_grad(jf, argnums=(0, 1))(
        jnp.asarray(a), jnp.asarray(b))
    at = torch.from_numpy(a).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    lt = tf(at, bt)
    ga, gb = torch.autograd.grad(lt, (at, bt), allow_unused=True)
    np.testing.assert_allclose(float(lt.detach()), float(lj), **LOSS_TOL)
    np.testing.assert_allclose(_np(ga), np.asarray(gaj), **GRAD_TOL)
    # offline_loss detaches its teacher; the others reach it (or ignore it)
    gb = np.zeros_like(b) if gb is None else _np(gb)
    np.testing.assert_allclose(gb, np.asarray(gbj), **GRAD_TOL)


def test_ensemble_teacher_is_not_detached():
    """Eq. 6 trains teacher and students together: the online loss
    reaches the ensemble's exits and its projection s."""
    a, b, y, _ = _logits(2)
    at, bt = (torch.from_numpy(v).requires_grad_() for v in (a, b))
    s = torch.full((7, 1), 0.1, requires_grad=True)
    st = torch.from_numpy(a[:, ::-1].copy()).requires_grad_()
    loss = T.online_loss(st, T.ensemble_teacher([at, bt], s),
                         torch.from_numpy(y).long(), temperature=1.2,
                         lam=0.9)
    for g in torch.autograd.grad(loss, (at, bt, s)):
        assert float(g.abs().sum()) > 0
    loss = T.offline_loss(st, at, torch.from_numpy(y).long(),
                          temperature=1.2, lam=0.9)
    assert torch.autograd.grad(loss, (at,), allow_unused=True)[0] is None


# --------------------------------------------------------------- optimizer
@pytest.mark.parametrize("clip", [0.0, 0.5])
def test_adamw_ten_steps_match_jax(clip):
    rng = np.random.default_rng(3)
    shapes = {"w0": (6, 5), "b0": (5,), "w1": (5, 3), "b1": (3,)}
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(10)]
    kw = dict(learning_rate=0.01, weight_decay=0.1, grad_clip=clip)
    jtc, ttc = JTrainConfig(**kw), TrainConfig(**kw)
    assert dataclasses.asdict(jtc) == dataclasses.asdict(ttc)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v) for k, v in p0.items()}
    js, ts = j_adamw_init(jp, jtc), adamw_init(tp, ttc)
    for g in grads:
        jp, js, jm = j_adamw_update({k: jnp.asarray(v) for k, v in g.items()},
                                    js, jp, jtc, 0.01)
        tp, ts, tm = adamw_update({k: torch.from_numpy(v)
                                   for k, v in g.items()}, ts, tp, ttc, 0.01)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
    for k in shapes:
        np.testing.assert_allclose(_np(tp[k]), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(_np(ts["mu"][k]), np.asarray(js["mu"][k]),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(_np(ts["nu"][k]), np.asarray(js["nu"][k]),
                                   rtol=1e-6, atol=1e-6)
    assert int(ts["count"]) == int(js["count"]) == 10


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_schedule_matches_jax(schedule):
    kw = dict(learning_rate=3e-3, warmup_steps=7, total_steps=50,
              schedule=schedule)
    js, ts = j_make_schedule(JTrainConfig(**kw)), make_schedule(
        TrainConfig(**kw))
    for step in (0, 1, 6, 7, 8, 25, 49, 50, 80):
        np.testing.assert_allclose(float(ts(step)), float(js(step)),
                                   rtol=1e-6, atol=1e-9)


# ---------------------------------------------------------------- training
@pytest.fixture(scope="module")
def setup():
    g = load_dataset("flickr-like", scale=0.02, seed=0)
    kw = dict(k=3, hidden=32, mlp_layers=2, dropout=0.0)
    cfg = GNNConfig("sgc", g.features.shape[1], g.num_classes, **kw)
    jcfg = JGNNConfig("sgc", g.features.shape[1], g.num_classes, **kw)
    series = np.stack(propagated_series(g, g.features, cfg.k))
    return g, cfg, jcfg, series


def _tree(params):
    return jax.tree.map(np.asarray, params)


def test_dropout(setup):
    g, cfg, jcfg, series = setup
    cfg = dataclasses.replace(cfg, dropout=0.3)
    jcfg = dataclasses.replace(jcfg, dropout=0.3)
    tree = _tree(j_init(jcfg, jax.random.PRNGKey(5)))
    heads = params_from_numpy(cfg, tree, device="cpu")
    feats = torch.from_numpy(series)
    for l in (1, 3):
        np.testing.assert_allclose(
            _np(heads.head(l)(feats)),
            np.asarray(j_apply(jcfg, tree[l], series, l)), rtol=1e-5,
            atol=1e-5)
    # with a generator: inverted dropout before every layer, the first
    # included; the kept share is 1 - p within 3 sigma, kept values x/(1-p)
    seen = []
    head = heads.head(1)
    orig = head.layers[0].forward
    head.layers[0].forward = lambda x: (seen.append(x), orig(x))[1]
    gen = torch.Generator().manual_seed(0)
    out = head(feats, generator=gen)
    head.layers[0].forward = orig
    x = feats[1]
    kept = seen[0] != 0
    n = kept.numel()
    share = float(kept.float().mean())
    assert abs(share - 0.7) < 3 * np.sqrt(0.7 * 0.3 / n), share
    torch.testing.assert_close(seen[0][kept], (x / 0.7)[kept])
    assert not torch.equal(out, head(feats))
    assert torch.equal(head(feats, generator=torch.Generator().manual_seed(1)),
                       head(feats, generator=torch.Generator().manual_seed(1)))


def test_one_fit_matches_jax(setup):
    """20 AdamW steps of the base loss (Eq. 2) from the same heads."""
    g, cfg, jcfg, series = setup
    tree = _tree(j_init(jcfg, jax.random.PRNGKey(0)))
    feats_vl = series[:, g.train_idx]
    y = g.labels[g.train_idx]
    jloss_hist = []

    def jloss(p, rng):
        loss = J.hard_ce(j_apply(jcfg, p, jnp.asarray(feats_vl), 3, key=rng),
                         jnp.asarray(y))
        jax.debug.callback(lambda v: jloss_hist.append(float(v)), loss)
        return loss

    jp, jl = JD._fit(jloss, tree[3], 20, JD._tc(JD.DistillConfig()),
                     jax.random.PRNGKey(1))
    heads = params_from_numpy(cfg, tree, device="cpu")
    fv, yt = torch.from_numpy(feats_vl), torch.from_numpy(y).long()
    hist = []

    def tloss(h, rng):
        loss = T.hard_ce(h(fv, generator=rng), yt)
        hist.append(loss.detach())
        return loss

    _, tl = TD._fit(tloss, heads.head(3), 20, TD._tc(DistillConfig()),
                    torch.Generator().manual_seed(1))
    assert len(hist) == len(jloss_hist) == 20
    np.testing.assert_allclose([float(v) for v in hist], jloss_hist,
                               rtol=1e-4)
    assert tl == float(hist[-1])
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    jx = np.asarray(j_apply(jcfg, jp, series[:, g.test_idx], 3))
    with torch.no_grad():
        tx = _np(heads.head(3)(torch.from_numpy(series[:, g.test_idx])))
    agree = float((jx.argmax(-1) == tx.argmax(-1)).mean())
    gap = max(float(np.abs(_np(lin.weight).T - jp[f"w{i}"]).max())
              for i, lin in enumerate(heads.head(3).layers))
    print(f"one fit: prediction agreement {agree}, largest weight gap {gap}")
    assert agree >= 0.99


@pytest.fixture(scope="module")
def trained(setup):
    """train_nai in both packages from the same initial heads and ens_s."""
    g, cfg, jcfg, series = setup
    cap = {}
    j_init_cls, j_init_tree = JD.init_classifiers, JD.init_tree

    def cap_cls(c, key):
        cap["cls"] = _tree(j_init_cls(c, key))
        return j_init_cls(c, key)

    def cap_tree(key, d, dt):
        cap["ens_s"] = np.asarray(j_init_tree(key, d, dt))
        return j_init_tree(key, d, dt)

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(JD, "init_classifiers", cap_cls)
        mp.setattr(JD, "init_tree", cap_tree)
        jparams, jinfo = JD.train_nai(jcfg, j_load("flickr-like", 0.02, 0),
                                      JD.DistillConfig(**EPOCHS))
        mp.setattr(TD, "init_classifiers", lambda c, gen, device:
                   params_from_numpy(c, cap["cls"], device=device))
        mp.setattr(TD, "init_ensemble", lambda c, gen, device:
                   torch.tensor(cap["ens_s"]).to(device))
        model, info = TD.train_nai(cfg, g, DistillConfig(**EPOCHS),
                                   device="cpu")
    finally:
        mp.undo()
    return jparams, jinfo, model, info


def test_train_nai_matches_jax(setup, trained):
    g, cfg, jcfg, series = setup
    jparams, jinfo, model, info = trained
    assert isinstance(model, Classifiers)
    assert model.ens_s.shape == (cfg.num_classes, 1)
    assert set(info) == set(jinfo) == {"base_loss", "offline_loss_1",
                                       "offline_loss_2", "online_loss"}
    for k in info:
        np.testing.assert_allclose(info[k], jinfo[k], rtol=1e-2, err_msg=k)
    for l in range(1, cfg.k + 1):
        jacc = JD.evaluate_classifier(jcfg, jparams["cls"][l], series,
                                      g.labels, g.test_idx, l)
        tacc = evaluate_classifier(cfg, model, series, g.labels, g.test_idx,
                                   l)
        assert abs(tacc - jacc) <= 0.02, (l, tacc, jacc)
        assert tacc > 1.5 / cfg.num_classes, (l, tacc)
    np.testing.assert_allclose(_np(model.ens_s),
                               np.asarray(jparams["ens_s"]), atol=1e-3)


def test_params_round_trip(trained):
    _, _, model, _ = trained
    tree = params_to_numpy(model)
    assert set(tree) == {"cls", "ens_s"} and tree["ens_s"].shape == (7, 1)
    again = params_to_numpy(params_from_numpy(model.cfg, tree["cls"],
                                              device="cpu"))
    assert set(again) == {"cls"}
    for l, p in tree["cls"].items():
        assert set(p) == {"w0", "b0", "w1", "b1"}
        assert p["w0"].shape == (500, 32)
        for k, v in p.items():
            np.testing.assert_array_equal(again["cls"][l][k], v)


def _serve(engine, nodes):
    engine.submit(nodes)
    done = []
    while engine.queue:
        done += engine.step()
    done += engine.flush()
    assert [r.node_id for r in done] == list(map(int, nodes))
    return (np.array([r.prediction for r in done]),
            np.array([r.exit_order for r in done]))


def test_jax_engine_serves_port_trained_heads(setup, trained):
    """The port's trained heads, carried to JAX by `params_to_numpy`,
    give the JAX host engine the port engine's predictions and exit
    orders (T_s at the median order-1 distance, so both orders occur)."""
    g, cfg, jcfg, _ = setup
    _, _, model, _ = trained
    nodes = g.test_idx[:192]
    probe = NAIConfig(t_s=1.0, t_min=1, t_max=2, batch_size=64)
    t_s = float(np.median(decision_distances(cfg, probe, g, nodes[:64])))
    kw = dict(t_s=t_s, t_min=1, t_max=2, batch_size=64)
    nai, jnai = NAIConfig(**kw), JNAIConfig(**kw)
    tp, to = _serve(NAIServingEngine(cfg, nai, model, g, device="cpu",
                                     max_wait_s=10.0), nodes)
    jp, jo = _serve(JEngine(jcfg, jnai, params_to_numpy(model),
                            j_load("flickr-like", 0.02, 0),
                            max_wait_s=10.0), nodes)
    near = near_threshold(decision_distances, cfg, nai, g, nodes,
                          nai.batch_size)
    assert_orders_match(tp, to, jp, jo, near)
    assert set(to) == {1, 2}


def test_distillation_does_not_hurt_f1(setup):
    """tests/test_distill.py's Table 6 check, on the port: f^(1) trained
    by Inception Distillation is no worse than f^(1) trained on hard
    labels alone."""
    g, cfg, jcfg, series = setup
    heads = init_classifiers(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    fv = torch.from_numpy(series[:, g.train_idx])
    y = torch.from_numpy(g.labels[g.train_idx]).long()
    TD._fit(lambda h, rng: T.hard_ce(h(fv, generator=rng), y), heads.head(1),
            120, TD._tc(DistillConfig()), torch.Generator().manual_seed(1))
    acc_no_id = evaluate_classifier(cfg, heads, series, g.labels,
                                    g.test_idx, 1)
    model, _ = TD.train_nai(cfg, g, DistillConfig(
        epochs_base=120, epochs_offline=80, epochs_online=80), device="cpu")
    acc_id = evaluate_classifier(cfg, model, series, g.labels, g.test_idx, 1)
    assert acc_id >= acc_no_id - 0.01, (acc_id, acc_no_id)
