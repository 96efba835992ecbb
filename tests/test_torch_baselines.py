"""The paper's Table 3 baselines in the port against the JAX package's,
on the same teacher (JAX's trained heads carried over): GLNN and TinyGNN
from JAX's initial parameters (patched into the port's initialiser) reach
an accuracy within 0.02 of JAX's; the quantized and vanilla baselines
train nothing, so their predictions equal JAX's (at T_s = 0 no node
decides an exit, so no threshold margin applies); every MAC count is
equal. Geometry of tests/test_distill.py (flickr-like at scale 0.02,
k=3, hidden 32)."""
import jax
import numpy as np
import pytest
import torch

import repro.gnn.baselines as JB
import repro.gnn.distill as JD
from repro.gnn import GNNConfig as JGNNConfig
from repro.gnn import load_dataset as j_load

import repro_torch.gnn.baselines as TB
from repro_torch.gnn import GNNConfig, load_dataset, params_from_numpy

torch.set_num_threads(1)
EPOCHS = 40


@pytest.fixture(scope="module")
def setup():
    jg = j_load("flickr-like", scale=0.02, seed=0)
    g = load_dataset("flickr-like", scale=0.02, seed=0)
    kw = dict(k=3, hidden=32, mlp_layers=2, dropout=0.0)
    jcfg = JGNNConfig("sgc", 500, g.num_classes, **kw)
    cfg = GNNConfig("sgc", 500, g.num_classes, **kw)
    jparams, _ = JD.train_nai(jcfg, jg, JD.DistillConfig(
        epochs_base=20, epochs_offline=10, epochs_online=10))
    tree = jax.tree.map(np.asarray, jparams["cls"])
    heads = params_from_numpy(cfg, tree, device="cpu")
    return jg, g, jcfg, cfg, jparams, heads


@pytest.mark.parametrize("name", ["glnn", "tinygnn"])
def test_distilled_baselines_match_jax(setup, name, monkeypatch):
    jg, g, jcfg, cfg, jparams, heads = setup
    cap = {}
    j_init_tree = JB.init_tree

    def cap_tree(key, defs, dt):
        cap.update(jax.tree.map(np.asarray, j_init_tree(key, defs, dt)))
        return j_init_tree(key, defs, dt)

    monkeypatch.setattr(JB, "init_tree", cap_tree)
    jr = getattr(JB, f"run_{name}")(jcfg, jg, jparams["cls"][cfg.k],
                                    epochs=EPOCHS)
    monkeypatch.setattr(TB, "init_params", lambda defs, gen, device: {
        k: torch.tensor(cap[k]).to(device) for k in defs})
    tr = getattr(TB, f"run_{name}")(cfg, g, heads.head(cfg.k), epochs=EPOCHS)
    assert abs(tr.acc - jr.acc) <= 0.02, (tr.acc, jr.acc)
    assert tr.acc > 1.5 / cfg.num_classes
    assert (tr.macs, tr.fp_macs) == (jr.macs, jr.fp_macs)
    assert tr.time_s > 0 and tr.fp_time_s >= 0


@pytest.mark.parametrize("name", ["quantized", "vanilla"])
def test_fixed_order_baselines_match_jax(setup, name, monkeypatch):
    import repro.gnn.nai as JN
    jg, g, jcfg, cfg, jparams, heads = setup
    seen = {}

    def spy(mod, key):
        infer = mod.infer_all

        def wrapped(*a, **kw):
            seen[key] = infer(*a, **kw)
            return seen[key]
        monkeypatch.setattr(mod, "infer_all", wrapped)

    spy(JN, "jax")
    spy(TB, "port")
    jr = getattr(JB, f"run_{name}")(jcfg, jg, jparams)
    tr = getattr(TB, f"run_{name}")(cfg, g, heads)
    np.testing.assert_array_equal(seen["port"].predictions,
                                  seen["jax"].predictions)
    np.testing.assert_array_equal(seen["port"].orders, seen["jax"].orders)
    assert set(seen["port"].orders) == {cfg.k}
    assert tr.acc == jr.acc
    assert (tr.macs, tr.fp_macs) == (jr.macs, jr.fp_macs)
    assert tr.time_s >= tr.fp_time_s > 0
