"""Per-order classifiers of the PyTorch port against the JAX package: the
JAX `init_classifiers` parameters, carried across by `params_from_numpy`,
must give the same logits on the same seeded series (allclose at
rtol = atol = 1e-5: f32 matmuls in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.gnn.models import GNNConfig as JConfig
from repro.gnn.models import apply_classifier
from repro.gnn.models import classification_macs as j_macs
from repro.gnn.models import init_classifiers as j_init

from repro_torch.gnn.convert import params_from_numpy
from repro_torch.gnn.models import GNNConfig, classification_macs
from repro_torch.gnn.models import init_classifiers

torch.set_num_threads(1)

MODELS = ("sgc", "s2gc", "sign", "gamlp")


def _configs(model):
    kw = dict(k=3, hidden=32, mlp_layers=2)
    return JConfig(model, 40, 5, **kw), GNNConfig(model, 40, 5, **kw)


@pytest.mark.parametrize("model", MODELS)
def test_logits_match_jax(model):
    jcfg, tcfg = _configs(model)
    params = j_init(jcfg, jax.random.PRNGKey(1))
    tree = {l: {k: np.asarray(v) for k, v in p.items()}
            for l, p in params.items()}
    heads = params_from_numpy(tcfg, tree, device="cpu")
    feats = np.random.default_rng(0).standard_normal(
        (tcfg.k + 1, 23, tcfg.feat_dim)).astype(np.float32)
    for l in range(1, tcfg.k + 1):
        want = np.asarray(apply_classifier(jcfg, params[l],
                                           jnp.asarray(feats), l))
        with torch.no_grad():
            got = heads.head(l)(torch.from_numpy(feats)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        # the series may also be cut to exactly l+1 orders
        with torch.no_grad():
            cut = heads.head(l)(torch.from_numpy(feats[:l + 1])).numpy()
        np.testing.assert_array_equal(cut, got)


@pytest.mark.parametrize("model", MODELS)
def test_classification_macs_match_jax(model):
    jcfg, tcfg = _configs(model)
    for l in range(1, tcfg.k + 1):
        assert classification_macs(tcfg, l) == j_macs(jcfg, l)


def test_init_classifiers_is_seeded_and_shaped():
    _, cfg = _configs("gamlp")
    a = init_classifiers(cfg, torch.Generator().manual_seed(0), device="cpu")
    b = init_classifiers(cfg, torch.Generator().manual_seed(0), device="cpu")
    c = init_classifiers(cfg, torch.Generator().manual_seed(1), device="cpu")
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["heads.0.layers.0.weight"],
                           sc["heads.0.layers.0.weight"])
    for l in range(1, cfg.k + 1):
        lin = a.head(l).layers[0]
        assert lin.weight.shape == (cfg.hidden, cfg.input_dim(l))
        assert not lin.bias.any()
        # fan-in init: weight std ~ 1/sqrt(fan_in)
        std = float(lin.weight.detach().std()) * np.sqrt(cfg.input_dim(l))
        assert 0.8 < std < 1.2


def test_params_from_numpy_rejects_wrong_shapes():
    jcfg, tcfg = _configs("sgc")
    params = j_init(jcfg, jax.random.PRNGKey(0))
    tree = {l: {k: np.asarray(v) for k, v in p.items()}
            for l, p in params.items()}
    tree[1]["w0"] = tree[1]["w0"].T
    with pytest.raises(ValueError, match="w0"):
        params_from_numpy(tcfg, tree, device="cpu")
