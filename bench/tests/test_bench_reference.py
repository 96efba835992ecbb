"""The benchmark's frozen generator and plain reference against the port,
on the CPU at small sizes."""
import numpy as np
import pytest
import torch

from bench import correct, graphgen, harness
from bench.heads import load as load_head
from bench.reference import nai as ref
from repro_torch.gnn.convert import params_from_numpy
from repro_torch.gnn.datasets import load_dataset
from repro_torch.gnn.models import GNNConfig
from repro_torch.gnn.nai import NAIConfig, infer_batch_host
from repro_torch.gnn.sampler import sample_support
from repro_torch.gnn.store import as_store


@pytest.mark.parametrize("preset,scale", [("arxiv-like", 0.02),
                                          ("flickr-like", 0.02),
                                          ("pubmed-like", 0.1)])
def test_frozen_generator_matches_port(preset, scale):
    mine = graphgen.make_sbm(preset, scale=scale, seed=3)
    port = load_dataset(preset, scale=scale, seed=3)
    assert mine.n == port.n and mine.num_classes == port.num_classes
    for key in ("src", "dst", "features", "labels", "train_idx",
                "unlabeled_idx", "test_idx"):
        a, b = getattr(mine, key), getattr(port, key)
        assert a.dtype == b.dtype, key
        np.testing.assert_array_equal(a, b, err_msg=key)


def _setup(model, seed=5, scale=0.03, mlp_layers=2):
    ga = graphgen.make_sbm("flickr-like" if model == "gamlp" else
                           "arxiv-like", scale=scale, seed=seed)
    port = load_dataset(ga.name, scale=scale, seed=seed)
    gcfg = dict(base_model=model, feat_dim=ga.features.shape[1],
                num_classes=ga.num_classes, k=3, r=0.5, hidden=64,
                mlp_layers=mlp_layers, att_dim=32)
    tree = harness.make_heads(gcfg, seed, "cpu")
    eg = ref.EdgeGraph(ga.n, ga.src, ga.dst)
    t_s = ref.first_step_distance_quantile(eg, ga.features, 0.5)
    return ga, port, gcfg, tree, eg, t_s


@pytest.mark.parametrize("model,mlp_layers", [("sgc", 1), ("sgc", 2),
                                              ("gamlp", 2)])
def test_reference_matches_host_mode(model, mlp_layers):
    ga, port, gcfg, tree, eg, t_s = _setup(model, mlp_layers=mlp_layers)
    cfg = GNNConfig(**gcfg)
    heads = params_from_numpy(cfg, tree, device="cpu")
    nai = NAIConfig(t_s=t_s, t_min=1, t_max=2, batch_size=64)
    r = ref.Reference(eg, ga.features, tree,
                      logits=load_head(model).logits, r=0.5, t_min=1,
                      t_max=2, t_s=t_s)
    rng = np.random.default_rng(0)
    store = as_store(port)
    for _ in range(3):
        batch = np.sort(rng.choice(ga.test_idx, 64, replace=False))
        out = r.batch(batch)
        sup = sample_support(store, batch, 2, 0.5)
        np.testing.assert_array_equal(out.support, np.sort(sup.nodes))
        assert out.support_edges == sup.sub_edges
        preds, orders, _, _, _ = infer_batch_host(cfg, nai, heads, store,
                                                  batch)
        # exit orders equal outside rounding of the threshold
        g = correct.gaps(out.orders, out.dist, out.logits, orders, preds,
                         t_min=1, t_max=2, t_s=t_s)
        assert g["order_gap"] < 1e-5 and g["logit_gap"] < 1e-5, g
        assert (orders == out.orders).mean() > 0.99
        # every head's logits on the reference's own series
        with torch.inference_mode():
            for l in (1, 2):
                series = r.series[:, torch.as_tensor(batch)].float()
                z = heads.head(l)(series[:l + 1]).numpy()
                np.testing.assert_allclose(z, out.logits[l - 1], rtol=1e-4,
                                           atol=1e-4)


def test_comparison_rejects_perturbed_output():
    ga, port, gcfg, tree, eg, t_s = _setup("sgc")
    r = ref.Reference(eg, ga.features, tree,
                      logits=load_head("sgc").logits, r=0.5, t_min=1,
                      t_max=2, t_s=t_s)
    batch = np.sort(np.random.default_rng(1).choice(ga.test_idx, 64,
                                                    replace=False))
    out = r.batch(batch)
    preds = out.logits[out.orders - 1, np.arange(len(batch))].argmax(1)
    kw = dict(t_min=1, t_max=2, t_s=t_s)
    sound = correct.gaps(out.orders, out.dist, out.logits, out.orders,
                         preds, **kw)
    assert sound == {"order_gap": 0.0, "logit_gap": 0.0}
    bad_pred = preds.copy()
    bad_pred[7] = (bad_pred[7] + 1) % ga.num_classes
    g = correct.gaps(out.orders, out.dist, out.logits, out.orders, bad_pred,
                     **kw)
    assert g["logit_gap"] > 1e-3
    bad_order = out.orders.copy()
    i = int(np.argmax(np.abs(out.dist[:, 0] ** 2 - t_s ** 2)))
    bad_order[i] = 3 - bad_order[i]
    g = correct.gaps(out.orders, out.dist, out.logits, bad_order, preds, **kw)
    assert g["order_gap"] > 1e-2
    out_of_range = preds.copy()
    out_of_range[0] = ga.num_classes
    g = correct.gaps(out.orders, out.dist, out.logits, out.orders,
                     out_of_range, **kw)
    assert g["logit_gap"] == float("inf")
    limits = harness.load_cell("arxiv-sgc.seg500")["limits"]
    lim = {k: v["limit"] for k, v in limits.items()}
    assert correct.judge(sound, lim)
