"""GAMLP as published (``base_model="jk_gamlp"``, `JKGAMLPHead`) against
its plain reference, ``bench/heads/jk_gamlp.py``, at small widths on the
CPU: every order's logits, the parameter tree both ways, the counted
multiply-adds, and the compiled serving engine's exit orders and classes
on the Flickr cell's graph at 2% of its size."""
import os
import sys

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from bench import graphgen, harness, heads  # noqa: E402
from repro_torch.gnn.convert import (params_from_numpy,  # noqa: E402
                                     params_to_numpy)
from repro_torch.gnn.models import (Classifiers, GNNConfig,  # noqa: E402
                                    JKGAMLPHead, classification_macs,
                                    init_classifiers)

torch.set_num_threads(1)
GCFG = dict(base_model="jk_gamlp", feat_dim=12, num_classes=5, k=3, r=0.5,
            hidden=16, mlp_layers=4, jk_layers=4, alpha=0.5)
SEED = 2**31 + 35
ARCH = heads.load("jk_gamlp")
# float32 through ~14 products of widths <= 64 against float64: the
# port's error is ~1e-7 of the logits' scale; a wrong residual, slope,
# bias or hop reads 1e-2 or more
REL = 1e-5


def _tree(random_rest: bool, gcfg=GCFG):
    """The seed's draw; with `random_rest` the biases and the PReLU
    slopes (0 and 0.25 in the draw) drawn too, so that each is seen. The
    draw's ``alpha`` leaf is the plain reference's (its `logits` sees only
    the weights); the port takes alpha from its configuration."""
    tree = harness.make_heads(gcfg, SEED, "cpu")
    if random_rest:
        rng = np.random.default_rng(5)
        for p in tree.values():
            for key, v in p.items():
                if key != "alpha" and (v.ndim == 1):
                    p[key] = (0.5 * rng.standard_normal(v.shape)).astype(
                        np.float32)
    return tree


def _series(n=40, seed=3):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(4, n, GCFG["feat_dim"], generator=g,
                       dtype=torch.float64)


@pytest.mark.parametrize("alpha", [0.5, 0.2])
@pytest.mark.parametrize("random_rest", [False, True],
                         ids=["drawn", "biases-slopes"])
@pytest.mark.parametrize("l", [1, 2, 3])
def test_logits_equal_the_plain_reference(l, random_rest, alpha):
    gcfg = dict(GCFG, alpha=alpha)
    tree = _tree(random_rest, gcfg)
    cls = params_from_numpy(GNNConfig(**gcfg), tree, device="cpu")
    x = _series()
    with torch.inference_mode():
        got = cls.head(l)(x.float()).double()
    p = {k: torch.as_tensor(v).double() for k, v in tree[l].items()}
    want = ARCH.logits(p, x, l, torch.matmul)
    assert got.shape == (x.shape[1], GCFG["num_classes"])
    scale = float(want.abs().max())
    assert scale > 1.0
    assert float((got - want).abs().max()) <= REL * scale


@pytest.mark.parametrize("random_rest", [False, True],
                         ids=["drawn", "biases-slopes"])
def test_params_round_trip_bit_equal(random_rest):
    tree = _tree(random_rest)
    back = params_to_numpy(params_from_numpy(GNNConfig(**GCFG), tree,
                                             device="cpu"))["cls"]
    assert sorted(back) == sorted(tree) == [1, 2, 3]
    for l in tree:
        del tree[l]["alpha"]
        assert sorted(back[l]) == sorted(tree[l])
        for key, v in tree[l].items():
            assert back[l][key].dtype == np.float32
            assert back[l][key].tobytes() == v.tobytes(), (l, key)


def test_tree_keys_are_the_head_files_draws():
    """The head file draws the port's tree, and alpha for its own
    `logits`."""
    keys = {}
    for l, key, shape, _ in ARCH.draws(GCFG):
        if key != "alpha":
            keys.setdefault(l, {})[key] = shape
    cls = params_to_numpy(Classifiers(GNNConfig(**GCFG)))
    for l, p in cls["cls"].items():
        assert {k: v.shape for k, v in p.items()} == keys[l]


def _weight_macs(head: JKGAMLPHead, l: int) -> int:
    """Each matrix of the module times the rows it multiplies per node:
    once, but the hop score vector u once per hop; plus the weighted sum
    of the l+1 hops (H each), which has no weight."""
    macs = 0
    for m in head.modules():
        if isinstance(m, torch.nn.Linear):
            n = (l + 1) if m is head.att else 1
            macs += n * m.in_features * m.out_features
    return macs + (l + 1) * head.cfg.hidden


@pytest.mark.parametrize("gcfg", [GCFG, dict(GCFG, feat_dim=500,
                                              num_classes=7, hidden=512)],
                         ids=["small", "flickr"])
@pytest.mark.parametrize("l", [1, 2, 3])
def test_macs_equal_the_head_file_and_the_weights(gcfg, l):
    cfg = GNNConfig(**gcfg)
    with torch.device("meta"):
        head = JKGAMLPHead(cfg, l)
    assert classification_macs(cfg, l) == ARCH.macs(gcfg, l) \
        == _weight_macs(head, l)


def test_published_widths_count():
    """At Flickr's widths f^(1) and f^(2) cost 3.40 M and 4.18 M a node."""
    gcfg = dict(GCFG, feat_dim=500, num_classes=7, hidden=512)
    assert [ARCH.macs(gcfg, l) for l in (1, 2)] == [3_396_096, 4_177_920]


def test_tree_must_match_the_configuration():
    cfg = GNNConfig(**GCFG)
    tree = _tree(False)
    for p in tree.values():
        del p["alpha"]
    params_from_numpy(cfg, tree, device="cpu")
    tree[1]["jk_w0"] = tree[1]["jk_w0"][:-1]
    with pytest.raises(ValueError, match="jk_w0"):
        params_from_numpy(cfg, tree, device="cpu")


def test_training_forward_is_refused():
    cls = params_from_numpy(GNNConfig(**GCFG), _tree(False), device="cpu")
    with pytest.raises(NotImplementedError, match="jk_gamlp"):
        cls.head(1)(_series().float(), generator=torch.Generator())


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not func.is_view:
            self.ops.append(func.overloadpacket.__name__)
        return func(*args, **(kwargs or {}))


def test_first_operation_is_a_matrix_product():
    """The benchmark's trace splits a batch's loop kernels from its heads'
    at the heads' first matrix product: the head must start with one."""
    cls = params_from_numpy(GNNConfig(**GCFG), _tree(False), device="cpu")
    x = _series().float()
    with torch.inference_mode(), _Ops() as seen:
        cls.head(2)(x)
    assert seen.ops[0] in ("linear", "addmm", "mm"), seen.ops[:3]


def test_random_init_is_refused():
    with pytest.raises(NotImplementedError, match="params_from_numpy"):
        init_classifiers(GNNConfig(**GCFG), torch.Generator(), device="cpu")


def test_engine_serves_the_reference_answers():
    """`NAIServingEngine(mode="compiled", spmm_impl="segment")` on the
    cell's graph at 2% of its size: every node's exit order and class are the float64
    reference's (no node lies within float32 rounding of T_s or of a tie:
    asserted)."""
    cell = harness.load_cell("flickr-gamlp.seg500")
    cell["config"]["graph"]["scale"] *= 0.02
    cell["config"]["gnn"] = dict(cell["config"]["gnn"], hidden=32)
    cell["mix"]["batch"] = 32
    built = harness.build(cell, SEED, "cpu")
    eng = built["engine"]
    assert eng.mode == "compiled" and eng.spmm_impl == "segment"
    rng = np.random.default_rng(0)
    batches = [rng.choice(built["graph"].test_idx, 32, replace=False)
               for _ in range(3)]
    for b in batches:
        eng.submit(b)
    done = []
    while eng.queue:
        done += eng.step()
    done += eng.flush()
    eng.close()
    assert len(done) == 96 and all(r.status == "completed" for r in done)
    reference = harness.reference(built)
    t_s2 = built["t_s"] ** 2
    for rs in harness.batches_of(done).values():
        uniq, orders, preds = harness.answers(rs)
        out = reference.batch(uniq)
        assert np.all(np.abs(out.dist ** 2 - t_s2) > 1e-5 * t_s2)
        assert np.array_equal(orders, out.orders)
        z = out.logits[orders - 1, np.arange(len(uniq))]
        top2 = np.sort(z, axis=1)[:, -2:]
        assert np.all(top2[:, 1] - top2[:, 0] > 1e-5 * np.ptp(z, axis=1))
        assert np.array_equal(preds, z.argmax(axis=1))
    assert set(np.unique(np.concatenate(
        [harness.answers(rs)[1] for rs in harness.batches_of(done).values()]
    ))) == {1, 2}


def test_flickr_graph_draw_is_the_presets():
    """The configuration's graph is a frozen preset's, scaled to Flickr's
    nodes, with its features and label blocks; the heads give Flickr's
    classes."""
    conf = harness.load_cell("flickr-gamlp.seg500")["config"]
    g = conf["graph"]
    n_full, _, f, c = graphgen.PRESETS[g["preset"]]
    assert int(n_full * g["scale"]) == g["nodes"] == 89_250
    assert (g["features"], g["label_blocks"]) == (f, c)
    assert (conf["gnn"]["feat_dim"], conf["gnn"]["num_classes"]) == (
        f, g["classes"]) == (500, 7)
    assert conf["reduced"] == ["graph"]
