"""The comparison that decides `correct` fails what it has to fail.

* The control: the reference in float32 with TF32 (emulated on the CPU)
  put in the program's place, over every test node of a graph cut to a
  size a test run holds, must break a cell's limits.
* Faults planted under a CPU run of each cell, the rest of the run as it
  is: a propagation step that returns its state unchanged, half of the
  support left out of the stationary state's mean, an answer or an exit
  order altered where it is produced. Each must come out not correct; the
  run without a fault comes out correct.
"""
import numpy as np
import pytest
import torch

from bench import correct, graphgen, harness, heads
from bench.reference import nai as ref

CELLS = [w["name"] for w in harness.load_json(
    harness.ROOT / "BENCHMARK.json")["workloads"]]


def _control_gaps(config_cell, scale, seed, device="cpu"):
    cell = harness.load_cell(config_cell)
    conf = cell["config"]
    ga = graphgen.make_sbm(conf["graph"]["preset"], scale=scale, seed=seed,
                           edges=conf["graph"].get("edges"))
    gcfg = conf["gnn"]
    tree = harness.make_heads(gcfg, seed, device)
    eg = ref.EdgeGraph(ga.n, ga.src, ga.dst, device=device)
    t_s = ref.first_step_distance_quantile(eg, ga.features, gcfg["r"])
    kw = dict(logits=heads.load(gcfg["base_model"]).logits, r=gcfg["r"],
              t_min=1, t_max=2, t_s=t_s)
    exact = ref.Reference(eg, ga.features, tree, **kw)
    low = ref.Reference(eg, ga.features, tree, dtype=torch.float32,
                        tf32=True, **kw)
    nums = {"order_gap": 0.0, "logit_gap": 0.0}
    for batch in np.array_split(np.sort(ga.test_idx),
                                max(1, len(ga.test_idx) // 500)):
        a, c = exact.batch(batch), low.batch(batch)
        preds = c.logits[c.orders - 1, np.arange(len(batch))].argmax(1)
        nums = correct.merge(nums, correct.gaps(
            a.orders, a.dist, a.logits, c.orders, preds, t_min=1, t_max=2,
            t_s=t_s))
    return nums, cell


@pytest.mark.parametrize("config_cell,scale", [("arxiv-sgc.seg500", 0.25)])
def test_control_breaks_the_limits(config_cell, scale):
    nums, cell = _control_gaps(config_cell, scale, seed=2**31 + 101)
    limits = {k: v["limit"] for k, v in cell["limits"].items()}
    assert not correct.judge(nums, limits), (nums, limits)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("config_cell", ["arxiv-sgc.seg500"])
def test_control_breaks_the_limits_on_the_card(config_cell, cuda_device):
    """The same at the published size, with the card's own TF32."""
    nums, cell = _control_gaps(config_cell, 1.0, seed=2**31 + 103,
                               device=cuda_device)
    limits = {k: v["limit"] for k, v in cell["limits"].items()}
    assert not correct.judge(nums, limits), (nums, limits)


def _tiny(name):
    cell = harness.load_cell(name)
    cell["config"]["graph"]["scale"] = 0.02
    cell["mix"]["batch"] = 32
    return cell


def _run(cell):
    return harness.run_cell(cell, 2**31 + 9, 0.3, False, device="cpu",
                            log=lambda s: None)


def _step_unchanged(monkeypatch):
    from repro_torch.gnn import backends

    def step(self, ops, x, node_active, active_rb, ts2, *, n_batch, n_rows,
             x_bad=None):
        out = x[:n_rows].clone()
        x_inf = ops.get("x_inf")
        if x_inf is None:   # fused: the dense state from its factors
            x_inf = ops["c_inf"].reshape(-1, 1) * ops["s_inf"].reshape(1, -1)
        d2 = ((out[:n_batch] - x_inf) ** 2).sum(dim=1)
        return out, d2 < ts2, x_bad
    for cls in (backends.SegmentBackend, backends.FusedBackend):
        monkeypatch.setattr(cls, "step", step)


def _half_support(monkeypatch):
    from repro_torch.serving import engine
    orig = engine.support_stationary_factors

    def half(store, sup, x0, r):
        c, _ = orig(store, sup, x0, r)
        k = max(1, len(sup) // 2)
        dt = (np.asarray(store.degrees[sup.nodes[:k]]) + 1).astype(np.float64)
        s = ((dt ** (1.0 - r))[:, None] * x0[:k]).sum(axis=0) * len(sup) / k
        return c, s
    monkeypatch.setattr(engine, "support_stationary_factors", half)


def _answer_altered(monkeypatch):
    from repro_torch.serving.engine import NAIServingEngine
    orig = NAIServingEngine._device_stage

    def stage(self, *a, **kw):
        preds, orders, series, done = orig(self, *a, **kw)
        preds = preds.clone()
        preds[0] = (preds[0] + 1) % self.cfg.num_classes
        return preds, orders, series, done
    monkeypatch.setattr(NAIServingEngine, "_device_stage", stage)


def _order_altered(monkeypatch):
    from repro_torch.serving.engine import NAIServingEngine
    orig = NAIServingEngine._device_stage

    def stage(self, *a, **kw):
        preds, orders, series, done = orig(self, *a, **kw)
        orders = orders.clone()
        orders[0] = self.nai.t_max + 1 - orders[0]
        return preds, orders, series, done
    monkeypatch.setattr(NAIServingEngine, "_device_stage", stage)


FAULTS = {"step_unchanged": _step_unchanged, "half_support": _half_support,
          "answer_altered": _answer_altered, "order_altered": _order_altered}


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    assert _run(_tiny(name))["correct"] is True


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(name, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    out = _run(_tiny(name))
    assert out["correct"] is False, out["checks"]
