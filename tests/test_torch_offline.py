"""Offline full-graph inference in the PyTorch port, against the JAX
package: `launch/checkpoint.py` (the same directory format, read across
packages bit for bit), `gnn/distributed.py` (`graph_as_support`,
`pack_graph` array-equal), `backends.make_superstep` (a chain of
supersteps equal to the single-dispatch `_masked_loop` bitwise on every
backend) and `launch/full_graph_infer.py` (predictions and exit orders
equal to the JAX package's offline job under the threshold-margin rule of
tests/torch_parity.py, equal to the port's own serving path exactly, and
kill-at-every-superstep then resume bit-identical inside the port). The
JAX side runs `segment`, as its own tests run it; the port runs every
backend on the CPU through the kernels' plain versions."""
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.gnn.distributed import graph_as_support as j_graph_as_support
from repro.gnn.distributed import pack_graph as j_pack_graph
from repro.gnn.models import GNNConfig as JConfig
from repro.gnn.models import init_classifiers as j_init
from repro.gnn.nai import NAIConfig as JNAI
from repro.gnn.store import make_graph as j_make_graph
from repro.launch import checkpoint as jck
from repro.launch.full_graph_infer import OfflineConfig as JOffline
from repro.launch.full_graph_infer import \
    first_step_distance_quantile as j_quantile
from repro.launch.full_graph_infer import run_full_graph_infer as j_run
from repro.serving.faults import FaultPlan as JPlan
from repro.serving.faults import FaultSpec as JSpec

from repro_torch.gnn import GNNConfig, NAIConfig, params_from_numpy
from repro_torch.gnn.backends import (make_superstep, pack_operands,
                                      run_propagation)
from repro_torch.gnn.distributed import graph_as_support, pack_graph
from repro_torch.gnn.nai import make_compiled_infer
from repro_torch.gnn.packing import step_active_blocks
from repro_torch.gnn.store import make_graph, save_graph_store
from repro_torch.launch.checkpoint import (FORMAT, MANIFEST,
                                           CheckpointCorruption,
                                           CheckpointError,
                                           CheckpointManager,
                                           CheckpointMismatch)
from repro_torch.launch.full_graph_infer import (EXIT_PREEMPTED,
                                                 OfflineConfig,
                                                 PreemptionSimulated,
                                                 first_step_distance_quantile,
                                                 run_full_graph_infer)
from repro_torch.serving.faults import (FaultPlan, FaultSpec, InjectedFault,
                                        WatchdogTimeout)

from torch_parity import D2_MARGIN, assert_orders_match

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
T_MAX = 3
IMPLS = ("segment", "block_ell", "fused")
FP = {"store": "t", "n": 10, "shards": 1}
GRAPH = dict(n=800, avg_deg=6.0, alpha=2.2, seed=3, path=None, feat_dim=24,
             num_classes=5)


def _decision_near(store, r, t_s, t_min, t_max):
    """Bool per node: does a decision-step d² of the node under full-graph
    propagation (float64) lie within D2_MARGIN of t_s²?"""
    from repro_torch.gnn.nai import support_stationary_factors
    sup = graph_as_support(store, r)
    x = np.asarray(store.features, np.float64)
    c, s = support_stationary_factors(store, sup, x.astype(np.float32), r)
    x_inf = c[:, None] * s[None, :]
    ts2 = t_s ** 2
    near = np.zeros(store.n, bool)
    for l in range(1, t_max):
        nxt = np.zeros_like(x)
        np.add.at(nxt, sup.dst, sup.coef.astype(np.float64)[:, None]
                  * x[sup.src])
        x = nxt
        if l >= t_min:
            d2 = ((x - x_inf) ** 2).sum(axis=1)
            near |= np.abs(d2 - ts2) <= D2_MARGIN * ts2
    return near


@pytest.fixture(scope="module")
def setup():
    jstore, tstore = j_make_graph(**GRAPH), make_graph(**GRAPH)
    t_s = first_step_distance_quantile(tstore, 0.5, 0.5)
    kw = dict(k=T_MAX, r=0.5, hidden=16, mlp_layers=2)
    jcfg = JConfig("sgc", tstore.feat_dim, tstore.num_classes, **kw)
    tcfg = GNNConfig("sgc", tstore.feat_dim, tstore.num_classes, **kw)
    params = {"cls": j_init(jcfg, jax.random.PRNGKey(0))}
    tree = {l: {k: np.asarray(v) for k, v in p.items()}
            for l, p in params["cls"].items()}
    heads = params_from_numpy(tcfg, tree, device="cpu")
    jnai = JNAI(t_s=t_s, t_min=1, t_max=T_MAX)
    nai = NAIConfig(t_s=t_s, t_min=1, t_max=T_MAX)
    with tempfile.TemporaryDirectory() as d:
        jref = j_run(jstore, jcfg, params, jnai, JOffline(ckpt_dir=d + "/j"))
        ref = run_full_graph_infer(tstore, tcfg, heads, nai,
                                   OfflineConfig(ckpt_dir=d + "/t",
                                                 device="cpu"))
    hist = ref.stats["exit_histogram"]
    assert hist[1] > 0 and hist[T_MAX] > 0, hist
    return dict(jstore=jstore, store=tstore, t_s=t_s, jcfg=jcfg, cfg=tcfg,
                params=params, heads=heads, jnai=jnai, nai=nai, jref=jref,
                ref=ref, near=_decision_near(tstore, 0.5, t_s, 1, T_MAX))


def _run(s, ck, **kw):
    plan = kw.pop("fault_plan", None)
    return run_full_graph_infer(s["store"], s["cfg"], s["heads"], s["nai"],
                                OfflineConfig(ckpt_dir=ck, device="cpu",
                                              **kw), fault_plan=plan)


def _same(res, ref):
    np.testing.assert_array_equal(res.predictions, ref.predictions)
    np.testing.assert_array_equal(res.exit_orders, ref.exit_orders)


def _arrays(rng):
    out = {}
    for i, dt in enumerate((np.float32, np.int32, np.float64, np.int64)):
        shape = tuple(int(v) for v in rng.integers(1, 7, size=2))
        out[f"a{i}"] = (rng.standard_normal(shape) * 100).astype(dt)
    return out


# ------------------------------------------------------- checkpoints
def test_checkpoint_round_trip_bit_identical(tmp_path):
    rng = np.random.default_rng(0)
    mgr = CheckpointManager(str(tmp_path), fingerprint=FP)
    saved = {}
    for step in range(4):
        saved[step] = _arrays(rng)
        mgr.save_step(step, saved[step])
    assert mgr.steps() == [0, 1, 2, 3]
    assert mgr.latest_complete(verify=True) == 3
    again = CheckpointManager(str(tmp_path), fingerprint=FP)
    for step, arrays in saved.items():
        got = again.load_step(step)
        assert set(got) == set(arrays)
        for k, a in arrays.items():
            assert got[k].dtype == a.dtype and got[k].shape == a.shape
            np.testing.assert_array_equal(got[k], a)
    assert again.total_bytes() == mgr.total_bytes() > 0


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoint_directories_read_across_packages(tmp_path, writer):
    """A directory written by one package loads in the other: the same
    manifest, the same CRCs, every payload bit-identical."""
    Write, Read = ((CheckpointManager, jck.CheckpointManager)
                   if writer == "port"
                   else (jck.CheckpointManager, CheckpointManager))
    rng = np.random.default_rng(1)
    w = Write(str(tmp_path), fingerprint=FP)
    saved = {step: _arrays(rng) for step in range(3)}
    for step, arrays in saved.items():
        w.save_step(step, arrays)
    w.save_result({"predictions": np.arange(9, dtype=np.int32)})
    r = Read(str(tmp_path), fingerprint=FP)
    assert r.steps() == [0, 1, 2]
    assert r.latest_complete(verify=True) == 2
    assert r.total_bytes() == w.total_bytes()
    for step, arrays in saved.items():
        got = r.load_step(step)
        for k, a in arrays.items():
            assert got[k].dtype == a.dtype
            np.testing.assert_array_equal(got[k], a)
    np.testing.assert_array_equal(r.load_result()["predictions"],
                                  np.arange(9, dtype=np.int32))
    with pytest.raises((CheckpointMismatch, jck.CheckpointMismatch)):
        Read(str(tmp_path), fingerprint={**FP, "shards": 2})


def test_checkpoint_uncommitted_payloads_are_invisible(tmp_path):
    mgr = CheckpointManager(str(tmp_path), fingerprint=FP,
                            injector=FaultPlan(
                                [FaultSpec("ckpt_write", at=(1,))]
                            ).injector())
    mgr.save_step(0, {"x": np.zeros(4, np.float32)})
    with pytest.raises(InjectedFault):
        mgr.save_step(1, {"x": np.ones(4, np.float32)})
    assert os.path.isdir(tmp_path / "step_00001")
    again = CheckpointManager(str(tmp_path), fingerprint=FP)
    assert again.steps() == [0]
    assert not os.path.exists(str(tmp_path / MANIFEST) + ".tmp")
    with pytest.raises(CheckpointError):
        again.load_step(1)


def test_checkpoint_corruption_is_typed(tmp_path):
    rng = np.random.default_rng(2)
    mgr = CheckpointManager(str(tmp_path), fingerprint=FP)
    for step in range(3):
        mgr.save_step(step, {"x": rng.standard_normal(64)})
    path = tmp_path / "step_00002" / "x.npy"
    with open(path, "r+b") as fh:
        fh.seek(os.path.getsize(path) // 2)
        b = fh.read(1)
        fh.seek(-1, 1)
        fh.write(bytes([b[0] ^ 0xFF]))
    again = CheckpointManager(str(tmp_path), fingerprint=FP)
    with pytest.raises(CheckpointCorruption, match="CRC mismatch"):
        again.load_step(2)
    assert again.latest_complete(verify=True) == 1
    path0 = tmp_path / "step_00000" / "x.npy"
    with open(path0, "r+b") as fh:
        fh.truncate(os.path.getsize(path0) // 2)
    with pytest.raises(CheckpointCorruption):
        again.load_step(0)
    os.remove(tmp_path / "step_00001" / "x.npy")
    with pytest.raises(CheckpointCorruption, match="missing"):
        again.load_step(1)
    assert again.latest_complete(verify=True) is None


def test_checkpoint_manifest_and_fingerprint(tmp_path):
    mgr = CheckpointManager(str(tmp_path), fingerprint=FP)
    mgr.save_step(0, {"x": np.zeros(2, np.float32)})
    CheckpointManager(str(tmp_path), fingerprint=dict(FP))
    with pytest.raises(CheckpointMismatch):
        CheckpointManager(str(tmp_path), fingerprint={**FP, "shards": 2})
    bad = CheckpointManager(str(tmp_path), fingerprint=FP,
                            injector=FaultPlan(
                                [FaultSpec("ckpt_read", at=(0,))]
                            ).injector())
    with pytest.raises(CheckpointCorruption, match="injected"):
        bad.load_step(0)
    bad.load_step(0)
    doc = json.load(open(tmp_path / MANIFEST))
    doc["format"] = "some-other-format"
    json.dump(doc, open(tmp_path / MANIFEST, "w"))
    with pytest.raises(CheckpointMismatch, match="format"):
        CheckpointManager(str(tmp_path), fingerprint=FP)
    with open(tmp_path / MANIFEST, "w") as fh:
        fh.write("{not json")
    with pytest.raises(CheckpointCorruption, match="not valid JSON"):
        CheckpointManager(str(tmp_path))
    with open(tmp_path / MANIFEST, "w") as fh:
        json.dump({"format": FORMAT, "nothing": 1}, fh)
    with pytest.raises(CheckpointCorruption, match="steps table"):
        CheckpointManager(str(tmp_path))


# ------------------------------------------------ whole-graph packing
def test_graph_as_support_array_equal(setup):
    a = graph_as_support(setup["store"], 0.5)
    b = j_graph_as_support(setup["jstore"], 0.5)
    for k in ("nodes", "hop", "src", "dst", "coef"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    assert (a.n_batch, a.sub_edges) == (b.n_batch, b.sub_edges)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("stationary", [False, True])
def test_pack_graph_array_equal(setup, impl, stationary):
    _, a = pack_graph(setup["store"], 1, 0.5, impl, stationary=stationary)
    _, b = j_pack_graph(setup["jstore"], 1, 0.5, impl,
                        stationary=stationary)
    for k in ("tiles", "tile_col", "valid", "hop_rb", "x0", "x_inf", "src",
              "dst", "coef", "c_inf", "s_inf"):
        va, vb = getattr(a, k), getattr(b, k)
        assert (va is None) == (vb is None), k
        if va is not None:
            np.testing.assert_array_equal(va, vb, err_msg=k)
    assert (a.n_batch, a.nb_real, a.n_pad) == (b.n_batch, b.nb_real,
                                               b.n_pad)


def test_first_step_quantile_matches_jax(setup):
    assert setup["t_s"] == pytest.approx(
        j_quantile(setup["jstore"], 0.5, 0.5), rel=1e-6)


# ------------------------------------------------------- supersteps
@pytest.mark.parametrize("impl", IMPLS)
def test_superstep_chain_equals_masked_loop_bitwise(setup, impl):
    """A chain of supersteps from X^(0) equals the single-dispatch loop
    bit for bit — states, exit orders — including a node exiting at every
    order, so the live predicate and the threshold sentinel are both
    exercised; a chain resumed from a host copy of step 1 does too."""
    nai = setup["nai"]
    be, packed = pack_graph(setup["store"], 1, 0.5, impl, stationary=True)
    sa = step_active_blocks(packed.hop_rb, T_MAX) if be.uses_tiles else None
    ops = pack_operands(be, packed, sa)
    if be.uses_dense_x_inf:
        ops["x_inf"] = packed.x_inf
    eo_loop, series = run_propagation(be, nai, dict(ops), packed.x0,
                                      packed.n_batch, device="cpu")
    step = make_superstep(be, nai, n_batch=packed.n_batch,
                          n_rows=packed.n_pad, device="cpu")
    x = torch.from_numpy(packed.x0)
    eo = torch.zeros(packed.n_batch, dtype=torch.int32)
    for l in range(1, T_MAX + 1):
        x, eo = step(ops, x, eo, l)
        assert torch.equal(x[:packed.n_batch], series[l]), l
        if l == 1:   # resume from a host round trip of the state
            x = torch.from_numpy(x.numpy().copy())
    eo = torch.where(eo == 0, T_MAX, eo)
    assert torch.equal(eo, eo_loop)
    assert set(eo.tolist()) == {1, 2, 3}
    with pytest.raises(ValueError, match="outside"):
        step(ops, x, eo, T_MAX + 1)


# ----------------------------------------------------- the offline job
@pytest.mark.parametrize("impl", IMPLS)
def test_offline_job_matches_jax_and_own_serving_path(setup, impl, tmp_path):
    """Every backend of the port equals the port's serving path
    (`make_compiled_infer`) on the same pack exactly, and the JAX package's
    outside the threshold margin."""
    s = setup
    res = _run(s, str(tmp_path / "ck"), spmm_impl=impl)
    be, packed = pack_graph(s["store"], 1, 0.5, impl, stationary=True)
    sa = step_active_blocks(packed.hop_rb, T_MAX) if be.uses_tiles else None
    run = make_compiled_infer(s["cfg"], s["nai"], spmm_impl=impl,
                              device="cpu")
    preds, eo = run(s["heads"], pack_operands(be, packed, sa),
                    torch.from_numpy(packed.x0),
                    torch.from_numpy(packed.x_inf))
    n = s["store"].n
    np.testing.assert_array_equal(res.predictions, preds.numpy()[:n])
    np.testing.assert_array_equal(res.exit_orders, eo.numpy()[:n])
    assert_orders_match(res.predictions, res.exit_orders,
                        s["jref"].predictions, s["jref"].exit_orders,
                        s["near"])
    assert res.stats["supersteps_run"] == T_MAX
    assert res.stats["ckpt_bytes"] > 0 and res.stats["device"] == "cpu"


@pytest.mark.parametrize("impl", ["segment", "fused"])
def test_kill_at_every_superstep_resumes_bit_identical(setup, impl,
                                                      tmp_path):
    ref = _run(setup, str(tmp_path / "clean"), spmm_impl=impl)
    for k in range(T_MAX):
        ck = str(tmp_path / f"kill{k}")
        with pytest.raises(PreemptionSimulated):
            _run(setup, ck, spmm_impl=impl, crash_after=k)
        res = _run(setup, ck, spmm_impl=impl)
        assert res.stats["resumed_from"] == k
        assert res.stats["supersteps_run"] == T_MAX - k
        _same(res, ref)


def test_repeated_preemption_and_completed_rerun(setup, tmp_path):
    ck = str(tmp_path / "ck")
    for k in range(T_MAX):
        with pytest.raises(PreemptionSimulated):
            _run(setup, ck, crash_after=k)
    _same(_run(setup, ck), setup["ref"])
    again = _run(setup, ck)
    assert again.stats["resumed_from"] == T_MAX
    assert again.stats["supersteps_run"] == 0
    _same(again, setup["ref"])
    fresh = _run(setup, ck, resume=False)
    assert fresh.stats["resumed_from"] == 0
    assert fresh.stats["supersteps_run"] == T_MAX
    _same(fresh, setup["ref"])


def test_resume_from_a_jax_checkpoint(setup, tmp_path):
    """The JAX package's checkpoint directory, killed after superstep 1,
    resumes in the port (same fingerprint, same format)."""
    s = setup
    ck = str(tmp_path / "ck")
    with pytest.raises(Exception, match="preemption"):
        j_run(s["jstore"], s["jcfg"], s["params"], s["jnai"],
              JOffline(ckpt_dir=ck, crash_after=1))
    res = _run(s, ck)
    assert res.stats["resumed_from"] == 1
    assert_orders_match(res.predictions, res.exit_orders,
                        s["jref"].predictions, s["jref"].exit_orders,
                        s["near"])


def test_corrupt_checkpoint_falls_back_one_superstep(setup, tmp_path):
    ck = str(tmp_path / "ck")
    with pytest.raises(PreemptionSimulated):
        _run(setup, ck, crash_after=2)
    path = os.path.join(ck, "step_00002", "x.npy")
    with open(path, "r+b") as fh:
        fh.seek(os.path.getsize(path) // 2)
        b = fh.read(1)
        fh.seek(-1, 1)
        fh.write(bytes([b[0] ^ 0xFF]))
    res = _run(setup, ck)
    assert res.stats["resumed_from"] == 1
    assert res.stats["corrupt_steps"] == 1 and res.stats["fallbacks"]
    _same(res, setup["ref"])


def test_checkpoint_faults_are_tolerated(setup, tmp_path):
    ck = str(tmp_path / "w")
    with pytest.raises(PreemptionSimulated):
        _run(setup, ck, crash_after=T_MAX,
             fault_plan=FaultPlan([FaultSpec("ckpt_write", at=(2,))]))
    res = _run(setup, ck)
    assert res.stats["resumed_from"] < T_MAX
    _same(res, setup["ref"])
    ck = str(tmp_path / "r")
    with pytest.raises(PreemptionSimulated):
        _run(setup, ck, crash_after=2)
    res = _run(setup, ck,
               fault_plan=FaultPlan([FaultSpec("ckpt_read", at=(0,))]))
    assert res.stats["corrupt_steps"] >= 1
    _same(res, setup["ref"])


def test_superstep_hang_retries_then_times_out(setup, tmp_path):
    res = _run(setup, str(tmp_path / "a"),
               fault_plan=FaultPlan([FaultSpec("superstep_hang", at=(0,),
                                               max_fires=1)]))
    assert res.stats["watchdog_retries"] == 1
    assert res.stats["injected"]["superstep_hang"]["fired"] == 1
    _same(res, setup["ref"])
    with pytest.raises(WatchdogTimeout):
        _run(setup, str(tmp_path / "b"),
             fault_plan=FaultPlan([FaultSpec("superstep_hang", rate=1.0)]))


def test_fault_firing_matches_jax_offline_job(setup, tmp_path):
    """The same plan through both offline jobs fires the same faults."""
    s = setup
    spec = dict(stage="superstep_hang", rate=0.4)
    res = _run(s, str(tmp_path / "t"),
               fault_plan=FaultPlan([FaultSpec(**spec)], seed=5))
    jres = j_run(s["jstore"], s["jcfg"], s["params"], s["jnai"],
                 JOffline(ckpt_dir=str(tmp_path / "j")),
                 fault_plan=JPlan([JSpec(**spec)], seed=5))
    assert res.stats["injected"] == jres.stats["injected"]
    assert res.stats["watchdog_retries"] == jres.stats["watchdog_retries"]


def test_offline_config_validation():
    with pytest.raises(ValueError, match="ckpt_dir"):
        OfflineConfig(ckpt_dir="")
    with pytest.raises(ValueError, match="watchdog_s"):
        OfflineConfig(ckpt_dir="x", watchdog_s=-1)
    with pytest.raises(ValueError, match="straggler_factor"):
        OfflineConfig(ckpt_dir="x", straggler_factor=1.0)
    with pytest.raises(ValueError, match="crash_after"):
        OfflineConfig(ckpt_dir="x", crash_after=-1)
    with pytest.raises(ValueError, match="gather_mode"):
        OfflineConfig(ckpt_dir="x", gather_mode="ring")


def test_cli_kill_resume_on_the_cpu(tmp_path):
    """The CLI on a store directory: a run preempted after superstep 1
    exits 17, the same command resumes it, and its result equals a clean
    run's."""
    store = str(tmp_path / "store")
    save_graph_store(make_graph(**{**GRAPH, "n": 600}), store)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    base = [sys.executable, "-m", "repro_torch.launch.full_graph_infer",
            "--store", store, "--t-max", "3", "--t-s-quantile", "0.5",
            "--impl", "fused", "--device", "cpu"]
    clean = str(tmp_path / "clean")
    subprocess.run(base + ["--ckpt", clean], env=env, check=True,
                   timeout=300, capture_output=True)
    kill = str(tmp_path / "kill")
    p = subprocess.run(base + ["--ckpt", kill, "--crash-after", "1"],
                       env=env, timeout=300, capture_output=True)
    assert p.returncode == EXIT_PREEMPTED, p.stderr
    p = subprocess.run(base + ["--ckpt", kill], env=env, check=True,
                       timeout=300, capture_output=True, text=True)
    assert '"resumed_from": 1' in p.stdout
    for name in ("predictions", "exit_orders"):
        a = np.load(os.path.join(clean, "result", name + ".npy"))
        b = np.load(os.path.join(kill, "result", name + ".npy"))
        np.testing.assert_array_equal(a, b)
