"""The PyTorch port stands alone: no module of `repro_torch` (and not
`chip_smoke.py`) imports JAX or the JAX package, and its entry points run
on CUDA unless told otherwise — raising, never falling back, when no GPU
is present."""
import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.device import resolve_device
from repro_torch.gnn import (DistillConfig, GNNConfig, NAIConfig,
                             init_classifiers, load_dataset,
                             make_compiled_infer, run_propagation, train_nai)
from repro_torch.gnn.backends import get_backend
from repro_torch.gnn.convert import params_from_numpy
from repro_torch.serving import NAIServingEngine

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_repro(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path} imports {mod}"


def test_import_scan_sees_the_whole_port():
    names = {p.name for p in PORT_FILES}
    assert {"engine.py", "backends.py", "chip_smoke.py", "kernel.py",
            "store.py", "propcache.py", "ops.py", "distill.py",
            "baselines.py", "adamw.py", "inception_distill.py",
            "train.py", "faults.py", "frontend.py", "distributed.py",
            "checkpoint.py", "full_graph_infer.py", "moe.py",
            "adaptive_depth.py", "ckpt.py", "tokens.py"} <= names


def test_port_modules_load_no_jax_at_run_time():
    """Imported in a fresh interpreter, the serving path (store, cache,
    sampler, packing, loop, engine, faults, front-end, kernel wrappers),
    the store's generator program, the trainer (optimizer, losses,
    distillation, baselines), both launchers and the offline job (its
    packing, checkpoints and CLI), and the LM's training, checkpoint and
    adaptive-depth modules pull in no module of JAX or of the JAX
    package."""
    import subprocess
    import sys
    code = ("import sys; import repro_torch.gnn, repro_torch.serving, "
            "repro_torch.gnn.store, repro_torch.gnn.propcache, "
            "repro_torch.kernels.nap_exit.ops, repro_torch.optim, "
            "repro_torch.core.inception_distill, repro_torch.gnn.distill, "
            "repro_torch.gnn.baselines, repro_torch.kernels.spmm.ops, "
            "repro_torch.launch.serve, repro_torch.launch.train, "
            "repro_torch.serving.faults, repro_torch.serving.frontend, "
            "repro_torch.gnn.distributed, repro_torch.launch.checkpoint, "
            "repro_torch.launch.full_graph_infer, repro_torch.launch.mesh, "
            "repro_torch.nn.moe, repro_torch.core.adaptive_depth, "
            "repro_torch.checkpoint, repro_torch.data, "
            "repro_torch.models.decoder_lm, repro_torch.models.convert; "
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')); "
            "assert not bad, bad")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device_raises_without_cuda(monkeypatch):
    _no_cuda(monkeypatch)
    assert resolve_device("cpu") == torch.device("cpu")
    for dev in ("cuda", "cuda:0", torch.device("cuda")):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_device(dev)


def test_entry_points_default_to_cuda(monkeypatch, tmp_path):
    """With no device argument every entry point asks for CUDA — and so
    raises here, where there is none."""
    from repro_torch.gnn.backends import make_superstep
    from repro_torch.gnn.store import save_graph_store
    from repro_torch.launch import full_graph_infer as offline
    from repro_torch.serving import ServingFrontend, default_slo_classes
    _no_cuda(monkeypatch)
    g = load_dataset("pubmed-like", scale=0.02, seed=4)
    g = dataclasses.replace(g, features=np.ascontiguousarray(
        g.features[:, :64]))
    cfg = GNNConfig("sgc", 64, g.num_classes, k=2)
    nai = NAIConfig(t_s=6.0, t_max=2, batch_size=8)
    gen = torch.Generator().manual_seed(0)
    heads = init_classifiers(cfg, gen, device="cpu")
    tree = {l: {f"{kind}{i}": (lin.weight.detach().numpy().T if kind == "w"
                               else lin.bias.detach().numpy())
                for i, lin in enumerate(heads.head(l).layers)
                for kind in ("w", "b")}
            for l in (1, 2)}
    calls = {
        "init_classifiers": lambda **kw: init_classifiers(cfg, gen, **kw),
        "params_from_numpy": lambda **kw: params_from_numpy(cfg, tree, **kw),
        "make_compiled_infer": lambda **kw: make_compiled_infer(cfg, nai,
                                                                **kw),
        "run_propagation": lambda **kw: run_propagation(
            get_backend("segment"), nai, {}, np.zeros((128, 128),
                                                      np.float32), 8, **kw),
        "NAIServingEngine(host)": lambda **kw: NAIServingEngine(
            cfg, nai, heads, g, **kw),
        "NAIServingEngine(compiled)": lambda **kw: NAIServingEngine(
            cfg, nai, heads, g, mode="compiled", spmm_impl="fused", **kw),
        "NAIServingEngine(cached)": lambda **kw: NAIServingEngine(
            cfg, nai, heads, g, mode="compiled", cache_nodes=64, **kw),
        "train_nai": lambda **kw: train_nai(cfg, g, DistillConfig(
            epochs_base=1, epochs_offline=1, epochs_online=1), **kw),
        "ServingFrontend": lambda **kw: ServingFrontend(
            cfg, heads, g, default_slo_classes(nai), spmm_impl="fused",
            **kw),
        "make_superstep": lambda **kw: make_superstep(
            get_backend("fused"), nai, n_batch=8, n_rows=128, **kw),
        "run_full_graph_infer": lambda **kw: offline.run_full_graph_infer(
            g, cfg, heads, nai, offline.OfflineConfig(
                ckpt_dir=str(tmp_path / "ck"), spmm_impl="fused", **kw)),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    # the same entry points build on the CPU when asked to
    # the offline CLI asks for CUDA before it reads the store
    store = save_graph_store(g, str(tmp_path / "store"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        offline._main(["--store", store, "--ckpt", str(tmp_path / "c")])
    assert offline._main(["--store", store, "--ckpt", str(tmp_path / "c"),
                          "--t-max", "2", "--t-s", "6", "--device",
                          "cpu"]) == 0
    for name in ("init_classifiers", "params_from_numpy",
                 "make_compiled_infer", "NAIServingEngine(host)",
                 "NAIServingEngine(compiled)", "NAIServingEngine(cached)",
                 "train_nai", "ServingFrontend", "make_superstep",
                 "run_full_graph_infer"):
        calls[name](device="cpu")


def test_kernel_wrappers_refuse_mixed_devices():
    from repro_torch.kernels.nap_exit import nap_exit
    x = torch.zeros((8, 128))
    with pytest.raises(ValueError, match="several devices"):
        nap_exit(x, torch.zeros((8, 128), device="meta"),
                 torch.ones((8, 1), dtype=torch.int32), 1.0)


def test_lm_entry_points_default_to_cuda(monkeypatch):
    """The LM path's entry points and both launchers (LM and GNN modes)
    ask for CUDA unless told otherwise."""
    from repro_torch.configs import ARCHS, smoke
    from repro_torch.launch import serve, train
    from repro_torch.models import decoder_lm as M
    from repro_torch.models.convert import lm_params_from_numpy
    from repro_torch.serving import LMServingEngine
    _no_cuda(monkeypatch)
    cfg = smoke(ARCHS["rwkv6-3b"])
    model = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    calls = {
        "init_params": lambda: M.init_params(
            cfg, torch.Generator().manual_seed(0)),
        "init_cache": lambda: M.init_cache(cfg, 2, 8),
        "lm_params_from_numpy": lambda: lm_params_from_numpy(cfg, {}),
        "LMServingEngine": lambda: LMServingEngine(cfg, model),
        "LMServingEngine(adaptive)": lambda: LMServingEngine(
            cfg, model, adaptive=True),
        "serve": lambda: serve.main(["--arch", "rwkv6-3b", "--smoke"]),
        "train --arch": lambda: train.main(["--arch", "rwkv6-3b",
                                            "--smoke"]),
        "serve --gnn": lambda: serve.main(["--gnn", "pubmed-like"]),
        "train --gnn": lambda: train.main(["--gnn", "pubmed-like"]),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    LMServingEngine(cfg, model, device="cpu")
    serve.main(["--arch", "rwkv6-3b", "--smoke", "--device", "cpu",
                "--tokens", "4", "--batch", "2"])
    train.main(["--arch", "rwkv6-3b", "--smoke", "--device", "cpu",
                "--steps", "1", "--batch", "1", "--seq", "8"])
