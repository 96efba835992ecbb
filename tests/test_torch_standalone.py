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
from repro_torch.gnn import (GNNConfig, NAIConfig, init_classifiers,
                             load_dataset, make_compiled_infer,
                             run_propagation)
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
    assert {"engine.py", "backends.py", "chip_smoke.py",
            "kernel.py"} <= names


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device_raises_without_cuda(monkeypatch):
    _no_cuda(monkeypatch)
    assert resolve_device("cpu") == torch.device("cpu")
    for dev in ("cuda", "cuda:0", torch.device("cuda")):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_device(dev)


def test_entry_points_default_to_cuda(monkeypatch):
    """With no device argument every entry point asks for CUDA — and so
    raises here, where there is none."""
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
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    # the same entry points build on the CPU when asked to
    for name in ("init_classifiers", "params_from_numpy",
                 "make_compiled_infer", "NAIServingEngine(host)",
                 "NAIServingEngine(compiled)"):
        calls[name](device="cpu")


def test_kernel_wrappers_refuse_mixed_devices():
    from repro_torch.kernels.nap_exit import nap_exit
    x = torch.zeros((8, 128))
    with pytest.raises(ValueError, match="several devices"):
        nap_exit(x, torch.zeros((8, 128), device="meta"),
                 torch.ones((8, 1), dtype=torch.int32), 1.0)


def test_lm_entry_points_default_to_cuda(monkeypatch):
    """The LM path's entry points ask for CUDA unless told otherwise."""
    from repro_torch.configs import ARCHS, smoke
    from repro_torch.launch import serve
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
        "serve": lambda: serve.main(["--arch", "rwkv6-3b", "--smoke"]),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    LMServingEngine(cfg, model, device="cpu")
    serve.main(["--arch", "rwkv6-3b", "--smoke", "--device", "cpu",
                "--tokens", "4", "--batch", "2"])
