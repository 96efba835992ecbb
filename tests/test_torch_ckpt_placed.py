"""Checkpoints of a placed training state (`repro_torch.checkpoint` with
`ShardedTensor` leaves) against the JAX package's format
(`repro.checkpoint`): on CPU meshes, a placed run killed after a
checkpoint and resumed is bitwise a run without a break, for one config
of each layer family at `smoke()` size; a placed port file loads in the
JAX package and a JAX file loads placed in the port; a file saved on one
mesh loads onto another, and a step from it equals a step from the same
state placed there directly."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as jax_load
from repro.checkpoint import save_checkpoint as jax_save
from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.common import AdaptiveDepthConfig
from repro_torch.configs import ARCHS, smoke
from repro_torch.data import synthetic_stream
from repro_torch.launch.dryrun import build_train_step
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.train import lm_batch
from repro_torch.models import decoder_lm as M
from repro_torch.optim import adamw_init
from repro_torch.sharding import placement as pl
from repro_torch.sharding import use_mesh


def _cfg(arch):
    """The family's smoke config; granite-34b with exit heads at blocks
    0-1 (the training state then holds the exits too)."""
    cfg = smoke(ARCHS[arch])
    if arch == "granite-34b":
        cfg = dataclasses.replace(cfg, num_layers=2, adaptive=(
            AdaptiveDepthConfig(enabled=True, exit_layers=(0, 1), t_min=0,
                                t_max=1)))
    return cfg


def _mesh(data, model):
    return make_mesh(("cpu",) * (data * model), {"data": data,
                                                 "model": model})


class _Run:
    """A smoke model's placed training on one mesh: the same weights
    (seeded 0) and batches each time it is placed."""

    def __init__(self, arch, shape, dtype="float32"):
        self.cfg = dataclasses.replace(_cfg(arch), dtype=dtype,
                                       param_dtype=dtype)
        self.mesh = _mesh(*shape)
        stream = synthetic_stream(0, 4, 16, self.cfg.vocab_size, self.cfg)
        self.batches = [lm_batch(self.cfg, next(stream), "cpu")
                        for _ in range(3)]
        self.step, self.tc = build_train_step(
            self.cfg, learning_rate=3e-3, warmup_steps=0, total_steps=10)

    def placed(self, seed=0, mesh=None):
        model = M.init_params(self.cfg, torch.Generator().manual_seed(seed),
                              device="cpu")
        params = pl.shard_params(model, mesh or self.mesh, trainable=True)
        return {"params": params, "opt": adamw_init(params, self.tc)}

    def steps(self, state, which):
        with use_mesh(state["params"]["embed"].mesh):
            return [float(self.step(state["params"], state["opt"],
                                    self.batches[i])[2]["loss"])
                    for i in which]


def _leaves(state):
    return [(f"{k}.{p}", st) for k, tree in (
        ("params", state["params"]), ("mu", state["opt"]["mu"]),
        ("nu", state["opt"]["nu"])) for p, st in pl.named_leaves(tree)]


def _same(a, b):
    """Every block of every leaf bitwise equal, specs and count too."""
    la, lb = _leaves(a), _leaves(b)
    assert [n for n, _ in la] == [n for n, _ in lb]
    for (n, x), (_, y) in zip(la, lb):
        assert x.spec == y.spec and x.shape == y.shape, n
        for bx, by in zip(x.locals, y.locals):
            assert bx.dtype == by.dtype and torch.equal(bx, by), n
            assert bx.requires_grad == by.requires_grad, n
    assert torch.equal(a["opt"]["count"], b["opt"]["count"])


# one config of each family: attn (granite with exit heads), attn_moe,
# rwkv (at model 4 its 2 heads split: the fallback placement), rglru and
# local, encdec, xattn
CASES = [(arch, shape) for arch in ("granite-34b", "dbrx-132b",
                                    "recurrentgemma-9b", "whisper-small",
                                    "llama-3.2-vision-11b")
         for shape in ((1, 2), (2, 2))] + [
    ("rwkv6-3b", (1, 2)), ("rwkv6-3b", (2, 2)), ("rwkv6-3b", (1, 4))]


@pytest.mark.parametrize("arch,shape", CASES,
                         ids=[f"{a}-{d}x{m}" for a, (d, m) in CASES])
def test_killed_and_resumed_equals_unbroken(arch, shape, tmp_path):
    """Three steps without a break against one step, a save, the state
    deleted, a load into a fresh placement (other weights) and two more
    steps: every parameter and moment block, the count and the losses of
    steps 2-3 bitwise equal."""
    run = _Run(arch, shape)
    whole = run.placed()
    want = run.steps(whole, range(3))
    cut = run.placed()
    run.steps(cut, range(1))
    path = str(tmp_path / "state.ckpt")
    save_checkpoint(path, cut, 1)
    del cut
    got, at = load_checkpoint(path, run.placed(seed=1))
    assert at == 1
    assert run.steps(got, range(1, 3)) == want[1:]
    _same(got, whole)


def _numpy_tree(t):
    """A placed or plain tree as a JAX pytree of numpy arrays (bf16 as
    ml_dtypes' bfloat16)."""
    if isinstance(t, dict):
        return {k: _numpy_tree(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return [_numpy_tree(v) for v in t]
    t = pl.gather(t, "cpu") if pl.is_sharded(t) else t
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return np.asarray(jnp.asarray(t.float().numpy(), jnp.bfloat16))
    return t.numpy()


def _bits(a) -> bytes:
    return np.ascontiguousarray(np.asarray(a)).tobytes()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_placed_files_cross_packages(dtype, tmp_path):
    """whisper-small smoke (the encoder and an odd placement of its
    columns) placed on (2, 2) and stepped once: its file loads in
    `repro.checkpoint.load_checkpoint` into the JAX tree of its
    structure, every array bitwise the gathered leaf (bf16 included);
    the JAX package's save of that tree loads into a placed port `like`
    on (1, 2), every leaf gathering to the same bits."""
    run = _Run("whisper-small", (2, 2), dtype)
    state = run.placed()
    run.steps(state, range(1))
    ref = _numpy_tree(state)
    save_checkpoint(str(tmp_path / "port.ckpt"), state, 1)
    back, step = jax_load(str(tmp_path / "port.ckpt"), ref)
    assert step == 1
    flat_ref = jax.tree_util.tree_leaves(ref)
    flat_back = jax.tree_util.tree_leaves(back)
    assert len(flat_ref) == len(flat_back) > 0
    for a, b in zip(flat_ref, flat_back):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        assert _bits(a) == _bits(b)
    jax_save(str(tmp_path / "jax.ckpt"), ref, 5)
    like = run.placed(seed=1, mesh=_mesh(1, 2))
    got, step = load_checkpoint(str(tmp_path / "jax.ckpt"), like)
    assert step == 5
    for (n, st), (_, want) in zip(_leaves(got), _leaves(state)):
        assert st.mesh == like["params"]["embed"].mesh
        assert torch.equal(pl.gather(st, "cpu"), pl.gather(want, "cpu")), n
    assert torch.equal(got["opt"]["count"], state["opt"]["count"])


def test_file_from_one_mesh_steps_on_another(tmp_path):
    """A state saved on (1, 2) and loaded onto (2, 2) equals the same
    state placed on (2, 2) directly (each gathered leaf `shard`ed by its
    like-leaf's sharding), block for block, and so does the step taken
    from each."""
    run = _Run("dbrx-132b", (1, 2))
    state = run.placed()
    run.steps(state, range(1))
    save_checkpoint(str(tmp_path / "s.ckpt"), state, 1)
    wide = _mesh(2, 2)
    loaded, _ = load_checkpoint(str(tmp_path / "s.ckpt"),
                                run.placed(seed=1, mesh=wide))
    like = run.placed(seed=2, mesh=wide)

    def direct(t, lk):
        if isinstance(t, dict):
            return {k: direct(t[k], lk[k]) for k in t}
        if isinstance(t, (list, tuple)):
            return [direct(a, b) for a, b in zip(t, lk)]
        if not pl.is_sharded(t):
            return t.clone()
        st = pl.shard(pl.gather(t, "cpu").detach(), lk.sharding)
        for b, w in zip(st.locals, lk.locals):
            b.requires_grad_(w.requires_grad)
        return st
    placed = direct(state, like)
    _same(loaded, placed)
    assert run.steps(loaded, range(1, 2)) == run.steps(placed, range(1, 2))
    _same(loaded, placed)
