"""The port's checkpoints against the JAX package's (`repro.checkpoint`):
its msgpack encoder byte for byte against `msgpack` itself, files read
both ways between the packages (bfloat16 included), a JAX LM checkpoint
through the port's reader and `lm_params_from_numpy` giving the
reference's logits, the GNN launcher's checkpoint read by the JAX
package, and `launch.train --arch ... --ckpt` killed after a checkpoint
and resumed, bit-equal to a run that was not."""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as jax_load
from repro.checkpoint import save_checkpoint as jax_save
from repro.configs import ARCHS as JAX_ARCHS, smoke as jax_smoke
from repro.models import decoder_lm as JM
from repro_torch.checkpoint import (load_checkpoint, packb, read_tree,
                                    save_checkpoint, unpackb)
from repro_torch.configs import ARCHS, smoke
from repro_torch.models import decoder_lm as M
from repro_torch.models.convert import lm_params_from_numpy

ROOT = Path(__file__).resolve().parents[1]
PAYLOADS = [
    0, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32, 2 ** 64 - 1,
    -1, -32, -33, -128, -129, -2 ** 15 - 1, -2 ** 31 - 1, -2 ** 63,
    "", "x" * 31, "x" * 32, "é" * 200, "x" * 70000,
    b"", b"\0" * 255, b"\1" * 256, b"\2" * 70000,
    list(range(15)), list(range(16)), list(range(70000)),
    {str(i): i for i in range(15)}, {str(i): [i] for i in range(16)},
    {"step": 12, "arrays": {"params/embed": {
        "dtype": "bfloat16", "shape": [3, 4], "data": bytes(range(24))}}},
    None, True, False, 1.5,
]


@pytest.mark.parametrize("obj", PAYLOADS, ids=range(len(PAYLOADS)))
def test_encoder_bytes_equal_msgpack(obj):
    want = msgpack.packb(obj, use_bin_type=True)
    assert packb(obj) == want
    assert unpackb(want) == msgpack.unpackb(want, raw=False)


def test_decoder_refuses_what_the_format_lacks():
    with pytest.raises(ValueError, match="trailing"):
        unpackb(packb(1) + b"\0")
    with pytest.raises(ValueError, match="not in the checkpoint format"):
        unpackb(b"\xc7\x01\x05\x00")          # ext 8
    with pytest.raises(ValueError, match="truncated"):
        unpackb(packb(b"abcd")[:-1])


def _tree():
    rng = np.random.default_rng(0)
    return {"a": {"w": rng.standard_normal((3, 4)).astype(np.float32),
                  "i": np.arange(5, dtype=np.int32)},
            "b": (rng.standard_normal((2,)).astype(np.float32),
                  np.zeros((), np.int32)),
            "bf": jnp.asarray(rng.standard_normal((4, 2)), jnp.bfloat16)}


def test_files_load_both_ways(tmp_path):
    """A JAX file read by the port, a port file read by JAX: every dtype
    (bf16 too), shape and bit, and the step."""
    ref = _tree()
    jax_save(str(tmp_path / "j.ckpt"), ref, 7)
    got, step = load_checkpoint(str(tmp_path / "j.ckpt"), jax.tree.map(
        lambda a: torch.zeros(a.shape), ref))
    assert step == 7
    assert got["bf"].dtype == torch.bfloat16
    flat_ref = jax.tree_util.tree_leaves(ref)
    flat_got = jax.tree_util.tree_leaves(got)
    for a, b in zip(flat_ref, flat_got):
        want = np.asarray(a)
        assert tuple(b.shape) == want.shape
        assert b.reshape(-1).view(torch.uint8).numpy().tobytes() == \
            want.tobytes()
    # the port writes torch tensors (bf16 from a tensor) and numpy arrays
    ours = {"a": {"w": torch.tensor(np.asarray(ref["a"]["w"])),
                  "i": np.asarray(ref["a"]["i"])},
            "b": [torch.tensor(np.asarray(ref["b"][0])),
                  torch.zeros((), dtype=torch.int32)],
            "bf": got["bf"]}
    save_checkpoint(str(tmp_path / "t.ckpt"), ours, 9)
    back, step = jax_load(str(tmp_path / "t.ckpt"), ref)
    assert step == 9
    for a, b in zip(jax.tree_util.tree_leaves(ref),
                    jax.tree_util.tree_leaves(back)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    # and the file is what msgpack makes of the same payload
    raw = (tmp_path / "t.ckpt").read_bytes()
    assert packb(msgpack.unpackb(raw, raw=False)) == raw
    assert not os.path.exists(str(tmp_path / "t.ckpt") + ".tmp")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_lm_checkpoint_serves_in_the_port(tmp_path, dtype):
    """granite smoke's JAX params saved by the JAX package, read by
    `read_tree` and carried into the port by `lm_params_from_numpy`:
    every parameter bit-equal, and the forward logits the reference's at
    tests/test_torch_lm_models.py's tolerance, 5e-4 (bf16 parameters
    widened to f32 in both packages, as the port's layers take one
    dtype)."""
    import dataclasses
    kw = dict(dtype="float32", param_dtype=dtype)
    jcfg = dataclasses.replace(jax_smoke(JAX_ARCHS["granite-34b"]), **kw)
    tcfg = dataclasses.replace(smoke(ARCHS["granite-34b"]), **kw)
    params = JM.init_params(jcfg, jax.random.PRNGKey(0))
    jax_save(str(tmp_path / "lm.ckpt"), {"params": params}, 3)
    tree, step = read_tree(str(tmp_path / "lm.ckpt"))
    assert step == 3
    model = lm_params_from_numpy(tcfg, tree["params"], device="cpu")
    want = lm_params_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                                device="cpu")
    for (n, p), (_, q) in zip(model.named_parameters(),
                              want.named_parameters()):
        assert p.dtype == getattr(torch, dtype) and torch.equal(p, q), n
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size,
                                             (2, 12)).astype(np.int32)
    f32 = dataclasses.replace(tcfg, param_dtype="float32")
    got = M.forward(f32, model.float(), torch.tensor(toks).long())[0]
    ref = JM.forward(dataclasses.replace(jcfg, param_dtype="float32"),
                     jax.tree.map(lambda a: a.astype(jnp.float32), params),
                     jnp.asarray(toks))[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=5e-4,
                               atol=5e-4)


def test_gnn_checkpoint_loads_in_the_jax_package(tmp_path):
    """`launch.train --gnn ... --ckpt` writes the heads as the JAX
    package's params tree; the JAX package loads the file into that
    structure, equal to the port's heads."""
    from repro_torch.launch import train
    path = str(tmp_path / "gnn.ckpt")
    train.main(["--gnn", "pubmed-like", "--k", "2", "--scale", "0.03",
                "--epochs", "4", "--device", "cpu", "--ckpt", path])
    tree, step = read_tree(path)
    assert step == 4 and set(tree) == {"cls", "ens_s"}
    like = jax.tree.map(lambda t: np.zeros(t.shape, np.float32), tree)
    back, step = jax_load(path, like)
    assert step == 4
    assert sorted(back["cls"]) == [1, 2]
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def _train(args, kill_at=None):
    """`launch.train` in a subprocess on the CPU; with `kill_at`, killed
    as soon as it reports the checkpoint of that step."""
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "rwkv6-3b", "--smoke", "--batch", "2", "--seq", "32",
           "--log-every", "1", "--device", "cpu", *args]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL, text=True)
    lines = []
    try:
        for line in proc.stdout:
            lines.append(line)
            if kill_at is not None and f"(step {kill_at})" in line:
                proc.kill()
                break
    finally:
        proc.stdout.close()
        proc.wait(timeout=120)
    if kill_at is None:
        assert proc.returncode == 0, lines
    return "".join(lines)


def test_train_cli_killed_and_resumed_equals_uninterrupted(tmp_path):
    """12 steps with a checkpoint every 6, killed right after the one of
    step 6, then `--resume`: the resumed run starts at step 6 and its
    final checkpoint (parameters, moments, count) equals, bit for bit,
    that of the same 12 steps run without a break."""
    full, cut = str(tmp_path / "full.ckpt"), str(tmp_path / "cut.ckpt")
    common = ["--steps", "12", "--ckpt-every", "6"]
    _train(common + ["--ckpt", full])
    _train(common + ["--ckpt", cut], kill_at=6)
    _, step = read_tree(cut)
    assert step == 6
    out = _train(common + ["--ckpt", cut, "--resume"])
    assert "resumed from step 6" in out and "step     5 " not in out
    a, sa = read_tree(full)
    b, sb = read_tree(cut)
    assert sa == sb == 12
    fa = jax.tree_util.tree_leaves(a)
    fb = jax.tree_util.tree_leaves(b)
    assert len(fa) == len(fb) > 0
    assert all(torch.equal(x, y) for x, y in zip(fa, fb))
