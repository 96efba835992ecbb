"""The port's launchers run end to end on the CPU (`--device cpu`) in a
fresh interpreter at a tiny size, as tests/test_launchers.py runs the
JAX package's, and print the reference's lines."""
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, timeout=300):
    env = dict(os.environ, PYTHONPATH="src", OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, "-m"] + args, cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_train_gnn_cli():
    out = _run(["repro_torch.launch.train", "--gnn", "pubmed-like", "--k",
                "2", "--scale", "0.03", "--epochs", "20", "--device", "cpu"])
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.splitlines()
    assert lines[0].startswith("[train-gnn] pubmed-like n=591 ")
    assert "'base_loss'" in lines[1] and "'online_loss'" in lines[1]
    assert "NAI acc=" in lines[2] and "fp_macs/node=" in lines[2]


def test_serve_gnn_cli():
    out = _run(["repro_torch.launch.serve", "--gnn", "pubmed-like",
                "--requests", "200", "--epochs", "20", "--k", "2",
                "--scale", "0.03", "--device", "cpu"])
    assert out.returncode == 0, out.stderr[-2000:]
    assert "[serve-gnn] training NAI model on pubmed-like" in out.stdout
    assert "served=118 " in out.stdout       # the 118 test nodes at 0.03
    assert "p50=" in out.stdout and "exit histogram" in out.stdout


@pytest.mark.parametrize("arch", ["dbrx-132b", "grok-1-314b"])
def test_serve_lm_moe_cli(arch):
    """The MoE configs (ROADMAP A10.1) serve at `smoke()` size: prefill,
    then greedy decode from its cache (padded to 2 x 8 positions)."""
    out = _run(["repro_torch.launch.serve", "--arch", arch, "--smoke",
                "--tokens", "8", "--batch", "2", "--device", "cpu"])
    assert out.returncode == 0, out.stderr[-2000:]
    assert f"[serve-lm] {arch} on cpu: prefill 2x8 tokens" in out.stdout
    assert "decode 7 steps" in out.stdout
    assert "[serve-lm] sample continuation:" in out.stdout


@pytest.mark.parametrize("arch", ["whisper-small", "llama-3.2-vision-11b"])
def test_serve_lm_frontend_cli(arch):
    """The encoder-decoder and VLM configs (ROADMAP A10.2) serve at
    `smoke()` size with a stub frontend (16 audio frames through the
    encoder, or 8 image embeddings): prefill, then greedy decode."""
    out = _run(["repro_torch.launch.serve", "--arch", arch, "--smoke",
                "--tokens", "8", "--batch", "2", "--device", "cpu"])
    assert out.returncode == 0, out.stderr[-2000:]
    assert f"[serve-lm] {arch} on cpu: prefill 2x8 tokens" in out.stdout
    assert "decode 7 steps" in out.stdout
    assert "[serve-lm] sample continuation:" in out.stdout


def test_train_lm_waits_for_a10_5():
    """A10.5 has landed: `train --arch` trains on the CPU when asked (2
    steps of rwkv6-3b smoke, losses finite) and, without `--device`,
    asks for CUDA and raises here."""
    out = _run(["repro_torch.launch.train", "--arch", "rwkv6-3b"])
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr
    out = _run(["repro_torch.launch.train", "--arch", "rwkv6-3b", "--smoke",
                "--steps", "2", "--batch", "2", "--seq", "16",
                "--log-every", "1", "--device", "cpu"])
    assert out.returncode == 0, out.stderr[-2000:]
    losses = [float(line.split("loss=")[1].split()[0])
              for line in out.stdout.splitlines() if "loss=" in line]
    assert len(losses) == 2 and all(np.isfinite(losses))
