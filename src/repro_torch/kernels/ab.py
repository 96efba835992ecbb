"""Time B1 and B4 of this checkout against another version, in one run.

Builds ``spmm_block_ell.cu`` (B1) and ``flash_attention.cu`` (B4) from
this checkout and from another checkout of the repository (``--against``,
for example a parent commit unpacked with ``git archive`` into the
git-ignored ``build/``), and times both versions on the same operands
with both rulers of ``chip_smoke.py``: CUDA events around 10
back-to-back calls (per call), and around one call, which adds the
host's launch gap (smaller here than through the Python wrappers: both
versions are called through their C entry points, the same way). Each
reading is the median of 25 warm timings; the
versions are timed in the order other, this, this, other, and both
readings are printed. Before timing, each version is checked against its
plain PyTorch version, and B1's two outputs against each other bit for
bit (on finite operands they run the same ``fmaf`` chain per row).

B1 runs on step 1 of the first pubmed-like batch (full size, as in
``chip_smoke.py``); B4 on recurrentgemma-9b's ``local`` layer shape,
q (2, 4096, 16, 256) and k, v (2, 4096, 1, 256) bf16, window 2048, with
operands drawn from a seed.

    PYTHONPATH=src python -m repro_torch.kernels.ab --against DIR

Needs one CUDA card and ``nvcc``; the other version's library goes to
``build/ab/``.
"""
from __future__ import annotations

import argparse
import hashlib
import subprocess
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import build

SOURCES = ("spmm_block_ell.cu", "flash_attention.cu")
NAMES = ("spmm_block_ell_launch", "flash_attention_launch")
REPS = 25


def other_library(root: Path) -> Path:
    """B1 and B4 built from the checkout at `root` (cached by content)."""
    csrc = root / "src" / "repro_torch" / "csrc"
    h = hashlib.sha256(" ".join(build.NVCC_FLAGS).encode())
    for f in sorted(csrc.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    out = build.BUILD_DIR.parent / "ab" / f"lib-{h.hexdigest()[:16]}.so"
    if not out.exists():
        build.compile_library(csrc, SOURCES, out)
    return out


def time_ms(fn, calls: int) -> float:
    """Median over REPS CUDA-event timings of `calls` back-to-back calls,
    per call, after 3 warm calls."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times))


def b1_operands(dev):
    """Tiles, tile_col, valid, active and x of step 1 of the first
    pubmed-like batch of 500 requests, as `chip_smoke.py` builds them."""
    from repro_torch.gnn import (GNNConfig, NAIConfig, load_dataset,
                                 pack_support, sample_support,
                                 step_active_blocks)
    from repro_torch.gnn.nai import support_stationary_factors
    from repro_torch.gnn.packing import batch_bucket
    from repro_torch.gnn.store import as_store
    g = load_dataset("pubmed-like", scale=1.0, seed=0)
    cfg = GNNConfig("sgc", g.features.shape[1], g.num_classes, k=4,
                    hidden=64, mlp_layers=2)
    nai = NAIConfig(t_s=20.0, t_min=1, t_max=3, batch_size=500)
    requests = np.random.default_rng(0).choice(g.test_idx, size=2000,
                                               replace=False)
    store = as_store(g)
    sup = sample_support(store, np.unique(requests[:nai.batch_size]),
                         nai.t_max, cfg.r)
    x0 = store.gather_features(sup.nodes).astype(np.float32)
    c, s = (a.astype(np.float32)
            for a in support_stationary_factors(store, sup, x0, cfg.r))
    p = pack_support(sup, x0, c[:, None] * s[None, :],
                     nb_bucket=batch_bucket(sup.n_batch),
                     x_inf_factors=(c, s))
    act = step_active_blocks(p.hop_rb, nai.t_max)[0]
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in (p.tiles, p.tile_col, p.valid, act, p.x0))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--against", type=Path, required=True,
                    help="root of the other checkout")
    args = ap.parse_args()
    from repro_torch.kernels.flash_attention import ref_attention
    from repro_torch.kernels.spmm import RB, ref_spmm_block_ell

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    libs = {"other": build.bind(other_library(args.against), NAMES),
            "this": build.library()}
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    calls, outs = {}, {}

    tiles, tile_col, valid, act, x = b1_operands(dev)
    n_rb, tb = tile_col.shape
    F = x.shape[1]
    b1_ref = ref_spmm_block_ell(tiles, tile_col, valid, act, x)
    for tag, lib in libs.items():
        out = torch.empty((n_rb * RB, F), dtype=torch.float32, device=dev)

        def b1(lib=lib, out=out):
            build.check_launch("spmm_block_ell", lib.spmm_block_ell_launch(
                tiles.data_ptr(), tile_col.data_ptr(), valid.data_ptr(),
                act.data_ptr(), x.data_ptr(), out.data_ptr(), n_rb, tb, F,
                0, stream))
        b1()
        torch.cuda.synchronize()
        err = float((out - b1_ref).abs().max())
        print(f"B1 {tag}: max abs err vs plain {err:.3g}")
        if not torch.allclose(out, b1_ref, rtol=1e-5, atol=1e-5):
            raise RuntimeError(f"B1 {tag} disagrees with its plain version")
        calls[("B1", tag)], outs[("B1", tag)] = b1, out
    same = torch.equal(outs[("B1", "this")], outs[("B1", "other")])
    print(f"B1 this == other bitwise: {same}")
    if not same:
        raise RuntimeError("B1: the two versions' outputs differ")

    B, S, H, KV, hd, W = 2, 4096, 16, 1, 256, 2048
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn((B, S, h, hd), generator=g, device=dev,
                           dtype=torch.bfloat16) for h in (H, KV, KV))
    b4_ref = ref_attention(q, k, v, window=W).float()
    for tag, lib in libs.items():
        out = torch.empty_like(q)

        def b4(lib=lib, out=out):
            build.check_launch("flash_attention", lib.flash_attention_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B,
                S, S, H, KV, hd, 1, W, 1.0 / hd ** 0.5, 1, 0, stream))
        b4()
        torch.cuda.synchronize()
        err = float((out.float() - b4_ref).abs().max())
        print(f"B4 {tag}: max abs err vs plain {err:.3g} of values up to "
              f"{float(b4_ref.abs().max()):.3g}")
        if not torch.allclose(out.float(), b4_ref, rtol=1e-2, atol=1e-2):
            raise RuntimeError(f"B4 {tag} disagrees with its plain version")
        calls[("B4", tag)] = b4

    for kern in ("B1", "B4"):
        for n in (10, 1):
            got = {"other": [], "this": []}
            for tag in ("other", "this", "this", "other"):
                got[tag].append(time_ms(calls[(kern, tag)], n))
            print(f"{kern}, {n} call(s) per event pair: other "
                  f"{got['other'][0]:.4f} / {got['other'][1]:.4f} ms, this "
                  f"{got['this'][0]:.4f} / {got['this'][1]:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
