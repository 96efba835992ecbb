"""Time B1, B2, B4 and B5 of this checkout against another version, in
one run.

Builds ``spmm_block_ell.cu`` (B1), ``nap_step_fused.cu`` (B2),
``flash_attention.cu`` (B4) and ``wkv6.cu`` (B5) from this checkout and
from another checkout of the repository (``--against``, for example a
parent commit unpacked with ``git archive`` into the git-ignored
``build/``), and times both versions on the same operands with both
rulers of ``chip_smoke.py``: CUDA events around 10 back-to-back calls
(per call), and around one call, which adds the host's launch gap
(smaller here than through the Python wrappers: both versions are called
through their C entry points, the same way). Each reading is the median
of 25 warm timings; the versions are timed in the order other, this,
this, other, and both readings are printed. The other version's C
signatures are read from its own ``kernels/build.py``, and its calls are
shaped by them (the versions before the non-finite flags of B1/B2 and the
strided B5 take fewer arguments).

Before timing, each version is checked against its plain PyTorch
version; B1's and B2's outputs of the two versions against each other
bit for bit (on finite operands they run the same ``fmaf`` chain per row
and the same distance order), B5's within the tolerance of
``chip_smoke.py`` (f32 sums in another order).

B1 and B2 run on step 1 of the first pubmed-like batch (full size, as in
``chip_smoke.py``); B4 on recurrentgemma-9b's ``local`` layer shape,
q (2, 4096, 16, 256) and k, v (2, 4096, 1, 256) bf16, window 2048; B5 on
rwkv6-3b's prefill shape, (B, T, H, hd) = (4, 2048, 40, 64) f32, each
version in the layout it reads (a version that takes (B*H, T, hd) gets
that copy, made outside the timing), and this version's B5 once more at
4 x 33 heads, one per SM. Operands of B4 and B5 are drawn from a seed.

    PYTHONPATH=src python -m repro_torch.kernels.ab --against DIR

Needs one CUDA card and ``nvcc``; the other version's library goes to
``build/ab/``.
"""
from __future__ import annotations

import argparse
import hashlib
import importlib.util
import subprocess
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import build

SOURCES = ("spmm_block_ell.cu", "nap_step_fused.cu", "flash_attention.cu",
           "wkv6.cu")
NAMES = ("spmm_block_ell_launch", "nap_step_fused_launch",
         "flash_attention_launch", "wkv6_launch")
REPS = 25


def other_signatures(root: Path) -> dict:
    """The C signatures of the checkout at `root` (its kernels/build.py,
    which imports only the standard library)."""
    path = root / "src" / "repro_torch" / "kernels" / "build.py"
    spec = importlib.util.spec_from_file_location("other_build", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.SIGNATURES


def other_library(root: Path) -> Path:
    """The kernels of SOURCES built from the checkout at `root` (cached by
    content)."""
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


def nap_operands(dev):
    """Tiles, tile_col, valid, active, x, c_inf and s_inf of step 1 of the
    first pubmed-like batch of 500 requests, as `chip_smoke.py` builds
    them."""
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
                 for a in (p.tiles, p.tile_col, p.valid, act, p.x0,
                           p.c_inf, p.s_inf))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--against", type=Path, required=True,
                    help="root of the other checkout")
    args = ap.parse_args()
    from repro_torch.kernels.flash_attention import ref_attention
    from repro_torch.kernels.nap_step import ref_nap_step
    from repro_torch.kernels.spmm import (RB, nonfinite_blocks,
                                          ref_spmm_block_ell, zero_flags)
    from repro_torch.kernels.wkv6 import ref_wkv6

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    sigs = {"other": other_signatures(args.against),
            "this": build.SIGNATURES}
    libs = {"other": build.bind(other_library(args.against), NAMES,
                                sigs["other"]),
            "this": build.library()}
    n_args = {tag: {n: len(sig[n]) for n in NAMES}
              for tag, sig in sigs.items()}
    print(f"C entry points' argument counts: {n_args}")
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    calls, outs = {}, {}

    # ---- B1 and B2 on the real step-1 operands
    tiles, tile_col, valid, act, x, c, s = nap_operands(dev)
    n_rb, tb = tile_col.shape
    n_x, F = x.shape
    nb = c.numel()
    ts2 = float(np.float32(20.0) ** 2)
    nact = torch.ones((nb, 1), dtype=torch.int32, device=dev)
    x_bad = nonfinite_blocks(x)
    b1_ref = ref_spmm_block_ell(tiles, tile_col, valid, act, x)
    b2_ref = ref_nap_step(tiles, tile_col, valid, act, x, c, s, nact, ts2)
    for tag, lib in libs.items():
        out = torch.empty((n_rb * RB, F), dtype=torch.float32, device=dev)
        exits = torch.empty((nb, 1), dtype=torch.int32, device=dev)
        blk = torch.empty((n_rb, 1), dtype=torch.int32, device=dev)
        ob = zero_flags(n_rb * RB, F, dev)
        flagged = n_args[tag]["spmm_block_ell_launch"] > 11
        p = lambda *ts: [t.data_ptr() for t in ts]  # noqa: E731

        def b1(lib=lib, out=out, ob=ob, flagged=flagged):
            a = (p(tiles, tile_col, valid, act, x_bad, x, out, ob)
                 + [n_rb, tb, F, n_x] if flagged else
                 p(tiles, tile_col, valid, act, x, out) + [n_rb, tb, F])
            build.check_launch("spmm_block_ell",
                               lib.spmm_block_ell_launch(*a, 0, stream))

        def b2(lib=lib, out=out, ob=ob, exits=exits, blk=blk,
               flagged=flagged):
            a = (p(tiles, tile_col, valid, act, x_bad, x, c, s, nact)
                 + [ts2] + p(out, ob, exits, blk) + [n_rb, tb, F, n_x, nb]
                 if flagged else
                 p(tiles, tile_col, valid, act, x, c, s, nact) + [ts2]
                 + p(out, exits, blk) + [n_rb, tb, F, nb])
            build.check_launch("nap_step_fused",
                               lib.nap_step_fused_launch(*a, 0, stream))
        b1()
        torch.cuda.synchronize()
        err = float((out - b1_ref).abs().max())
        print(f"B1 {tag}: max abs err vs plain {err:.3g}")
        if not torch.allclose(out, b1_ref, rtol=1e-5, atol=1e-5):
            raise RuntimeError(f"B1 {tag} disagrees with its plain version")
        outs[("B1", tag)] = out.clone()
        b2()
        torch.cuda.synchronize()
        err = float((out - b2_ref[0]).abs().max())
        print(f"B2 {tag}: max abs err vs plain {err:.3g}, exits "
              f"{int(exits.sum())} (plain {int(b2_ref[1].sum())})")
        if not torch.allclose(out, b2_ref[0], rtol=1e-5, atol=1e-5):
            raise RuntimeError(f"B2 {tag} disagrees with its plain version")
        outs[("B2", tag)] = (out.clone(), exits.clone(), blk.clone())
        calls[("B1", tag)], calls[("B2", tag)] = b1, b2
    same = torch.equal(outs[("B1", "this")], outs[("B1", "other")])
    print(f"B1 this == other bitwise: {same}")
    if not same:
        raise RuntimeError("B1: the two versions' outputs differ")
    same = all(torch.equal(a, b) for a, b in zip(outs[("B2", "this")],
                                                  outs[("B2", "other")]))
    print(f"B2 this == other bitwise (out, exit flags, block flags): {same}")
    if not same:
        raise RuntimeError("B2: the two versions' outputs differ")
    del b1_ref, b2_ref, outs

    # ---- B4 at recurrentgemma-9b's local-layer shape
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
    del b4_ref

    # ---- B5 at rwkv6-3b's prefill shape
    B, T, H, hd = 4, 2048, 40, 64
    r, k, v = (torch.randn((B, T, H, hd), generator=g, device=dev)
               for _ in range(3))
    lw = torch.clamp(-torch.exp(0.5 * torch.randn((B, T, H, hd), generator=g,
                                                  device=dev)), min=-5.0)
    u = 0.1 * torch.randn((H, hd), generator=g, device=dev)
    flat = [a.transpose(1, 2).reshape(B * H, T, hd).contiguous()
            for a in (r, k, v, lw)]
    uf = u[None].expand(B, H, hd).reshape(B * H, hd).contiguous()
    ref_out, ref_state = ref_wkv6(*flat, uf)
    scale = float(max(ref_out.abs().max(), ref_state.abs().max()))
    for tag, lib in libs.items():
        strided = n_args[tag]["wkv6_launch"] > 12
        ops = (r, k, v, lw, u) if strided else (*flat, uf)
        out = torch.empty_like(ops[0])
        state = torch.empty((B * H, hd, hd), device=dev)

        def b5(lib=lib, ops=ops, out=out, state=state, strided=strided):
            ptrs = [t.data_ptr() for t in (*ops, out, state)]
            a = (ptrs + [B, H, T, hd, T * H * hd, H * hd, hd, 0]
                 if strided else ptrs + [B * H, T, hd])
            build.check_launch("wkv6", lib.wkv6_launch(*a, 0, stream))
        b5()
        torch.cuda.synchronize()
        o = out.transpose(1, 2).reshape(B * H, T, hd) if strided else out
        err = float(max((o - ref_out).abs().max(),
                        (state - ref_state).abs().max()))
        print(f"B5 {tag} ({'(B, T, H, hd)' if strided else '(B*H, T, hd)'}"
              f" layout): max abs err vs plain {err:.3g} of values up to "
              f"{scale:.3g}")
        if not (torch.allclose(o, ref_out, rtol=1e-4, atol=1e-5 * scale)
                and torch.allclose(state, ref_state, rtol=1e-4,
                                   atol=1e-5 * scale)):
            raise RuntimeError(f"B5 {tag} disagrees with its plain version")
        calls[("B5", tag)] = b5
    del ref_out, ref_state

    # B5 with one head per SM (4 x 33 heads on 132 SMs): how much of the
    # time at 160 heads is the 28 SMs that hold two
    if n_args["this"]["wkv6_launch"] > 12:
        H1 = 33
        ops1 = [a[:, :, :H1].contiguous() for a in (r, k, v, lw)] + [u[:H1]]
        out1 = torch.empty_like(ops1[0])
        st1 = torch.empty((B * H1, hd, hd), device=dev)

        def b5_132():
            ptrs = [t.data_ptr() for t in (*ops1, out1, st1)]
            build.check_launch("wkv6", libs["this"].wkv6_launch(
                *ptrs, B, H1, T, hd, T * H1 * hd, H1 * hd, hd, 0, 0, stream))
        print(f"B5 this, {B * H1} heads (one per SM), 10 calls per event "
              f"pair: {time_ms(b5_132, 10):.4f} ms", flush=True)

    for kern in ("B1", "B2", "B4", "B5"):
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
