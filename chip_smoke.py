#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths through the entry points a user calls and
fails (non-zero exit, no result line) on any failed check:

1. device: the card's name and power limit (nvidia-smi);
2. build: the CUDA kernels of `src/repro_torch/csrc/` into `build/`;
3. NAI serving at the full size of the repo's PubMed-shaped
   configuration (`gnn_phases`): one real packed batch; each kernel (B1
   spmm_block_ell, B2 nap_step_fused, B3 nap_exit) against its plain
   PyTorch version on the card, B2's `out` bitwise against B1's and B2
   against the two-launch composition B1 + B3; B1 and B2 again with NaN,
   +Inf and -Inf planted in x rows that only zero coefficients name, and
   in rows that non-zero ones name (`nonfinite_phase`); then 2,000 requests
   through `NAIServingEngine(mode="compiled")` for each backend (fused,
   block_ell, segment) at pipeline depth 2, after one warm pass, held
   against the port's host-mode engine;
4. LM serving (`lm_phases`) at full width and depth in bf16 with random
   weights from `torch.Generator("cuda").manual_seed(0)`, with the
   rwkv mixes mu_* drawn from U(0, 1) and the attention projections
   scaled to a fan-in of d (`condition_weights`): rwkv6-3b (prefill 4 x
   2048 tokens, kernel B5 wkv6 in each of its 32 layers), then
   recurrentgemma-9b (prefill 2 x 4096 tokens, kernel B4 flash_attention
   in each of its 12 `local` layers, band 2048 active). For each: the
   kernel against its plain version on the first such layer's real
   operands, then the prefill, 32 greedy decode steps from its cache
   (with a profile of one decode step), 8 requests through
   `LMServingEngine` (4 slots, 32-token prompts, 16 new tokens each), and
   the end-to-end gates on prompts of 2048 (rwkv6-3b) and 2200
   (recurrentgemma-9b: above the window, not a multiple of it) tokens:
   the prefill's last logits, and one more token decoded from the
   prefill's cache, against decoding the same prompts token by token in
   f32 (a path with no kernel), for the f32 and for the bf16 prefill;
   with the bf16-against-f32 error of the last logits after 1, 2, 4, 8,
   16 and all layers.

The launch counters of the kernels are zeroed just before each main path
(the measured serving passes; each prefill and its decode) and read just
after it. Kernel timings: warm CUDA events around 10 back-to-back calls,
per call, median of 25, beside the least time the card could take for
the same work at the operands' type (B4's bf16 products on the tensor
cores), the plain version (which synchronises with the host: one call a
timing, and of B4/B5 the median of 5) and, where one PyTorch call
computes the same function, that call. The summary also gives the
kernel's and the library call's time at one call per event pair, which
adds the host's launch gap, and for B3 the device time alone: a CUDA
graph of 10 calls replayed between events (`graph_ms`).

Tolerances: propagated values allclose at rtol = atol = 1e-5 and squared
distances at rtol = 1e-5, atol = 1e-4 (f32 sums in another order than
the plain versions'); exit flags, exit orders and predictions equal
outside a 1e-4 relative margin around the squared threshold, which may
hold at most 5% of the nodes; B2 against B1 and against the two-launch
composition, and the fused backend against block_ell, exactly. With
non-finite x: NaN and +-Inf in exactly the places of the plain version's
output, the finite values as above. B5 at
rtol = 1e-4, atol = 1e-5 of its largest value (the same f32 chunked
factorization summed in another order); B4 at rtol = atol = 1e-2 (the
kernel rounds the softmax weights to bf16 for the tensor cores, 2^-9
relative each, and both round the output to bf16). End to end, relative L2 error against f32
token-by-token decoding: 1e-3 for the f32 paths (f32 sums in other
orders through every layer); for the bf16 paths 1.0 (rwkv6-3b) and 0.03
(recurrentgemma-9b), about twice the errors an H100 gave (bf16 keeps 8
significant bits, and random weights amplify its rounding with depth, as
the by-depth line shows: rwkv6-3b's error doubles with each doubling of
the depth, to 0.52 at 32 layers, where unrelated logits would give
1.41).

The second-to-last line is a JSON object {"kernels": [...]}, the last
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
PEAK_BYTES_S = 3.35e12        # H100 SXM HBM3, NVIDIA data sheet
PEAK_F32_FLOP_S = 67e12       # H100 SXM f32 outside the tensor cores
PEAK_BF16_FLOP_S = 989e12     # H100 SXM bf16 tensor cores, dense
D2_MARGIN = 1e-4
F32_REL = 1e-3
MAX_NEAR_SHARE = 0.05
REPS = 25


def check(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def phase(name: str) -> None:
    print(f"\n== {name}", flush=True)


def time_ms(torch, fn, reps: int = REPS, warm: int = 3,
            calls: int = 10) -> float:
    """Device time of one fn() call: median over `reps` CUDA-event
    timings of `calls` back-to-back calls (so the host's launch gap
    between calls stays off the card's timeline), after `warm` calls."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times))


def graph_ms(torch, fn, calls: int = 10, reps: int = REPS) -> float:
    """Device time of one fn() call with the host out of the way: a CUDA
    graph of `calls` back-to-back calls, replayed between CUDA events;
    median of `reps`, per call."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph
    return float(np.median(times))


def timings(torch, kernel, plain, library=None, plain_reps: int = REPS):
    """A kernel's, its plain version's and the library call's times.
    `ms` and `library_ms` time 10 back-to-back calls per event pair; their
    `_one_call` twins time one call per pair, which adds the host's launch
    gap, so that times taken either way can be compared. The plain
    versions synchronise with the host and are timed one call per pair."""
    t = dict(ms=time_ms(torch, kernel),
             ms_one_call=time_ms(torch, kernel, calls=1),
             plain_ms=time_ms(torch, plain, plain_reps, calls=1),
             library_ms=None, library_ms_one_call=None)
    if library is not None:
        t.update(library_ms=time_ms(torch, library),
                 library_ms_one_call=time_ms(torch, library, calls=1))
    return t


def bound(nbytes: float, flops: float, peak_flop_s: float = PEAK_F32_FLOP_S):
    """The least time for the work: bytes over the memory rate or
    operations over the peak rate of the operands' type, the larger."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / peak_flop_s
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def rel_l2(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def same_bits(torch, a, b) -> bool:
    """Bitwise equality of two f32 tensors, NaN payloads included."""
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def nonfinite_equal(torch, got, want, rtol=1e-5, atol=1e-5) -> bool:
    """NaN and +-Inf in exactly the same places (and signs), the finite
    values allclose (f32 sums in another order than the plain
    version's)."""
    fin = torch.isfinite(want)
    return (torch.equal(torch.isfinite(got), fin)
            and torch.equal(got.isnan(), want.isnan())
            and torch.equal(got[got.isinf()], want[want.isinf()])
            and torch.allclose(got[fin], want[fin], rtol=rtol, atol=atol))


def nonfinite_phase(torch, tiles, tile_col, valid, active, x0, c, s,
                    node_active, ts2) -> None:
    """B1 and B2 on the real step-1 operands with NaN, +Inf and -Inf
    planted in x rows that only zero coefficients of the active tiles name,
    then (separately) in rows that a non-zero coefficient names. Each
    output against its plain version: non-finite entries identical,
    finite ones allclose; B2's `out` and flags bitwise B1's; exit flags
    equal to the plain version's outside the threshold margin."""
    from repro_torch.kernels.nap_step import nap_step_fused, ref_nap_step
    from repro_torch.kernels.spmm import (CB, RB, nonfinite_blocks,
                                          ref_spmm_block_ell, spmm_block_ell,
                                          zero_flags)
    phase("non-finite x")
    use = (valid != 0) & (active[:, None] != 0)
    cols = tile_col[use].long()                       # (n_use,)
    nz = (tiles[use] != 0).any(dim=1)                 # (n_use, CB)
    named = torch.zeros(x0.shape[0], dtype=torch.bool, device=x0.device)
    named[(cols[:, None] * CB + torch.arange(CB, device=x0.device))[nz]] = 1
    reached = torch.zeros_like(named)
    reached.view(-1, CB)[cols.unique()] = True
    nb, F = node_active.shape[0], x0.shape[1]
    n_rb = tile_col.shape[0]
    for behind, pick in (("zero", reached & ~named), ("nonzero", named)):
        cand = torch.nonzero(pick).flatten()
        check(cand.numel() > 0, f"x rows behind {behind} coefficients")
        rows = cand[torch.linspace(0, cand.numel() - 1, min(3, cand.numel()),
                                   device=cand.device).long()]
        x = x0.clone()
        for i, (row, val) in enumerate(zip(rows.tolist(), (
                float("nan"), float("inf"), float("-inf")))):
            x[row, [i, F // 2 + i, F - 1 - i]] = val
        bad = nonfinite_blocks(x)
        ob1, ob2 = (zero_flags(n_rb * RB, F, x.device) for _ in range(2))
        o1 = spmm_block_ell(tiles, tile_col, valid, active, x, x_bad=bad,
                            out_bad=ob1)
        f_out, f_ex, f_blk = nap_step_fused(tiles, tile_col, valid, active,
                                            x, c, s, node_active, ts2,
                                            x_bad=bad, out_bad=ob2)
        r_out, r_ex, _ = ref_nap_step(tiles, tile_col, valid, active, x, c,
                                      s, node_active, ts2)
        r1 = ref_spmm_block_ell(tiles, tile_col, valid, active, x)
        torch.cuda.synchronize()
        n_nan, n_inf = int(r1.isnan().sum()), int(r1.isinf().sum())
        check(n_nan > 0, f"the planted values reach the output ({behind})")
        check(nonfinite_equal(torch, o1, r1),
              f"spmm_block_ell vs plain on non-finite x behind {behind} "
              f"coefficients")
        check(nonfinite_equal(torch, f_out, r_out),
              f"nap_step_fused vs plain on non-finite x behind {behind} "
              f"coefficients")
        check(same_bits(torch, f_out, o1) and torch.equal(ob1, ob2)
              and torch.equal(ob1, nonfinite_blocks(r1)),
              f"B2 out and flags bitwise B1's, flags as the plain output's "
              f"({behind})")
        d2 = ((r_out[:nb] - c[:, None] * s) ** 2).sum(1)
        far = ~((d2 - ts2).abs() <= D2_MARGIN * ts2)   # NaN counts as far
        check(torch.equal(f_ex.flatten()[far], r_ex.flatten()[far]),
              f"nap_step_fused exit flags vs plain ({behind})")
        print(f"behind {behind} coefficients: rows {rows.tolist()}; plain "
              f"output NaN {n_nan}, Inf {n_inf}; B1 NaN "
              f"{int(o1.isnan().sum())}, Inf {int(o1.isinf().sum())}; B2 "
              f"NaN {int(f_out.isnan().sum())}; batch nodes with a NaN "
              f"distance {int(d2.isnan().sum())}, exits {int(f_ex.sum())}")


def gnn_phases(torch, dev, kernels):
    """The NAI serving path (kernels B1-B3) at the full pubmed-like size:
    returns the kernel rows, each with its launches in the measured
    serving passes."""
    from repro_torch.gnn import (GNNConfig, NAIConfig, init_classifiers,
                                 load_dataset, pack_support, sample_support,
                                 step_active_blocks)
    from repro_torch.gnn.nai import (decision_distances,
                                     support_stationary_factors)
    from repro_torch.gnn.packing import batch_bucket
    from repro_torch.gnn.store import as_store
    from repro_torch.kernels.nap_exit import nap_exit, ref_nap_exit
    from repro_torch.kernels.nap_step import (fused_step, nap_step_fused,
                                              ref_nap_step, two_launch_step)
    from repro_torch.kernels.spmm import (CB, RB, nonfinite_blocks,
                                          ref_spmm_block_ell, spmm_block_ell,
                                          zero_flags)
    from repro_torch.serving import NAIServingEngine

    # ---------------------------------------------------- configuration
    g = load_dataset("pubmed-like", scale=1.0, seed=0)
    cfg = GNNConfig("sgc", g.features.shape[1], g.num_classes, k=4,
                    hidden=64, mlp_layers=2)
    nai = NAIConfig(t_s=20.0, t_min=1, t_max=3, batch_size=500)
    heads = init_classifiers(cfg, torch.Generator().manual_seed(0),
                             device=dev)
    requests = np.random.default_rng(0).choice(g.test_idx, size=2000,
                                               replace=False)
    print(f"graph {g.name}: n={g.n} edges={g.num_edges} f={cfg.feat_dim} "
          f"classes={cfg.num_classes}; {cfg}; {nai}")

    # ----------------------------------------------------------- kernels
    phase("kernels")
    store = as_store(g)
    batch = np.unique(requests[:nai.batch_size])   # the engine's batch 1
    sup = sample_support(store, batch, nai.t_max, cfg.r)
    x0_np = store.gather_features(sup.nodes).astype(np.float32)
    c64, s64 = support_stationary_factors(store, sup, x0_np, cfg.r)
    c_np, s_np = c64.astype(np.float32), s64.astype(np.float32)
    p = pack_support(sup, x0_np, c_np[:, None] * s_np[None, :],
                     nb_bucket=batch_bucket(sup.n_batch),
                     x_inf_factors=(c_np, s_np))
    sa = step_active_blocks(p.hop_rb, nai.t_max)
    nb, n_rb, tb = p.n_batch, p.n_rb, p.tiles.shape[1]
    F = p.x0.shape[1]
    print(f"support rows {len(sup)}, edges {len(sup.src)}, n_pad "
          f"{p.n_pad}, row blocks x tile slots {n_rb} x {tb}, valid tiles "
          f"{int(p.valid.sum())}, F_pad {F}, tiles {p.tiles.nbytes / 1e9:.3f}"
          f" GB, x0 {p.x0.nbytes / 1e6:.1f} MB, active row blocks per step "
          f"{[int(r.sum()) for r in sa]}")
    up = {"fused": ("tiles", "tile_col", "valid", "c_inf", "s_inf", "x0"),
          "block_ell": ("tiles", "tile_col", "valid", "x0", "x_inf"),
          "segment": ("src", "dst", "coef", "x0", "x_inf")}
    for impl, names in up.items():
        nbytes = sum(getattr(p, k).nbytes for k in names)
        if impl != "segment":
            nbytes += sa.nbytes
        print(f"host-to-device bytes per batch, {impl}: {nbytes}")

    def on_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    tiles, tile_col, valid = on_dev(p.tiles), on_dev(p.tile_col), \
        on_dev(p.valid)
    x0, x_inf = on_dev(p.x0), on_dev(p.x_inf)
    c, s = on_dev(p.c_inf), on_dev(p.s_inf)
    active = on_dev(sa[0])                          # step 1 of the loop
    node_active = torch.ones((nb, 1), dtype=torch.int32, device=dev)
    ts2 = float(np.float32(nai.t_s) ** 2)
    rows = []
    # the non-finite flags of x0, as the NAP loop makes them once per batch
    bad0 = nonfinite_blocks(x0)
    flags_ms = time_ms(torch, lambda: nonfinite_blocks(x0), calls=1)
    print(f"non-finite flags of x0 ({tuple(bad0.shape)}), once per batch: "
          f"{flags_ms:.4f} ms; set: {int(bad0.sum())}")
    ob = zero_flags(n_rb * RB, F, dev)

    # B1: block-ELL SpMM, called as the NAP loop calls it (flags in, out)
    out = spmm_block_ell(tiles, tile_col, valid, active, x0, x_bad=bad0,
                         out_bad=ob)
    ref = ref_spmm_block_ell(tiles, tile_col, valid, active, x0)
    torch.cuda.synchronize()
    err_b1 = float((out - ref).abs().max())
    check(torch.allclose(out, ref, rtol=1e-5, atol=1e-5),
          f"spmm_block_ell vs plain, max abs err {err_b1}")
    use = (valid != 0) & (active[:, None] != 0)
    n_use = int(use.sum())
    nnz = int((tiles[use] != 0).sum())
    n_xblk = int(torch.unique(tile_col[use]).numel())
    b1_bytes = (n_use * RB * CB * 4 + (int(active.sum()) * tb + n_use) * 4
                + n_rb * 4 + n_xblk * CB * F * 4 + n_rb * RB * F * 4
                + bad0.numel() + ob.numel())
    b1_flops = 2 * nnz * F
    # the library yardstick: one sparse product over the same active rows
    keep = np.repeat(sa[0] != 0, RB)[p.dst[:len(sup.src)]]
    e_dst = p.dst[:len(sup.src)][keep]
    e_src = p.src[:len(sup.src)][keep]
    csr = torch.sparse_coo_tensor(
        on_dev(np.stack([e_dst, e_src]).astype(np.int64)),
        on_dev(p.coef[:len(sup.src)][keep]), (n_rb * RB, p.n_pad)
    ).coalesce().to_sparse_csr()
    lib_out = torch.sparse.mm(csr, x0)
    torch.cuda.synchronize()
    check(torch.allclose(lib_out, out, rtol=1e-5, atol=1e-5),
          "torch.sparse.mm yardstick vs spmm_block_ell")
    rows.append(dict(
        name="spmm_block_ell",
        source="src/repro_torch/csrc/spmm_block_ell.cu",
        replaces="src/repro/kernels/spmm/kernel.py:51",
        max_abs_err=err_b1,
        **timings(torch,
                  lambda: spmm_block_ell(tiles, tile_col, valid, active, x0,
                                         x_bad=bad0, out_bad=ob),
                  lambda: ref_spmm_block_ell(tiles, tile_col, valid, active,
                                             x0),
                  lambda: torch.sparse.mm(csr, x0)),
        bound=bound(b1_bytes, b1_flops)))
    b1 = rows[-1]
    # counted here from the tiles: the kernel reports no count of its own
    print(f"B1 active valid tiles {n_use}, non-zeros in the active tiles "
          f"{nnz} ({nnz / max(n_use, 1):.2f} per 1,024-entry tile), x "
          f"blocks {n_xblk}; kernel {b1['ms']:.4f} ms = "
          f"{b1['bound'][0] / b1['ms']:.1%} of its bound, "
          f"{b1['ms'] / b1['library_ms']:.2f}x torch.sparse.mm")
    del csr, lib_out

    # B3: exit decision on the propagated batch rows
    xb = out[:nb]
    d2, ex, blk = nap_exit(xb, x_inf, node_active, ts2)
    r_d2, r_ex, r_blk = ref_nap_exit(xb, x_inf, node_active, ts2)
    torch.cuda.synchronize()
    err_b3 = float((d2 - r_d2).abs().max())
    check(torch.allclose(d2, r_d2, rtol=1e-5, atol=1e-4),
          f"nap_exit dist2 vs plain, max abs err {err_b3}")
    far = ((r_d2 - ts2).abs() > D2_MARGIN * ts2).flatten()
    check(float((~far).float().mean()) <= MAX_NEAR_SHARE,
          "share of nodes within the threshold margin")
    check(torch.equal(ex.flatten()[far], r_ex.flatten()[far]),
          "nap_exit flags vs plain outside the margin")
    if far.all():
        check(torch.equal(blk, r_blk), "nap_exit block flags vs plain")
    print(f"B3 exits at step 1: {int(ex[:sup.n_batch].sum())} of "
          f"{sup.n_batch}; nodes "
          f"within the margin {int((~far).sum())}")
    b3_bytes = 2 * nb * F * 4 + nb * 4 + nb * 8 + nb // RB * 4
    rows.append(dict(
        name="nap_exit", source="src/repro_torch/csrc/nap_exit.cu",
        replaces="src/repro/kernels/nap_exit/kernel.py:47",
        max_abs_err=err_b3,
        **timings(torch, lambda: nap_exit(xb, x_inf, node_active, ts2),
                  lambda: ref_nap_exit(xb, x_inf, node_active, ts2),
                  lambda: ((xb - c[:, None] * s) ** 2).sum(1)),
        bound=bound(b3_bytes, 3 * nb * F)))
    # device time alone (CUDA graph replay: no launch gaps), to tell the
    # kernel from the host's launch rate that both event rulers include
    b3 = rows[-1]
    b3["device_ms"] = graph_ms(
        torch, lambda: nap_exit(xb, x_inf, node_active, ts2))
    b3["library_device_ms"] = graph_ms(
        torch, lambda: ((xb - c[:, None] * s) ** 2).sum(1))
    print(f"B3 device time (CUDA graph of 10 calls): kernel "
          f"{b3['device_ms']:.4f} ms, library "
          f"{b3['library_device_ms']:.4f} ms; events around 10 calls: "
          f"{b3['ms']:.4f} / {b3['library_ms']:.4f} ms, one call: "
          f"{b3['ms_one_call']:.4f} / {b3['library_ms_one_call']:.4f} ms")

    # B2: fused step, called as the NAP loop calls it (flags in, out)
    f_args = (tiles, tile_col, valid, active, x0, c, s, node_active)
    f_ob = zero_flags(n_rb * RB, F, dev)
    f_out, f_ex, f_blk = nap_step_fused(*f_args, ts2, x_bad=bad0,
                                        out_bad=f_ob)
    r_out, r_ex2, r_blk2 = ref_nap_step(*f_args, ts2)
    torch.cuda.synchronize()
    check(torch.equal(f_out, out) and torch.equal(f_ob, ob),
          "nap_step_fused out and its flags bitwise == spmm_block_ell's")
    check(torch.equal(f_ex, ex) and torch.equal(f_blk[:nb // RB], blk),
          "nap_step_fused flags == spmm_block_ell + nap_exit flags")
    err_b2 = float((f_out - r_out).abs().max())
    check(torch.allclose(f_out, r_out, rtol=1e-5, atol=1e-5),
          f"nap_step_fused out vs plain, max abs err {err_b2}")
    check(torch.equal(f_ex.flatten()[far], r_ex2.flatten()[far]),
          "nap_step_fused flags vs plain outside the margin")
    two = two_launch_step(*f_args, nai.t_s)
    one = fused_step(*f_args, nai.t_s)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(one, two)),
          "fused_step == two_launch_step (all outputs)")
    b2_bytes = b1_bytes + nb * 4 + F * 4 + nb * 4 + nb * 4 + n_rb * 4
    rows.append(dict(
        name="nap_step_fused",
        source="src/repro_torch/csrc/nap_step_fused.cu",
        replaces="src/repro/kernels/nap_step/kernel.py:109",
        max_abs_err=err_b2,
        **timings(torch, lambda: nap_step_fused(*f_args, ts2, x_bad=bad0,
                                                out_bad=f_ob),
                  lambda: ref_nap_step(*f_args, ts2)),
        bound=bound(b2_bytes, b1_flops + 4 * nb * F)))
    b2 = rows[-1]
    print(f"B2 kernel {b2['ms']:.4f} ms = {b2['bound'][0] / b2['ms']:.1%} of "
          f"its bound, {b2['ms'] / b1['ms']:.2f}x B1")
    del out, ref, f_out, r_out, one, two
    nonfinite_phase(torch, tiles, tile_col, valid, active, x0, c, s,
                    node_active, ts2)
    del tiles, tile_col, valid, x0, x_inf
    torch.cuda.empty_cache()

    # ------------------------------------------------------------- serve
    phase("serve")

    def serve(eng, nodes):
        t = time.perf_counter()
        eng.submit(nodes)
        done = []
        while eng.queue:
            done += eng.step()
        done += eng.flush()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        check([r.node_id for r in done] == list(map(int, nodes)),
              "requests complete in FIFO order")
        check(all(r.status == "completed" for r in done),
              f"every request completed ({eng.stats.failed} failed: "
              f"{next((r.error for r in done if r.error), '')})")
        return (np.array([r.prediction for r in done]),
                np.array([r.exit_order for r in done]), wall)

    engines = {impl: NAIServingEngine(cfg, nai, heads, g, device=dev,
                                      mode="compiled", spmm_impl=impl,
                                      pipeline_depth=2, max_wait_s=10.0)
               for impl in ("fused", "block_ell", "segment")}
    warm_packs = {}
    for impl, eng in engines.items():
        # a first pass over the same requests sizes the bucket high-water
        # marks and allocates (and pins) the pack pool; the measured pass
        # below is the steady state
        serve(eng, requests)
        eng.reset_stats()
        warm_packs[impl] = dict(eng.pack_stats)
    host = NAIServingEngine(cfg, nai, heads, g, device=dev, mode="host",
                            max_wait_s=10.0)
    hp, ho, h_wall = serve(host, requests)
    print(f"host: {len(requests) / h_wall:.1f} req/s, exit histogram "
          f"{dict(sorted(host.stats.exit_hist.items()))}")
    check(set(ho) == {1, 2, 3}, "the host path exercises every order")

    for k in kernels.values():            # the main path starts here
        k.launches = 0
    results, per_backend = {}, {}
    for impl, eng in engines.items():
        before = {n: k.launches for n, k in kernels.items()}
        results[impl] = serve(eng, requests)
        per_backend[impl] = {n: k.launches - before[n]
                             for n, k in kernels.items()}
        summ = eng.stats.summary()
        t = list(eng.batch_timings)
        print(f"{impl}: {len(requests) / results[impl][2]:.1f} req/s, p50 "
              f"{summ['p50_ms']:.1f} ms, p99 {summ['p99_ms']:.1f} ms, exit "
              f"histogram {dict(sorted(eng.stats.exit_hist.items()))}, "
              f"launches {per_backend[impl]}, per batch host "
              f"{np.mean([b['host_s'] for b in t]) * 1e3:.1f} ms dispatch "
              f"{np.mean([b['dispatch_s'] for b in t]) * 1e3:.1f} ms sync "
              f"{np.mean([b['sync_s'] for b in t]) * 1e3:.1f} ms, pack "
              f"buffers allocated "
              f"{eng.pack_stats['allocs'] - warm_packs[impl]['allocs']} "
              f"reused {eng.pack_stats['reuses'] - warm_packs[impl]['reuses']}")
    launches = {n: k.launches for n, k in kernels.items()}

    # a separate traced pass per backend (after the counted ones): device
    # busy time = union of the intervals of the kernels and copies the
    # profiler saw on the card, against the pass's wall time
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for impl, eng in engines.items():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, _, wall = serve(eng, requests)
        spans = sorted((e.time_range.start, e.time_range.end, e.name)
                       for e in prof.events()
                       if e.device_type == DeviceType.CUDA)
        busy_us, reach, by_name = 0.0, -np.inf, {}
        for lo, hi, kname in spans:
            busy_us += max(0.0, hi - max(lo, reach))
            reach = max(reach, hi)
            by_name[kname] = by_name.get(kname, 0.0) + (hi - lo)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
        print(f"{impl} traced pass: {len(spans)} device events, busy "
              f"{busy_us / 1e3:.1f} ms of {1e3 * wall:.1f} ms wall (idle "
              f"share {1 - busy_us / 1e3 / (1e3 * wall):.3f}); most device "
              f"time: " + ", ".join(f"{k[:48]} {v / 1e3:.1f} ms"
                                    for k, v in top))

    near = np.zeros(len(requests), bool)
    for lo in range(0, len(requests), nai.batch_size):
        chunk = requests[lo:lo + nai.batch_size]
        uniq, inv = np.unique(chunk, return_inverse=True)
        d = decision_distances(cfg, nai, g, uniq)
        near[lo:lo + len(chunk)] = (np.abs(d ** 2 - ts2) <= D2_MARGIN * ts2
                                    ).any(axis=1)[inv]
    check(near.mean() <= MAX_NEAR_SHARE, f"{near.sum()} requests within "
          f"the threshold margin")
    for impl, (pr, od, _) in results.items():
        keep = ~near
        check(np.array_equal(od[keep], ho[keep])
              and np.array_equal(pr[keep], hp[keep]),
              f"{impl} matches the host path outside the margin")
    check(np.array_equal(results["fused"][0], results["block_ell"][0])
          and np.array_equal(results["fused"][1], results["block_ell"][1]),
          "fused and block_ell give identical predictions and exit orders")
    check(per_backend["block_ell"]["spmm_block_ell"] > 0
          and per_backend["block_ell"]["nap_exit"] > 0,
          "block_ell launched B1 and B3")
    check(per_backend["fused"]["nap_step_fused"] > 0, "fused launched B2")
    check(all(v == 0 for v in per_backend["segment"].values()),
          "segment launched no block-ELL kernel")
    print(f"requests within the threshold margin: {int(near.sum())}")
    n_batches = -(-len(requests) // nai.batch_size)
    for r in rows:
        r["launches"] = launches[r["name"]]
        r["note"] = (f"over {n_batches} batches of the backend that runs it "
                     f"({r['launches'] / n_batches:g} per batch)")
    return rows


def decode_profile(torch, step, arch, n=3):
    """Where one decode step's time goes: the profiler over `n` steps,
    host time per step against device busy time, and the ops that cost
    the host most."""
    from torch.profiler import ProfilerActivity, profile
    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ev = prof.key_averages()
    dev_us = sum(e.self_device_time_total for e in ev)
    n_launch = sum(e.count for e in ev if e.self_device_time_total > 0)
    top = sorted(ev, key=lambda e: -e.self_cpu_time_total)[:6]
    print(f"{arch} decode profile (traced, {n} steps): {wall / n * 1e3:.1f} "
          f"ms wall per step, device busy {dev_us / n / 1e3:.2f} ms per step,"
          f" ~{n_launch // n} device ops per step; most host time: "
          + ", ".join(f"{e.key} {e.self_cpu_time_total / n / 1e3:.2f} ms"
                      for e in top))


def band_pairs(S: int, window: int) -> int:
    """(query, key) pairs inside the causal band of `window` keys."""
    q = np.arange(S)
    return int(np.minimum(q + 1, window if window > 0 else S).sum())


def condition_weights(torch, cfg, model, generator) -> None:
    """Two changes to the reference's random initialization, so that the
    checks below can see what they test. It leaves the rwkv token-shift
    mixes mu_* at 0, under which the prefill cache's `x_t` is never read:
    draw them from U(0, 1). It takes the fan-in of the (d, heads, hd)
    attention projections from the heads axis, so random q.k logits run
    into the thousands and the banded softmax is a hard max whose winner
    rounding flips: scale wq, wk, wv to a fan-in of d (by a power of two
    at the two configs' widths, exact in bf16)."""
    with torch.no_grad():
        for p, kind in zip(model.layers, cfg.layer_kinds):
            for name, w in p.named_parameters():
                if name.rsplit(".", 1)[-1].startswith("mu_"):
                    w.uniform_(0.0, 1.0, generator=generator)
            if kind in ("local", "attn"):
                p["attn"]["wq"].mul_((cfg.num_heads / cfg.d_model) ** 0.5)
                for w in ("wk", "wv"):
                    p["attn"][w].mul_((cfg.num_kv_heads / cfg.d_model) ** 0.5)


def depth_logits(torch, cfg, model, toks, depths):
    """The last position's logits (final norm and head applied) after the
    first L layers, for each L in `depths`: where rounding grows."""
    from repro_torch.models import decoder_lm as M
    from repro_torch.nn import blocks as TB
    from repro_torch.nn.basic import apply_norm
    pos = torch.arange(toks.shape[1], device=toks.device)[None].expand(
        toks.shape)
    out = {}
    with torch.no_grad():
        x = M._embed_tokens(cfg, model, toks)
        for i, (p, kind) in enumerate(zip(model.layers, cfg.layer_kinds), 1):
            x, _ = TB.apply_layer(cfg, kind, p, x, positions=pos)
            if i in depths:
                h = apply_norm(cfg, model["final_norm"], x[:, -1:])
                out[i] = M._project_logits(cfg, model, h)[:, 0].float()
    return out


def lm_phases(torch, dev, kernels, arch, batch, seq, gate_seq, bf16_rel,
              smi_line):
    """The LM serving path of `arch` at full width and depth, bf16, random
    weights from a CUDA generator seeded 0 (conditioned as
    `condition_weights` says): kernel check and timing on the first such
    layer's real operands, prefill (the counted main path) + greedy decode,
    the engine, then the end-to-end gates on prompts of `gate_seq` tokens.
    Returns the row of the path's kernel."""
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import synthetic_lm_batch
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     ref_attention)
    from repro_torch.kernels.wkv6 import ref_wkv6, wkv6_heads
    from repro_torch.models import decoder_lm as M
    from repro_torch.nn import attention, rwkv
    from repro_torch.nn import blocks as TB
    from repro_torch.nn.basic import apply_norm
    from repro_torch.nn.params import count_params
    from repro_torch.serving import LMServingEngine

    phase(f"lm {arch}")
    cfg = get_config(arch)
    t0 = time.perf_counter()
    gen = torch.Generator(dev).manual_seed(0)
    model = M.init_params(cfg, gen, device=dev)
    condition_weights(torch, cfg, model, gen)
    torch.cuda.synchronize()
    n_par = count_params(model)
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    print(f"{arch}: {cfg.num_layers} layers {cfg.layer_kinds[:3]}..., "
          f"d_model {cfg.d_model}, {n_par} parameters, {n_bytes} bytes "
          f"({cfg.param_dtype}), made in {time.perf_counter() - t0:.1f}s")
    prompts = torch.from_numpy(synthetic_lm_batch(
        np.random.default_rng(0), batch, max(seq, gate_seq + 1),
        cfg.vocab_size)["tokens"]).long().to(dev)
    toks = prompts[:, :seq]
    pos = torch.arange(seq, device=dev)[None].expand(batch, seq)

    # ---- the kernel on the first layer's real operands, at the path's shape
    with torch.no_grad():
        x = M._embed_tokens(cfg, model, toks)
        if "rwkv" in cfg.layer_kinds:
            kname = "wkv6"
            p = model.layers[0]
            rf, kf, vf, lw, u, _ = rwkv.wkv_inputs(
                cfg, p["tmix"], apply_norm(cfg, p["norm1"], x))
            B_, T, H, hd = rf.shape
            # the kernel reads the model's (B, T, H, hd) layout as the
            # prefill hands it over; the plain version takes (B*H, T, hd)
            flat = [a.transpose(1, 2).reshape(B_ * H, T, hd).contiguous()
                    for a in (rf, kf, vf, lw)]
            uf = u[None].expand(B_, H, hd).reshape(B_ * H, hd).contiguous()
            args = (*flat, uf)
            out, state = wkv6_heads(rf, kf, vf, lw, u)
            ref_out, ref_state = ref_wkv6(*args)
            torch.cuda.synchronize()
            ref_out = ref_out.reshape(B_, H, T, hd).transpose(1, 2)
            ref_state = ref_state.reshape(B_, H, hd, hd)
            err = float(max((out - ref_out).abs().max(),
                            (state - ref_state).abs().max()))
            scale = float(max(ref_out.abs().max(), ref_state.abs().max()))
            # tolerance: 1e-5 of the largest value (f32 chunked
            # factorization, another summation order)
            check(torch.allclose(out, ref_out, rtol=1e-4, atol=1e-5 * scale)
                  and torch.allclose(state, ref_state, rtol=1e-4,
                                     atol=1e-5 * scale),
                  f"wkv6 vs plain, max abs err {err} (values up to {scale})")
            n_el = B_ * H * T * hd
            C = 16
            flops = (B_ * H * (T // C)
                     * (4 * C * C * hd + 4 * C * hd * hd + 10 * C * hd))
            nbytes = 5 * n_el * 4 + B_ * H * hd * 4 + B_ * H * hd * hd * 4
            print(f"wkv6 operands: BH {B_ * H}, T {T}, hd {hd}; max abs err "
                  f"{err:.3g} of values up to {scale:.3g}")
            row = dict(name=kname, source="src/repro_torch/csrc/wkv6.cu",
                       replaces="src/repro/kernels/wkv6/kernel.py:60",
                       max_abs_err=err,
                       **timings(torch,
                                 lambda: wkv6_heads(rf, kf, vf, lw, u),
                                 lambda: ref_wkv6(*args), plain_reps=5),
                       bound=bound(nbytes, flops))
            del args, flat, rf, kf, vf, lw, out, ref_out
        else:
            kname = "flash_attention"
            i_loc = cfg.layer_kinds.index("local")
            for i in range(i_loc):
                x, _ = TB.apply_layer(cfg, cfg.layer_kinds[i],
                                      model.layers[i], x, positions=pos)
            p = model.layers[i_loc]
            q, k, v = (a.contiguous() for a in attention._project_qkv(
                cfg, p["attn"], apply_norm(cfg, p["norm1"], x), pos))
            W = cfg.sliding_window
            out = flash_attention(q, k, v, window=W)
            ref = ref_attention(q, k, v, window=W)
            torch.cuda.synchronize()
            err = float((out.float() - ref.float()).abs().max())
            # tolerance: the kernel rounds P to bf16 for the tensor cores
            # (2^-9 relative), and both round the output to bf16 (2^-8)
            check(torch.allclose(out.float(), ref.float(), rtol=1e-2,
                                 atol=1e-2),
                  f"flash_attention vs plain, max abs err {err}")
            B_, S_, H, hd = q.shape
            KV = k.shape[2]
            flops = 4 * B_ * H * band_pairs(S_, W) * hd
            nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
            # q.k and p.v at the operands' type: bf16 on the tensor cores
            peak = (PEAK_BF16_FLOP_S if q.dtype == torch.bfloat16
                    else PEAK_F32_FLOP_S)
            band = torch.ones((S_, S_), dtype=torch.bool, device=dev).tril()
            band &= ~torch.ones_like(band).tril(-W)
            qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))

            def library():
                return torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=band, enable_gqa=True)
            lib_err = float((library().transpose(1, 2).float()
                             - ref.float()).abs().max())
            # how soft the softmax is on these operands: the mean largest
            # probability of a query's row (1 for a hard max)
            lg = (q[0, :, 0].float() @ k[0, :, 0].float().T) / hd ** 0.5
            lg.masked_fill_(~band, float("-inf"))
            p_max = float(lg.softmax(-1).max(-1).values.mean())
            del lg
            print(f"flash_attention operands: B {B_}, S {S_}, {H} q heads, "
                  f"{KV} kv heads, hd {hd}, window {W}, {q.dtype}; band "
                  f"pairs per head {band_pairs(S_, W)}; mean largest "
                  f"probability per row (batch 0, head 0) {p_max:.3f}; max abs err {err:.3g} of values up to "
                  f"{float(ref.float().abs().max()):.3g}; library call's "
                  f"max abs err {lib_err:.3g}")
            row = dict(name=kname,
                       source="src/repro_torch/csrc/flash_attention.cu",
                       replaces="src/repro/kernels/flash_attention/"
                                "kernel.py:77",
                       max_abs_err=err,
                       **timings(torch,
                                 lambda: flash_attention(q, k, v, window=W),
                                 lambda: ref_attention(q, k, v, window=W),
                                 library, plain_reps=5),
                       bound=bound(nbytes, flops, peak))
            print(f"flash_attention kernel {row['ms']:.4f} ms: "
                  f"{flops / row['ms'] / 1e9:.1f} TFLOP/s, "
                  f"{row['bound'][0] / row['ms']:.1%} of its bound; library "
                  f"call {row['library_ms']:.4f} ms "
                  f"({flops / row['library_ms'] / 1e9:.1f} TFLOP/s)")
            del q, k, v, out, ref, band, qt, kt, vt
        del x
    torch.cuda.empty_cache()

    # ---- the main path: prefill, then greedy decode from its cache
    n_kind = sum(kind in ("rwkv", "local") for kind in cfg.layer_kinds)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    last, cache = M.prefill_step(cfg, model, toks)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    tok = last.argmax(-1, keepdim=True)
    n_dec = 32
    t0 = time.perf_counter()
    for t in range(seq, seq + n_dec):
        logits, cache = M.decode_step(cfg, model, cache, tok, t)
        tok = logits[:, 0].argmax(-1, keepdim=True)
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    launches = {n: k.launches for n, k in kernels.items()}
    row["launches"] = launches[kname]
    row["note"] = f"in one {arch} prefill of {batch} x {seq} tokens"
    peak = torch.cuda.max_memory_allocated()
    check(launches[kname] == n_kind and all(
        v == 0 for n, v in launches.items() if n != kname),
        f"{arch} prefill launched {kname} once per layer ({launches})")
    check(bool(torch.isfinite(last).all()) and last.shape == (
        batch, cfg.vocab_size), f"{arch} prefill logits finite, shaped")
    rates = dict(prefill=batch * seq / t_prefill,
                 decode=batch * n_dec / t_decode)
    print(f"{arch} prefill {batch} x {seq}: {t_prefill:.3f} s, "
          f"{rates['prefill']:.1f} tokens/s; {kname} launches "
          f"{launches[kname]} (band active: "
          f"{0 < cfg.sliding_window < seq})")
    print(f"{arch} decode {n_dec} tokens x {batch}: {t_decode:.3f} s, "
          f"{rates['decode']:.1f} tokens/s ({1e3 * t_decode / n_dec:.2f} "
          f"ms per step); peak memory {peak} bytes")
    decode_profile(torch, lambda: M.decode_step(cfg, model, cache, tok,
                                                seq + n_dec), arch)
    del cache, logits
    torch.cuda.empty_cache()

    # ---- the engine: 8 requests, 4 slots, 32-token prompts, 16 new tokens
    eng = LMServingEngine(cfg, model, slots=4, max_len=128, device=dev)
    reqs = synthetic_lm_batch(np.random.default_rng(1), 8, 32,
                              cfg.vocab_size)["tokens"]
    for prompt in reqs:
        eng.submit(prompt.tolist(), max_new=16)
    t0 = time.perf_counter()
    stats = eng.run_until_drained()
    torch.cuda.synchronize()
    t_eng = time.perf_counter() - t0
    check(stats["completed"] == 8 and all(len(r.out) == 16
                                          for r in eng.completed),
          f"{arch} engine served every request in full ({stats})")
    rates["engine"] = 8 * 16 / t_eng
    print(f"{arch} engine: 8 requests in {stats['ticks']} ticks, "
          f"{t_eng:.3f} s, {rates['engine']:.1f} generated tokens/s, "
          f"{stats['ticks'] / t_eng:.1f} ticks/s")
    print(f"{arch} rates: prefill {rates['prefill']:.1f} tokens/s, decode "
          f"{rates['decode']:.1f} tokens/s, engine {rates['engine']:.1f} "
          f"tokens/s, peak memory {peak / 1e9:.2f} GB; {smi_line}")
    del eng
    torch.cuda.empty_cache()

    # ---- end to end, on prompts of gate_seq tokens (above the window and
    # not a multiple of it where there is one): prefill's last logits
    # against decoding the same prompts token by token (a path with no
    # kernel) in f32 on the same weights, then one more token decoded from
    # each path's cache. The bf16 path (prefill, and decode from its
    # cache) is held against the same f32 token-by-token logits; how its
    # rounding grows with depth is printed beside it.
    gtoks, nxt = prompts[:, :gate_seq], prompts[:, gate_seq:gate_seq + 1]
    depths = [L for L in (1, 2, 4, 8, 16) if L < cfg.num_layers] + [
        cfg.num_layers]
    t0 = time.perf_counter()
    d16 = depth_logits(torch, cfg, model, gtoks, depths)
    last16, cache = M.prefill_step(cfg, model, gtoks)
    next16 = M.decode_step(cfg, model, cache, nxt, gate_seq)[0][:, 0]
    del cache
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    model.float()
    d32 = depth_logits(torch, cfg32, model, gtoks, depths)
    last32, cache = M.prefill_step(cfg32, model, gtoks)
    next32 = M.decode_step(cfg32, model, cache, nxt, gate_seq)[0][:, 0]
    del cache
    cache = M.init_cache(cfg32, batch, gate_seq + 1, device=dev)
    for t in range(gate_seq + 1):
        step_logits, cache = M.decode_step(cfg32, model, cache,
                                           prompts[:, t:t + 1], t)
        if t == gate_seq - 1:
            ref_last = step_logits[:, 0]
    ref_next = step_logits[:, 0]
    torch.cuda.synchronize()
    errs = {"f32 prefill": rel_l2(last32, ref_last),
            "f32 decode from the prefill cache": rel_l2(next32, ref_next),
            "bf16 prefill": rel_l2(last16, ref_last),
            "bf16 decode from the prefill cache": rel_l2(next16, ref_next)}
    print(f"{arch} end to end on {batch} x {gate_seq} tokens + 1 "
          f"({time.perf_counter() - t0:.1f} s), relative L2 error against "
          f"f32 token-by-token: " + ", ".join(
              f"{k} {v:.4g}" for k, v in errs.items())
          + f"; argmax agreement, bf16 prefill "
          f"{float((last16.argmax(-1) == ref_last.argmax(-1)).float().mean()):.2f}"
          f", f32 prefill "
          f"{float((last32.argmax(-1) == ref_last.argmax(-1)).float().mean()):.2f}")
    print(f"{arch} bf16 against f32 prefill by depth (relative L2 error of "
          f"the last logits after L layers): " + ", ".join(
              f"L={L} {rel_l2(d16[L], d32[L]):.4g}" for L in depths))
    for what, err in errs.items():
        tol = F32_REL if what.startswith("f32") else bf16_rel
        check(err < tol, f"{arch} {what} vs token-by-token, relative L2 "
              f"error {err} (limit {tol})")
    del cache, step_logits, model, d16, d32
    torch.cuda.empty_cache()
    return row


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.nap_exit import nap_exit
    from repro_torch.kernels.nap_step import nap_step_fused
    from repro_torch.kernels.spmm import spmm_block_ell
    from repro_torch.kernels.wkv6 import wkv6
    kernels = {"spmm_block_ell": spmm_block_ell,
               "nap_step_fused": nap_step_fused, "nap_exit": nap_exit,
               "wkv6": wkv6, "flash_attention": flash_attention}

    # ------------------------------------------------------------ device
    phase("device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    smi_line = smi.splitlines()[0]
    print(smi_line)
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{name} count {torch.cuda.device_count()}")

    # ------------------------------------------------------------- build
    phase("build")
    t0 = time.perf_counter()
    lib_path = build.build_library()
    build.library()
    print(f"built {lib_path.name} in "
          f"{time.perf_counter() - t0:.1f}s")
    for line in Path(str(lib_path) + ".log").read_text().splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print("  " + line.strip())

    rows = gnn_phases(torch, dev, kernels)
    torch.cuda.empty_cache()
    # bf16 limits: about twice the error measured on an H100 (0.523 and
    # 0.0114), rwkv6-3b's kept below the 1.41 of unrelated logits
    rows.append(lm_phases(torch, dev, kernels, "rwkv6-3b", 4, 2048, 2048,
                          1.0, smi_line))
    rows.append(lm_phases(torch, dev, kernels, "recurrentgemma-9b", 2, 4096,
                          2200, 0.03, smi_line))

    phase("kernel summary")
    line = {"kernels": []}
    for r in rows:
        ms, by = r["bound"]
        lib = r["library_ms"]
        print(f"{r['name']}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, library "
              f"{'n/a' if lib is None else '%.4f ms' % lib}, bound "
              f"{ms:.4f} ms ({by}; kernel at {ms / r['ms']:.1%} of it), "
              f"launches {r['launches']} {r['note']}, "
              f"max abs err {r['max_abs_err']:.3g}; one call per event "
              f"pair: kernel {r['ms_one_call']:.4f} ms, library "
              f"{'n/a' if lib is None else '%.4f ms' % r['library_ms_one_call']}"
              + ("" if "device_ms" not in r else
                 f"; device time (CUDA graph): kernel {r['device_ms']:.4f} "
                 f"ms, library {r['library_device_ms']:.4f} ms"))
        line["kernels"].append(dict(
            name=r["name"], route="cuda", source=r["source"],
            replaces=r["replaces"], launches=r["launches"],
            max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=ms, bound_by=by,
            library_ms=r["library_ms"]))
    print(smi_line)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
