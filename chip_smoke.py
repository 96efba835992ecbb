#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path — `NAIServingEngine(mode="compiled")` over
the block-ELL kernels — at the full size of the repo's PubMed-shaped
configuration, and fails (non-zero exit, no result line) on any failed
check:

1. device: the card's name and power limit (nvidia-smi);
2. build: the CUDA kernels of `src/repro_torch/csrc/` into `build/`;
3. kernels: one real packed batch; each kernel (B1 spmm_block_ell, B2
   nap_step_fused, B3 nap_exit) against its plain PyTorch version on the
   card, B2's `out` bitwise against B1's and B2 against the two-launch
   composition B1 + B3; warm CUDA-event timings of kernel, plain version
   and library call (median of 25) beside the least time the card could
   take for the same work;
4. serve: 2,000 requests (4 batches) through the engine for each backend
   (fused, block_ell, segment) at pipeline depth 2, after one warm pass
   over the same requests, held against the port's host-mode engine on
   the same requests; the launch counters of the kernels are zeroed just
   before the measured passes and read just after.

Tolerances: propagated values allclose at rtol = atol = 1e-5 and squared
distances at rtol = 1e-5, atol = 1e-4 (f32 sums in another order than
the plain versions'); exit flags, exit orders and predictions equal
outside a 1e-4 relative margin around the squared threshold, which may
hold at most 5% of the nodes; B2 against B1 and against the two-launch
composition, and the fused backend against block_ell, exactly.

The second-to-last line is a JSON object {"kernels": [...]}, the last
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
PEAK_BYTES_S = 3.35e12        # H100 SXM HBM3, NVIDIA data sheet
PEAK_F32_FLOP_S = 67e12       # H100 SXM f32 outside the tensor cores
D2_MARGIN = 1e-4
MAX_NEAR_SHARE = 0.05
REPS = 25


def check(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def phase(name: str) -> None:
    print(f"\n== {name}", flush=True)


def time_ms(torch, fn, reps: int = REPS, warm: int = 3) -> float:
    """Median of `reps` CUDA-event timings of fn(), after `warm` calls."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_F32_FLOP_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO / "src"))
    from repro_torch.gnn import (GNNConfig, NAIConfig, init_classifiers,
                                 load_dataset, pack_support, sample_support,
                                 step_active_blocks)
    from repro_torch.gnn.nai import (decision_distances,
                                     support_stationary_factors)
    from repro_torch.gnn.packing import batch_bucket
    from repro_torch.gnn.store import as_store
    from repro_torch.kernels import build
    from repro_torch.kernels.nap_exit import nap_exit, ref_nap_exit
    from repro_torch.kernels.nap_step import (fused_step, nap_step_fused,
                                              ref_nap_step, two_launch_step)
    from repro_torch.kernels.spmm import (CB, RB, ref_spmm_block_ell,
                                          spmm_block_ell)
    from repro_torch.serving import NAIServingEngine
    kernels = {"spmm_block_ell": spmm_block_ell,
               "nap_step_fused": nap_step_fused, "nap_exit": nap_exit}

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

    # B1: block-ELL SpMM
    out = spmm_block_ell(tiles, tile_col, valid, active, x0)
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
                + n_rb * 4 + n_xblk * CB * F * 4 + n_rb * RB * F * 4)
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
    print(f"B1 active valid tiles {n_use}, non-zeros {nnz} "
          f"({nnz / max(n_use, 1):.2f} per 1,024-entry tile), x blocks "
          f"{n_xblk}")
    rows.append(dict(
        name="spmm_block_ell",
        source="src/repro_torch/csrc/spmm_block_ell.cu",
        replaces="src/repro/kernels/spmm/kernel.py:51",
        max_abs_err=err_b1,
        ms=time_ms(torch, lambda: spmm_block_ell(tiles, tile_col, valid,
                                                 active, x0)),
        plain_ms=time_ms(torch, lambda: ref_spmm_block_ell(
            tiles, tile_col, valid, active, x0)),
        library_ms=time_ms(torch, lambda: torch.sparse.mm(csr, x0)),
        bound=bound(b1_bytes, b1_flops)))
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
        ms=time_ms(torch, lambda: nap_exit(xb, x_inf, node_active, ts2)),
        plain_ms=time_ms(torch, lambda: ref_nap_exit(xb, x_inf,
                                                     node_active, ts2)),
        library_ms=time_ms(torch, lambda: ((xb - c[:, None] * s) ** 2
                                           ).sum(1)),
        bound=bound(b3_bytes, 3 * nb * F)))

    # B2: fused step
    f_args = (tiles, tile_col, valid, active, x0, c, s, node_active)
    f_out, f_ex, f_blk = nap_step_fused(*f_args, ts2)
    r_out, r_ex2, r_blk2 = ref_nap_step(*f_args, ts2)
    torch.cuda.synchronize()
    check(torch.equal(f_out, out), "nap_step_fused out bitwise == "
          "spmm_block_ell out")
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
        ms=time_ms(torch, lambda: nap_step_fused(*f_args, ts2)),
        plain_ms=time_ms(torch, lambda: ref_nap_step(*f_args, ts2)),
        library_ms=None,
        bound=bound(b2_bytes, b1_flops + 4 * nb * F)))
    del tiles, tile_col, valid, x0, x_inf, out, ref, f_out, r_out, one, two
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

    phase("kernel summary")
    n_batches = -(-len(requests) // nai.batch_size)
    for r in rows:
        lib = r["library_ms"]
        print(f"{r['name']}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, library "
              f"{'n/a' if lib is None else '%.4f ms' % lib}, bound "
              f"{r['bound'][0]:.4f} ms ({r['bound'][1]}), launches "
              f"{launches[r['name']]} over {n_batches} batches of the backend "
              f"that runs it ({launches[r['name']] / n_batches:g} per batch),"
              f" max abs err {r['max_abs_err']:.3g}")

    line = {"kernels": []}
    for r in rows:
        ms, by = r.pop("bound")
        line["kernels"].append(dict(
            name=r["name"], route="cuda", source=r["source"],
            replaces=r["replaces"], launches=launches[r["name"]],
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
