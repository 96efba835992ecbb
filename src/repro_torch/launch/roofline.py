"""Roofline terms of a counted step on the H100 (`repro.launch.roofline`).

    compute term    = dot flops a position        / peak FLOP/s (bf16)
    memory term     = traffic bytes a position    / HBM rate
    collective term = collective bytes a position / NVLink rate, one way

The reference reads its counts from the compiled HLO
(`repro.launch.hlo_analysis`); the port counts them from the ops the step
dispatches on `meta` tensors (`launch.cost_analysis`), so `hlo_flops` and
its relatives keep their names but come from ops, not from HLO. The
terms are data-sheet estimates (`common.H100_SXM`), not measurements.

Not ported: `collective_bytes(hlo_text)`, which sums the collectives'
result shapes in HLO text; the port has no HLO, and
`cost_analysis.analyze` records the same per-device quantity from
`placement`'s collectives.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.common import H100_SXM


def roofline_terms(stats, *, chips: int, hw=H100_SXM) -> Dict[str, float]:
    """The reference's three-term roofline from `stats`
    (`cost_analysis.CostStats`, counts a position), under the reference's
    keys; `hlo_flops` is the sum over the `chips` positions, for
    comparison with `model_flops`, and
    `xla_cost_flops_per_chip_loopless` the flops of the fewest repeats
    counted (what a count blind to the layer loop gives)."""
    flops_dev = stats.dot_flops
    hbm_dev = stats.traffic_bytes
    coll_dev = stats.collective_total
    t_compute = flops_dev / hw.peak_flops
    t_memory = hbm_dev / hw.hbm_bw
    t_collective = coll_dev / hw.nvlink_bw
    dominant = max(
        [("compute", t_compute), ("memory", t_memory),
         ("collective", t_collective)], key=lambda kv: kv[1])[0]
    return {
        "hlo_flops": flops_dev * chips,
        "hlo_flops_per_chip": flops_dev,
        "hlo_bytes_per_chip": hbm_dev,
        "collective_bytes_per_chip": float(coll_dev),
        "collectives": {k: float(v) for k, v in stats.collective_bytes.items()},
        "xla_cost_flops_per_chip_loopless": float(stats.loopless_flops),
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_collective,
        "dominant": dominant,
    }


def model_flops(cfg, shape, n_params: int, n_active_params: int) -> float:
    """MODEL_FLOPS = 6·N·D (train) or 2·N·D (forward-only), N = active
    params, D = tokens processed this step."""
    if shape.mode == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active_params * tokens
    if shape.mode == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active_params * tokens
    tokens = shape.global_batch  # one token per sequence
    return 2.0 * n_active_params * tokens


def active_params(cfg, n_params: int) -> int:
    """Subtract the non-routed share of MoE expert weights."""
    if not cfg.num_experts:
        return n_params
    per_expert = cfg.d_model * cfg.d_ff * (3 if cfg.mlp_kind in
                                           ("swiglu", "geglu") else 2)
    moe_total = cfg.num_layers * cfg.num_experts * per_expert
    moe_active = cfg.num_layers * cfg.experts_per_token * per_expert
    return n_params - moe_total + moe_active
