"""What one served batch needs, counted from its inputs.

The operations and bytes of the NAP propagation steps, the exit
distances and the heads, for the support's real rows and edges, the same
count whatever backend runs the step. At step l only the rows within
t_max - l hops of the batch nodes still active before step l are needed
(their values feed an active node's later steps), each from all its
in-neighbours; a node is active before step l while its exit order is l
or more. Each needed edge is read once (its source index and
coefficient, 4 bytes each), each output row's CSR pointer once, each
source row of x once and each output row written once, in float32. The
distance at a decision step (t_min <= l < t_max) reads the rank-1
stationary factors and writes one exit flag per active node; the rows it
reads are the ones just written, counted there.

Heads: each node is classified once, by the head of its exit order, at
that head's real widths, as its head module (`bench/heads/`) counts.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from bench.reference.nai import EdgeGraph

F32 = 4
EDGE_BYTES = 8          # int32 source index + float32 coefficient
ROW_PTR_BYTES = 4


@dataclasses.dataclass
class StepNeed:
    edges: int
    rows_in: int
    rows_out: int
    active: int
    flops: float
    bytes: float


def step_needs(g: EdgeGraph, batch: np.ndarray, orders: np.ndarray, f: int,
               t_min: int, t_max: int) -> List[StepNeed]:
    """The needs of steps 1..t_max of one batch with these exit orders."""
    batch = np.asarray(batch, np.int64)
    orders = np.asarray(orders)
    out = []
    for l in range(1, t_max + 1):
        act = batch[orders >= l]
        rows = g.expand(g.mask(act), t_max - l)
        edges = int(g.indeg[rows].sum())
        rows_out = int(rows.sum())
        rows_in = int(g.expand(rows, 1).sum()) if rows_out else 0
        flops = 2.0 * edges * f
        nbytes = (edges * EDGE_BYTES + rows_out * ROW_PTR_BYTES
                  + rows_in * f * F32 + rows_out * f * F32)
        if t_min <= l < t_max:
            flops += 3.0 * len(act) * f
            nbytes += len(act) * F32 + f * F32 + len(act)
        out.append(StepNeed(edges=edges, rows_in=rows_in, rows_out=rows_out,
                            active=len(act), flops=flops, bytes=nbytes))
    return out


def head_flops(head, gcfg: dict, orders: np.ndarray) -> float:
    """2 x the multiply-adds of classifying each node by the head of its
    exit order, as the head module `head` counts them (`macs`)."""
    total = 0.0
    for l, n in zip(*np.unique(np.asarray(orders), return_counts=True)):
        total += 2.0 * int(n) * head.macs(gcfg, int(l))
    return total


def roofline_s(flops: float, nbytes: float, peak_flops: float,
               peak_bw: float) -> float:
    """The least time the work can take on a chip with these peaks."""
    return max(flops / peak_flops, nbytes / peak_bw)
