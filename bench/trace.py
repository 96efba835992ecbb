"""Reduction of a `torch.profiler` trace of the measured window.

Everything is taken between the start and the end of the harness's own
``bench.window`` span, so the profiler's own start and the reference
check after the window are outside it.

* device busy time: the union of the intervals of every event the
  profiler saw on the card (kernels, copies, memsets), and the idle
  share against the window;
* ``Memcpy HtoD`` device time (the operands' copies);
* the NAP loop's device time: on the stream that runs the kernels, a
  served batch is its loop's kernels, then the heads' kernels (from the
  first matrix product on), then its results' ``Memcpy DtoH``; the loop's
  time is the kernels before the heads;
* the device operations that took most time, and the longest idle gaps
  named by the shortest host span that covers each.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

WINDOW_SPAN = "bench.window"
MATMUL_OPS = ("aten::addmm", "aten::mm", "aten::bmm", "aten::matmul",
              "aten::linear", "aten::einsum", "aten::baddbmm")


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    htod_s: float
    loop_s: float
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]


def _is_device(e) -> bool:
    """A kernel, copy or memset on the card (not the device-side shadow
    of a host span, which covers the gaps between its kernels)."""
    from torch.autograd import DeviceType
    return (e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith("bench."))


def _is_head_start(e, op_of: Dict[int, str]) -> bool:
    name = e.name.lower()
    if "gemm" in name or "gemv" in name:
        return True
    return op_of.get(getattr(e, "linked_correlation_id", 0), "") in MATMUL_OPS


def summarize(prof, top: int = 10) -> Optional[TraceSummary]:
    events = list(prof.events())
    marks = [e for e in events if e.name == WINDOW_SPAN]
    if not marks:
        return None
    w0, w1 = marks[0].time_range.start, marks[0].time_range.end
    from torch.autograd import DeviceType
    host = [e for e in events if e.device_type != DeviceType.CUDA]
    op_of = {e.id: e.name for e in host}
    dev = sorted((e for e in events if _is_device(e)
                  and e.time_range.end > w0 and e.time_range.start < w1),
                 key=lambda e: e.time_range.start)
    if not dev:
        return TraceSummary((w1 - w0) / 1e6, 0.0, 0.0, 0.0, [], [])

    def clip(e):
        return max(e.time_range.start, w0), min(e.time_range.end, w1)

    busy, reach, gaps = 0.0, w0, []
    for e in dev:
        lo, hi = clip(e)
        if lo > reach:
            gaps.append((reach, lo))
        busy += max(0.0, hi - max(lo, reach))
        reach = max(reach, hi)
    if w1 > reach:
        gaps.append((reach, w1))

    by_name: Dict[str, float] = {}
    for e in dev:
        lo, hi = clip(e)
        by_name[e.name] = by_name.get(e.name, 0.0) + (hi - lo) / 1e6
    htod = sum(v for k, v in by_name.items() if "HtoD" in k)

    # the compute stream: the one whose kernels (not copies) take longest
    per_stream: Dict[int, float] = {}
    for e in dev:
        if "Memcpy" not in e.name and "Memset" not in e.name:
            per_stream[e.device_resource_id] = per_stream.get(
                e.device_resource_id, 0.0) + e.time_range.elapsed_us()
    loop_us = 0.0
    if per_stream:
        sid = max(per_stream, key=per_stream.get)
        in_heads, after_copy = False, True
        for e in dev:
            if e.device_resource_id != sid:
                continue
            lo, hi = clip(e)
            if "DtoH" in e.name:
                after_copy = True
                continue
            if after_copy:
                in_heads, after_copy = False, False
            in_heads = in_heads or _is_head_start(e, op_of)
            if not in_heads:
                loop_us += hi - lo

    spans = sorted(((e.time_range.end - e.time_range.start,
                     e.time_range.start, e.time_range.end, e.name)
                    for e in host if e.name != WINDOW_SPAN))
    named = []
    for lo, hi in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        mid = 0.5 * (lo + hi)
        label = next((n for _, a, b, n in spans if a <= mid <= b),
                     "no host span")
        named.append((label, (hi - lo) / 1e6))
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return TraceSummary(window_s=(w1 - w0) / 1e6, busy_s=busy / 1e6,
                        htod_s=htod, loop_s=loop_us / 1e6,
                        device_ops=ops, idle_gaps=named)

