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
  named by the shortest host span that covers each;
* device time by program span: each device event's seconds under the
  innermost ``serve.*`` range (the program's own spans) that encloses,
  on the same thread, the CUDA call that launched it (the host event of
  the device event's own correlation id); the rest under
  ``"no program span"``.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Optional, Tuple

WINDOW_SPAN = "bench.window"
PROGRAM_SPAN = "serve."
NO_PROGRAM_SPAN = "no program span"
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
    span_device_s: Dict[str, float] = dataclasses.field(default_factory=dict)


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


class _Ranges:
    """The program's ``serve.*`` ranges of one host thread, sorted by start
    (a parent before a child that starts with it), each with the index of
    the range that encloses it."""

    def __init__(self, ranges):
        self.ranges = sorted(ranges, key=lambda e: (e.time_range.start,
                                                    -e.time_range.end))
        self.starts = [e.time_range.start for e in self.ranges]
        self.parent: List[int] = []
        open_: List[int] = []
        for i, e in enumerate(self.ranges):
            while open_ and (self.ranges[open_[-1]].time_range.end
                             < e.time_range.end):
                open_.pop()
            self.parent.append(open_[-1] if open_ else -1)
            open_.append(i)

    def innermost(self, lo: float, hi: float) -> Optional[str]:
        """The innermost range holding [lo, hi]: on the chain of ranges
        enclosing the last one to start at or before lo, since the ranges
        of one thread nest."""
        i = bisect.bisect_right(self.starts, lo) - 1
        while i >= 0 and self.ranges[i].time_range.end < hi:
            i = self.parent[i]
        return self.ranges[i].name if i >= 0 else None


def span_device_s(host, dev, clip) -> Dict[str, float]:
    """Seconds of each device event of `dev`, clipped to the window by
    `clip`, by the innermost ``serve.*`` range over its launch: the CUDA
    runtime or driver call (``cudaLaunchKernel``, ``cudaMemcpyAsync``,
    ``cuLaunchKernel``, ...) that shares the event's correlation id. The
    profiler gives that call the thread of the operator that made it."""
    by_thread: Dict[int, list] = {}
    for e in host:
        if e.name.startswith(PROGRAM_SPAN):
            by_thread.setdefault(e.thread, []).append(e)
    ranges = {t: _Ranges(rs) for t, rs in by_thread.items()}
    # operators' ids come from another counter than the calls': by name
    calls = {e.id: e for e in host if e.name.startswith("cu")}
    out: Dict[str, float] = {}
    for e in dev:
        call = calls.get(e.id)
        name = None
        if call is not None and call.thread in ranges:
            name = ranges[call.thread].innermost(call.time_range.start,
                                                 call.time_range.end)
        lo, hi = clip(e)
        key = name or NO_PROGRAM_SPAN
        out[key] = out.get(key, 0.0) + (hi - lo) / 1e6
    return out


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
                        device_ops=ops, idle_gaps=named,
                        span_device_s=span_device_s(host, dev, clip))

