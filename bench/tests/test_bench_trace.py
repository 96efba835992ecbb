"""`bench/trace.py::summarize` on synthetic profiler events: device time
by the program span that launched it (`span_device_s`)."""
import dataclasses

import pytest
from torch.autograd import DeviceType
from torch.autograd.profiler_util import Interval

from bench import trace


@dataclasses.dataclass
class _Ev:
    name: str
    start: float
    end: float
    id: int = 0
    linked_correlation_id: int = 0
    thread: int = 1
    device: bool = False
    is_user_annotation: bool = False
    device_resource_id: int = 7

    @property
    def device_type(self):
        return DeviceType.CUDA if self.device else DeviceType.CPU

    @property
    def time_range(self):
        return Interval(self.start, self.end)


class _Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def _launch(op_id, call_id, name, t, kernel, k0, k1, thread=1):
    """An operator, its runtime call and the device event it launched."""
    return [_Ev(name, t, t + 4, id=op_id, thread=thread),
            _Ev("cudaLaunchKernel", t + 1, t + 2, id=call_id,
                linked_correlation_id=op_id, thread=thread),
            _Ev(kernel, k0, k1, id=call_id, linked_correlation_id=op_id,
                device=True)]


EVENTS = [
    _Ev("bench.window", 0, 1000, id=1, is_user_annotation=True),
    _Ev("serve.host", 10, 100, id=2, is_user_annotation=True),
    _Ev("serve.host.sample", 20, 50, id=3, is_user_annotation=True),
    _Ev("serve.dispatch", 110, 200, id=4, is_user_annotation=True),
    # the same name's shadow on the card, and a range on another thread
    # over the copy's launch below: neither is counted
    _Ev("serve.dispatch", 300, 340, id=5, device=True,
        is_user_annotation=True),
    _Ev("serve.host", 495, 520, id=6, thread=2, is_user_annotation=True),
    *_launch(101, 7, "aten::index", 25, "gather_kernel", 60, 70),
    # a memset, its call made straight from serve.host outside its sample
    _Ev("cudaMemsetAsync", 55, 58, id=10),
    _Ev("Memset (Device)", 700, 705, id=10, device=True),
    *_launch(102, 8, "aten::mm", 120, "gemm_kernel", 300, 340),
    *_launch(103, 9, "aten::copy_", 500, "Memcpy DtoH (Device -> Pinned)",
             600, 620),
    # launched in serve.dispatch, running past the window's end
    *_launch(105, 11, "aten::add", 150, "add_kernel", 990, 1010),
    # past the window: not counted
    *_launch(106, 12, "aten::add", 160, "add_kernel", 1100, 1200),
    # no call in the trace; an operator inside serve.dispatch whose id
    # (another counter's) is the kernel's correlation id is no launch
    _Ev("aten::zero_", 130, 135, id=99),
    _Ev("orphan_kernel", 900, 903, id=99, device=True),
]


def test_span_device_s_by_launching_span():
    s = trace.summarize(_Prof(EVENTS))
    want = {"serve.host.sample": 10e-6, "serve.dispatch": 50e-6,
            "serve.host": 5e-6, trace.NO_PROGRAM_SPAN: 23e-6}
    assert set(s.span_device_s) == set(want)
    for k, v in want.items():
        assert s.span_device_s[k] == pytest.approx(v, rel=1e-12), k
    assert sum(s.span_device_s.values()) == pytest.approx(
        sum(v for _, v in s.device_ops), rel=1e-12)
    assert s.busy_s == pytest.approx(88e-6, rel=1e-12)


def test_innermost_of_nested_and_sibling_ranges():
    r = trace._Ranges([_Ev("serve.a", 0, 100), _Ev("serve.b", 0, 40),
                       _Ev("serve.c", 10, 20), _Ev("serve.d", 50, 60)])
    assert [r.ranges[i].name for i in range(4)] == [
        "serve.a", "serve.b", "serve.c", "serve.d"]
    assert r.innermost(12, 13) == "serve.c"
    assert r.innermost(25, 30) == "serve.b"
    assert r.innermost(0, 5) == "serve.b"
    assert r.innermost(45, 48) == "serve.a"
    assert r.innermost(55, 58) == "serve.d"
    assert r.innermost(65, 70) == "serve.a"
    assert r.innermost(101, 102) is None
    assert trace._Ranges([]).innermost(1, 2) is None
