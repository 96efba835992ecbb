"""Device resolution shared by the port's entry points, and the profiler
range helper of the serving and sharding paths."""
from __future__ import annotations

import contextlib

import torch
import torch.autograd.profiler as _autograd_profiler


def resolve_device(device) -> torch.device:
    """`device` (str or torch.device) as a torch.device. A CUDA device
    without a usable GPU raises: entry points default to ``"cuda"`` and
    never drop to the CPU on their own — callers ask for the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            f"pass device='cpu' to run on the CPU")
    return dev


def profiled(name: str):
    """A `torch.profiler.record_function` range named `name` while a
    profiler records, so that it lands on the profiler's clock beside the
    device events; otherwise nothing (an unobserved range still costs
    ~10 us to enter and leave). Used by the serving engine's stage spans
    (`repro_torch.serving.engine._span` and its ``serve.host`` /
    ``serve.dispatch`` ranges, `repro_torch.gnn.backends.run_propagation`'s
    ``serve.heads``) and the placed collectives' ``exchange.*``
    ranges (`repro_torch.sharding.placement._exchange`)."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()
