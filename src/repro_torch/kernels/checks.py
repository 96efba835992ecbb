"""Argument checks shared by the kernel wrappers.

A wrapper takes its kernel's plain PyTorch version only when every tensor
lies on the CPU; on CUDA tensors it launches the kernel or raises. Mixed
devices, wrong dtypes, shapes or strides raise `ValueError` before any
pointer reaches native code.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch


def kernel_device(**tensors: torch.Tensor) -> torch.device:
    """The one device all `tensors` live on; raises on a mix."""
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError("kernel operands on several devices: " + ", ".join(
            f"{k}={t.device}" for k, t in tensors.items()))
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def check(name: str, t: torch.Tensor, dtype: torch.dtype,
          shape: Optional[Sequence[int]] = None, *,
          aligned: bool = False) -> None:
    """dtype, shape (None = any) and C-contiguity of one operand;
    `aligned` additionally requires a 16-byte aligned start (vector
    loads)."""
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if aligned and t.data_ptr() % 16:
        raise ValueError(f"{name}: data must start 16-byte aligned")


def stream_of(dev: torch.device) -> int:
    """Raw handle of PyTorch's current stream on `dev` (kernels launch
    there and never synchronise)."""
    return torch.cuda.current_stream(dev).cuda_stream
