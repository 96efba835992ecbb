"""Argument checks shared by the kernel wrappers.

A wrapper takes its kernel's plain PyTorch version only when every tensor
lies on the CPU; on CUDA tensors it launches the kernel or raises; on
`meta` tensors (the dry run) a wrapper that has a `cost` returns an empty
output of the kernel's shape and hands the cost over. Mixed
devices, wrong dtypes, shapes or strides raise `ValueError` before any
pointer reaches native code. A kernel without a backward refuses inputs
that require grad while grad mode is on (`refuse_grad`), on the CPU too,
so that a loss built on it cannot silently lose its gradient.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch


def kernel_device(meta: bool = False, **tensors: torch.Tensor
                  ) -> torch.device:
    """The one device all `tensors` live on; raises on a mix, and on
    `meta` unless `meta` (a wrapper with a `cost`)."""
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError("kernel operands on several devices: " + ", ".join(
            f"{k}={t.device}" for k, t in tensors.items()))
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda") + (("meta",) if meta else ()):
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


def refuse_grad(kernel: str, **tensors: torch.Tensor) -> None:
    """Raise when grad mode is on and any of `tensors` requires grad: the
    kernel (and its plain version, in its place on the CPU) is inference
    only, and detaching would drop the gradient without a word."""
    if torch.is_grad_enabled():
        need = [k for k, t in tensors.items() if t.requires_grad]
        if need:
            raise RuntimeError(
                f"{kernel} has no backward, and {', '.join(need)} "
                f"require(s) grad: train through the differentiable layer "
                f"path (apply_layer(differentiable=True)) or run under "
                f"torch.no_grad()")
