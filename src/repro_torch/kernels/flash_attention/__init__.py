"""Causal / banded online-softmax attention (kernel B4)."""
BQ = 128           # sequence granularity of the wrapper (as the TPU kernel's)
BK = 128
HEAD_DIMS = (64, 128, 256)   # head dims the CUDA kernel is compiled for

from repro_torch.kernels.flash_attention.kernel import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ops import gqa_flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import ref_attention  # noqa: E402

__all__ = ["BQ", "BK", "HEAD_DIMS", "flash_attention", "gqa_flash_attention",
           "ref_attention"]
