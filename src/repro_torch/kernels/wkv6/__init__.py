"""RWKV6 WKV recurrence (kernel B5)."""
CHUNK = 16               # = repro_torch.nn.rwkv.CHUNK (f32-safe factorization)
HEAD_DIMS = (16, 32, 64)  # head dims the CUDA kernel is compiled for

from repro_torch.kernels.wkv6.kernel import wkv6  # noqa: E402
from repro_torch.kernels.wkv6.ops import wkv6_heads  # noqa: E402
from repro_torch.kernels.wkv6.ref import ref_wkv6  # noqa: E402

__all__ = ["CHUNK", "HEAD_DIMS", "wkv6", "wkv6_heads", "ref_wkv6"]
