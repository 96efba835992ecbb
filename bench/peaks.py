"""Published peaks of the chips the benchmark runs on.

NVIDIA's H100 SXM data sheet, dense rates without sparsity, at the full
700 W power limit. The engine runs its float32 heads with TF32 off, so
the float32 rate outside the tensor cores is the one that bounds it.
"""
from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "f32_flops": 67e12,       # float32, CUDA cores
        "hbm_bytes_per_s": 3.35e12,
    },
}
DEFAULT = "NVIDIA H100 80GB HBM3"


def peaks(device_name: str) -> dict:
    """The row of `device_name`; an H100 SXM's for a name not listed (a
    CPU dry run), so that counts stay comparable."""
    return PEAKS.get(device_name, PEAKS[DEFAULT])
