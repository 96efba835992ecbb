"""Causal / banded / unmasked online-softmax attention with a key bound
(kernel B4)."""
BQ = 128           # sequence granularity of the wrapper (as the TPU kernel's)
BK = 128
# head dims the CUDA kernels are compiled for, by dtype: the f32 kernel
# also takes the smoke configs' 32 (all f32); no bf16 config has 32
HEAD_DIMS = {"float32": (32, 64, 128, 256), "bfloat16": (64, 128, 256)}
# head dims with an instance for a query offset > 0 (the rows of a
# context-parallel split: deepseek-coder-33b's 128 and whisper-small's 64
# in bf16, 64 and the smoke configs' 32 in f32), none with the soft-cap
OFFSET_HEAD_DIMS = {"float32": (32, 64), "bfloat16": (64, 128)}

from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    cost, flash_attention)
from repro_torch.kernels.flash_attention.ops import gqa_flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import ref_attention  # noqa: E402

__all__ = ["BQ", "BK", "HEAD_DIMS", "OFFSET_HEAD_DIMS", "cost", "flash_attention",
           "gqa_flash_attention", "ref_attention"]
