"""Block-ELL SpMM (kernel B1). The packing geometry lives here: the
same RB x CB tiles and FB feature blocks as the JAX package
(`repro/kernels/spmm/kernel.py`), so one packed support drives both."""
RB = 8      # rows per adjacency tile
CB = 128    # cols per adjacency tile
FB = 128    # feature block
SLAB = 512  # features per CUDA block (one float4 column per thread)

from repro_torch.kernels.spmm.kernel import (  # noqa: E402
    nonfinite_blocks, spmm_block_ell, zero_flags)
from repro_torch.kernels.spmm.ref import ref_spmm_block_ell  # noqa: E402

__all__ = ["RB", "CB", "FB", "SLAB", "nonfinite_blocks", "zero_flags",
           "spmm_block_ell", "ref_spmm_block_ell"]
