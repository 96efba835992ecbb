"""Hand-written Hopper kernels of the NAP serving path and the LM path.

* spmm      -- block-ELL sparse feature propagation with NAP row-block
               predication (`spmm_block_ell`)
* nap_exit  -- distance to the stationary state + exit decision
               (`nap_exit`)
* nap_step  -- the two fused in one kernel (`nap_step_fused`), plus the
               two-launch composition it must agree with
* wkv6      -- the RWKV6 WKV recurrence of the LM time-mix (`wkv6`)
* flash_attention -- causal / banded attention of the LM `local` and
               `attn` layers (`flash_attention`)

Each subpackage mirrors `repro.kernels.<name>`: `kernel.py` holds the
wrapper that launches the CUDA kernel from `repro_torch/csrc/` (built by
`repro_torch.kernels.build`) and counts its launches in
``<wrapper>.launches``, and `ref.py` the plain PyTorch version that the
wrapper uses for CPU tensors and that the kernel is held against on the
card.
"""
