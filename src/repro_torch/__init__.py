"""PyTorch + CUDA port of the NAI serving system (`repro`, JAX/Pallas).

The package mirrors `repro`'s subpackage layout (`gnn/`, `kernels/<name>/`,
`serving/`) so each module's counterpart is found by path. It imports
`torch` and `numpy` and nothing of the JAX package: numpy-only helpers it
needs are kept here as its own copies.

Entry points (`NAIServingEngine`, `make_compiled_infer`, `run_propagation`,
`init_classifiers`) run on ``device="cuda"`` unless the caller passes
another device, and raise when CUDA is missing; nothing falls back to the
CPU quietly. The hand-written Hopper kernels live in `csrc/` and are built
at first use (`repro_torch.kernels.build`).
"""
