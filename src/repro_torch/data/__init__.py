"""Synthetic data of the port (`repro.data`)."""
from repro_torch.data.tokens import synthetic_lm_batch

__all__ = ["synthetic_lm_batch"]
