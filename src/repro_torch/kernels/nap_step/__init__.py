"""Fused NAP step (kernel B2) and the two-launch composition it fuses."""
from repro_torch.kernels.nap_step.kernel import nap_step_fused
from repro_torch.kernels.nap_step.ops import fused_step, two_launch_step
from repro_torch.kernels.nap_step.ref import ref_nap_step

__all__ = ["nap_step_fused", "fused_step", "two_launch_step",
           "ref_nap_step"]
