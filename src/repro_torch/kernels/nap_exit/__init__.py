"""NAP exit decision (kernel B3)."""
NB = 8      # nodes per block (= the SpMM's RB)
FB = 128    # feature block

from repro_torch.kernels.nap_exit.kernel import nap_exit  # noqa: E402
from repro_torch.kernels.nap_exit.ops import exit_decision  # noqa: E402
from repro_torch.kernels.nap_exit.ref import ref_nap_exit  # noqa: E402

__all__ = ["NB", "FB", "nap_exit", "exit_decision", "ref_nap_exit"]
