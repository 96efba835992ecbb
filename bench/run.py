"""Entry point of the benchmark: one run of one cell.

    python3 -m bench.run --workload arxiv-sgc.seg500 --seed 7 --seconds 20 --trace 0

Run from the root of a checkout. The program under test is the PyTorch
port in `src/repro_torch`; its CUDA library is built into the checkout's
`build/kernels/` on the first run that needs it.
"""
import time

T_PROCESS = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# kernel caches at fixed paths inside the checkout
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from bench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], t_process=T_PROCESS))
