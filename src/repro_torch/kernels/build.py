"""Build and load the hand-written CUDA kernels (`repro_torch/csrc/`).

Each ``.cu`` source is compiled by its own ``nvcc`` process, all started
together, for ``sm_90a``; the objects are linked into ONE shared library
with a plain C interface, loaded with `ctypes`. Nothing here runs at
import time: the first kernel launch calls `library()`, which builds (or
reuses) ``build/kernels/librepro_torch_kernels-<digest>.so`` at the
repository root. The digest covers the sources and the flags, so an
edited source never loads a stale library, and the final rename is atomic,
so concurrent processes may build at once.

    python -m repro_torch.kernels.build      # build now, print nvcc -v output
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("spmm_block_ell.cu", "nap_step_fused.cu", "nap_exit.cu",
           "wkv6.cu", "flash_attention.cu")
HEADERS = ("block_ell.cuh", "hopper.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# C entry point -> argument types (every pointer and the stream as
# c_void_p, so 64-bit addresses are never cut to a 32-bit int)
SIGNATURES = {
    "spmm_block_ell_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                              _I, _P),
    "nap_step_fused_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _F, _P, _P,
                              _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "nap_exit_launch": (_P, _P, _P, _F, _P, _P, _P, _I, _I, _I, _P),
    "wkv6_launch": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _L,
                    _I, _I, _P),
    "flash_attention_launch": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                               _I, _F, _I, _I, _P),
}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, then ``nvcc`` on PATH,
    then ``/usr/local/cuda/bin/nvcc``."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from repro_torch/csrc")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"librepro_torch_kernels-{_digest()}.so"


def build_library() -> Path:
    """Compile every source in parallel and link the shared library, unless
    a library of the same digest exists."""
    out = library_path()
    if not out.exists():
        compile_library(CSRC, SOURCES, out)
    return out


def compile_library(csrc: Path, sources, out: Path) -> Path:
    """Compile `sources` of the directory `csrc`, one ``nvcc`` each, all
    started together, and link them into `out` (renamed into place at the
    end). The compiler's output (register and shared-memory use per
    kernel, from ``-Xptxas -v``) is kept beside it as ``<out>.log``."""
    nvcc = nvcc_path()
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        jobs = []
        for name in sources:
            obj = os.path.join(tmp, name + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(Path(csrc) / name), "-o", obj]
            jobs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for name, _, proc in jobs:
            text, _ = proc.communicate()
            logs.append(f"== {name}\n{text}")
            if proc.returncode != 0:
                failed.append(name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        lib = os.path.join(tmp, out.name)
        link = subprocess.run(
            [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
             *[obj for _, obj, _ in jobs], "-o", lib],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        Path(str(out) + ".log").write_text("\n".join(logs))
        os.replace(lib, out)
    return out


def bind(path: Path, names=tuple(SIGNATURES),
         signatures=None) -> ctypes.CDLL:
    """Load a kernel library with `argtypes` and `restype` set for the C
    entry points `names` (each must be there), from `signatures` (this
    version's SIGNATURES when None)."""
    signatures = SIGNATURES if signatures is None else signatures
    lib = ctypes.CDLL(str(path))
    for name in names:
        fn = getattr(lib, name)
        fn.argtypes = list(signatures[name])
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call), with `argtypes`
    and `restype` set for every C entry point."""
    return bind(build_library())


def check_launch(name: str, err: int) -> None:
    """Raise if a C entry point returned a CUDA error (a refused launch
    never runs, and a later synchronize would not report it)."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


if __name__ == "__main__":
    t0 = time.perf_counter()
    path = build_library()
    print(f"built {path} in {time.perf_counter() - t0:.1f}s")
    print(Path(str(path) + ".log").read_text())
