"""Build the CUDA kernels in `csrc/` with nvcc at first use, load them with ctypes.

Each `csrc/<name>.cu` has a plain C interface (pointers, ints, the stream;
it returns `cudaGetLastError()`), so it builds in seconds without PyTorch's
headers. The shared library lands in `build/torch_kernels/` at the repo root
(listed in `.gitignore`), named by a hash of its source and flags: a process
builds each kernel once, and a changed source builds anew.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "build", "torch_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: dict[str, ctypes.CDLL] = {}
# Per kernel: nvcc's output (ptxas registers / shared memory / spills) and
# the seconds the build took, for chip_smoke.py to print.
BUILD_INFO: dict[str, dict] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                           "of local_search_quantization_torch cannot be built")
    return found


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load `csrc/<name>.cu`; raises if nvcc fails."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    src = os.path.join(_CSRC, name + ".cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    out = os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")
    info = {"seconds": 0.0, "log": "", "cached": True}
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        try:
            proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        info = {"seconds": time.perf_counter() - t0,
                "log": proc.stdout + proc.stderr, "cached": False}
    lib = ctypes.CDLL(out)
    lib.lsq_error_string.argtypes = [ctypes.c_int]
    lib.lsq_error_string.restype = ctypes.c_char_p
    BUILD_INFO[name] = info
    _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a C entry point of `lib`."""
    if err != 0:
        msg = lib.lsq_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
