"""Build the CUDA kernels in `csrc/` with nvcc at first use, load them with ctypes.

Each `csrc/<name>.cu` has a plain C interface (pointers, ints, the stream;
it returns `cudaGetLastError()`), so it builds in seconds without PyTorch's
headers; the `*.cuh` files there are headers that the sources share. The shared library lands in `build/torch_kernels/` at the repo root
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
# -lineinfo maps SASS to source lines (for compute-sanitizer's reports); it
# changes no code.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-lineinfo", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: dict[str, ctypes.CDLL] = {}
# Per kernel: nvcc's output (ptxas registers / shared memory / spills) and
# the seconds the build took, for chip_smoke.py to print.
BUILD_INFO: dict[str, dict] = {}


def _cuda_home() -> str:
    return os.environ.get("CUDA_HOME") or "/usr/local/cuda"


def _nvcc() -> str:
    cand = os.path.join(_cuda_home(), "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                           "of local_search_quantization_torch cannot be built")
    return found


def sanitizer_paths() -> list[str]:
    """Where `sanitizer` looks for compute-sanitizer, in order: the CUDA
    toolkit's bin/, its compute-sanitizer/ directory, then PATH."""
    home = _cuda_home()
    return [os.path.join(home, "bin", "compute-sanitizer"),
            os.path.join(home, "compute-sanitizer", "compute-sanitizer"), "PATH"]


def sanitizer() -> str | None:
    """The compute-sanitizer of the CUDA toolkit, found as `_nvcc` finds
    nvcc (`sanitizer_paths`), or None."""
    for cand in sanitizer_paths()[:-1]:
        if os.path.exists(cand):
            return cand
    return shutil.which("compute-sanitizer")


# Every kernel source in csrc/, by name (l2_probe is the L2 gather probe, a
# measurement tool on no path).
KERNELS = ("ils_encode", "scan_topk", "icm_sweeps", "scan_select", "scan_key", "ivf_scan",
           "l2_probe")


def _paths(name: str) -> tuple[str, str]:
    """(source, library) of a kernel; the library name carries a hash of
    the source, of every header in csrc/ (a source may include any) and of
    the flags, so a changed header builds anew."""
    src = os.path.join(_CSRC, name + ".cu")
    headers = sorted(f for f in os.listdir(_CSRC) if f.endswith(".cuh"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [src] + [os.path.join(_CSRC, f) for f in headers]:
        with open(path, "rb") as f:
            digest.update(f.read())
    return src, os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")


def _open(name: str, out: str, info: dict) -> ctypes.CDLL:
    lib = ctypes.CDLL(out)
    lib.lsq_error_string.argtypes = [ctypes.c_int]
    lib.lsq_error_string.restype = ctypes.c_char_p
    BUILD_INFO[name] = info
    _LIBS[name] = lib
    return lib


def load_all(names=KERNELS) -> dict[str, ctypes.CDLL]:
    """Build every kernel in `names` that is not built yet, one nvcc process
    per source, all started together; then load them. Raises if any nvcc
    fails."""
    pending, errors = [], []
    try:
        for name in names:
            if name in _LIBS:
                continue
            src, out = _paths(name)
            if os.path.exists(out):
                _open(name, out, {"seconds": 0.0, "log": "", "cached": True})
                continue
            os.makedirs(BUILD_DIR, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            pending.append([name, src, out, tmp, None, time.perf_counter()])
            pending[-1][4] = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, src], stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)
        for name, src, out, tmp, proc, t0 in pending:
            stdout, stderr = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"nvcc failed on {src}:\n{stderr}")
                continue
            os.replace(tmp, out)
            _open(name, out, {"seconds": time.perf_counter() - t0,
                              "log": stdout + stderr, "cached": False})
    finally:
        for _, _, _, tmp, proc, _ in pending:
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.remove(tmp)
    if errors:
        raise RuntimeError("\n".join(errors))
    return {name: _LIBS[name] for name in names}


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load `csrc/<name>.cu`; raises if nvcc fails."""
    return load_all((name,))[name]


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a C entry point of `lib`."""
    if err != 0:
        msg = lib.lsq_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
