"""Build the CUDA kernels in `csrc/` with nvcc at first use, load them with ctypes.

Each `csrc/<name>.cu` has a plain C interface (pointers, ints, the stream;
it returns `cudaGetLastError()`), so it builds in seconds without PyTorch's
headers; the `*.cuh` files there are headers that the sources share. The shared library lands in `build/torch_kernels/` at the repo root
(listed in `.gitignore`), named by a hash of its source and flags: a process
builds each kernel once, and a changed source builds anew. `load` returns it
with every C entry point's signature set (`ENTRIES`, the one place that
declares them) and each launch checked (`Library`).
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

_LIBS: dict[str, Library] = {}
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


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# Every C entry point of every kernel source in csrc/, by source: {entry:
# (argtypes, restype)}, bound once when the library opens. restype None marks
# an entry that launches and returns a cudaError_t: its bound call raises on
# a nonzero one (`Library`). l2_probe is the L2 gather probe, a measurement
# tool on no path.
ENTRIES = {
    "ils_encode": {
        "lsq_ils_smem_bytes": ([_I, _I], _I),
        "lsq_ils_max_h": ([], _I),
        "lsq_ils_encode": ([_P] * 9 + [_I] * 7 + [_P] * 6, None),
    },
    "scan_topk": {
        "lsq_scan_smem_bytes": ([_I, _I], _I),
        "lsq_k2_group": ([_I] * 3, _I),
        "lsq_k2_filter_smem_bytes": ([_I] * 4, _I),
        "lsq_k2_tile": ([], _I),
        "lsq_k2_select_max": ([], _I),
        "lsq_dense_tile": ([], _I),
        "lsq_dense_work_bytes": ([_I] * 3, _LL),
        "lsq_scan_topk": ([_P, _P, _I, _P] + [_I] * 6 + [_P] * 5, None),
        "lsq_k2_filter": ([_P, _P, _I, _P, _P] + [_I] * 7 + [_P] * 3, None),
        "lsq_k2_select": ([_P, _P, _I, _I, _I] + [_P] * 4, None),
    },
    "icm_sweeps": {
        "lsq_icm_smem_bytes": ([_I, _I], _I),
        "lsq_icm_max_h": ([], _I),
        "lsq_icm_sweeps_v2": ([_P] * 4 + [_I] * 4 + [_P] * 2, None),
        "lsq_icm_sweeps_v1": ([_P] * 4 + [_I] * 4 + [_P] * 2, None),
        "lsq_icm_sweeps_dissect": ([_I] + [_P] * 4 + [_I] * 4 + [_P] * 3, None),
    },
    "scan_select": {
        "lsq_select_rows_unit": ([], _I),
        "lsq_select_step": ([_I], _I),
        "lsq_select_cap_keys": ([_I] * 4, _I),
        "lsq_select_topk": ([_P, _P, _I, _P, _P] + [_I] * 10 + [_P] * 3, None),
    },
    "scan_key": {
        "lsq_key_step": ([_I] * 3, _I),
        "lsq_key_threads": ([_I], _I),
        "lsq_key_smem_bytes": ([_I] * 7, _I),
        "lsq_scan_key": ([_P, _P, _I, _P, _P] + [_I] * 12 + [_P] * 3, None),
    },
    "ivf_scan": {
        "lsq_ivf_lut_max_bytes": ([], _I),
        "lsq_ivf_scan": ([_P, _I, _I, _I, _P, _I, _P, _P, _P, _LL, _P, _P, _I, _I, _I]
                         + [_P] * 5, None),
    },
    "ivf_probes": {
        "lsq_ivf_probes_serves": ([_I] * 2, _I),
        "lsq_ivf_probes_work_words": ([_I] * 3, _LL),
        "lsq_ivf_probes": ([_P, _I, _I, _P, _P] + [_I] * 3 + [_P] * 3, None),
    },
    "l2_probe": {
        "lsq_l2_warps_per_block": ([], _I),
        "lsq_l2_rows_per_step": ([], _I),
        "lsq_l2_gather": ([_P] + [_I] * 6 + [ctypes.c_uint, _P, _P], None),
    },
}
KERNELS = tuple(ENTRIES)


class Library:
    """A built kernel source with its entry points (`ENTRIES`) bound as
    attributes. An entry that launches takes a keyword `what` and raises
    RuntimeError("{what}: CUDA error {err} ({message})") on a nonzero
    cudaError_t; the others return their value."""

    def __init__(self, name: str, cdll: ctypes.CDLL):
        cdll.lsq_error_string.argtypes = [_I]
        cdll.lsq_error_string.restype = ctypes.c_char_p
        for entry, (argtypes, restype) in ENTRIES[name].items():
            fn = getattr(cdll, entry)
            fn.argtypes = argtypes
            fn.restype = _I if restype is None else restype
            setattr(self, entry, fn if restype is not None else self._checked(cdll, fn))

    @staticmethod
    def _checked(cdll: ctypes.CDLL, fn):
        def call(*args, what: str) -> None:
            err = fn(*args)
            if err != 0:
                msg = cdll.lsq_error_string(err).decode()
                raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
        return call


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


def _open(name: str, out: str, info: dict) -> Library:
    lib = Library(name, ctypes.CDLL(out))
    BUILD_INFO[name] = info
    _LIBS[name] = lib
    return lib


def load_all(names=KERNELS) -> dict[str, Library]:
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


def load(name: str) -> Library:
    """Build (if needed) and load `csrc/<name>.cu`, its entry points bound;
    raises if nvcc fails."""
    return load_all((name,))[name]
