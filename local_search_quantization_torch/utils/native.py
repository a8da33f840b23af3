"""ctypes binding to the native host scanner (native/liblsqnative.so).

The port's copy of `local_search_quantization_tpu.utils.native` (which cannot
be imported without JAX): the same library, built by `make -C native`, found
at `native/liblsqnative.so` or at $LSQ_TPU_NATIVE_LIB. `available()` is False
when it is not built, and callers take another route. Takes and returns
numpy arrays. The IVF scanner and the vecs reader are bound with the IVF
slice (ROADMAP.md).
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB = None
_TRIED = False


def _lib_path() -> str:
    return os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        "native", "liblsqnative.so")


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = os.environ.get("LSQ_TPU_NATIVE_LIB", _lib_path())
    if not os.path.exists(path):
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    lib.lsq_linscan.restype = ctypes.c_int
    lib.lsq_linscan.argtypes = [
        ctypes.POINTER(ctypes.c_float),  # dists out [nq, k]
        ctypes.POINTER(ctypes.c_int64),  # ids out [nq, k]
        ctypes.POINTER(ctypes.c_uint8),  # codes [n, m]
        ctypes.POINTER(ctypes.c_float),  # luts [nq, m, h]
        ctypes.c_void_p,  # extra [n] (nullable)
        ctypes.c_int64,  # n
        ctypes.c_int64,  # nq
        ctypes.c_int,  # m
        ctypes.c_int,  # h
        ctypes.c_int,  # k
    ]
    if hasattr(lib, "lsq_linscan_fast"):
        lib.lsq_linscan_fast.restype = ctypes.c_int
        lib.lsq_linscan_fast.argtypes = lib.lsq_linscan.argtypes
    _LIB = lib
    return _LIB


def available() -> bool:
    return _load() is not None


def linscan(luts: np.ndarray, codes: np.ndarray, extra: np.ndarray | None,
            k: int, method: str = "auto"):
    """Native ADC scan: luts [nq, m, h] f32, codes [n, m] uint8, extra [n]
    f32 or None. method "auto" takes the AVX-512 VBMI scanner
    (lsq_linscan_fast) where the build has it, else the scalar one; "fast"
    and "heap" force one. Both return the same results.

    Returns (dists [nq, k] f32 ascending, ids [nq, k] int64), k = min(k, n).
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native library not built; run `make -C native`")
    if method not in ("auto", "fast", "heap"):
        raise ValueError(f"unknown method {method!r}")
    luts = np.ascontiguousarray(luts, np.float32)
    codes = np.ascontiguousarray(codes, np.uint8)
    nq, m, h = luts.shape
    n = codes.shape[0]
    if codes.shape[1] != m:
        raise ValueError(f"codes are [n, {codes.shape[1]}], LUTs have m={m}")
    k = min(k, n)
    dists = np.empty((nq, k), np.float32)
    ids = np.empty((nq, k), np.int64)
    extra_arr = None if extra is None else np.ascontiguousarray(extra, np.float32)
    args = (dists.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            luts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            None if extra_arr is None else extra_arr.ctypes.data,
            n, nq, m, h, k)
    rc = 2  # 2: the fast scanner does not take this shape or build
    if method in ("auto", "fast"):
        if hasattr(lib, "lsq_linscan_fast"):
            rc = lib.lsq_linscan_fast(*args)
        if rc == 2 and method == "fast":
            raise RuntimeError("lsq_linscan_fast unsupported in this build")
    if rc == 2:
        rc = lib.lsq_linscan(*args)
    if rc != 0:
        raise RuntimeError(f"lsq_linscan failed with code {rc}")
    return dists, ids
