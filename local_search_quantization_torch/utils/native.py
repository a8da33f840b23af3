"""ctypes binding to the native host scanner (native/liblsqnative.so).

The port's copy of `local_search_quantization_tpu.utils.native` (which cannot
be imported without JAX): the same library, built by `make -C native`, found
at `native/liblsqnative.so` or at $LSQ_TPU_NATIVE_LIB. `available()` is False
when it is not built, and callers take another route. Takes and returns
numpy arrays: the exhaustive scanner (`linscan`), the IVF segment scanner
(`linscan_ivf`, where the build exports it: `has_ivf`) and the bulk TEXMEX
reader (`vecs_read`).
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB = None
_TRIED = False
NOT_BUILT = "native library not built; run `make -C native`"


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
    if hasattr(lib, "lsq_linscan_ivf"):
        lib.lsq_linscan_ivf.restype = ctypes.c_int
        lib.lsq_linscan_ivf.argtypes = [
            ctypes.POINTER(ctypes.c_float),  # dists out [nq, k]
            ctypes.POINTER(ctypes.c_int64),  # ids out [nq, k]
            ctypes.POINTER(ctypes.c_uint8),  # codes_g [n_g, m]
            ctypes.c_void_p,  # codesT_g [m, n_g] or NULL
            ctypes.POINTER(ctypes.c_float),  # luts [nq, m, h]
            ctypes.c_void_p,  # extra_g [n_g] or NULL
            ctypes.POINTER(ctypes.c_int64),  # order [n_g]
            ctypes.POINTER(ctypes.c_int64),  # starts [nlist + 1]
            ctypes.POINTER(ctypes.c_int64),  # lives [nlist]
            ctypes.POINTER(ctypes.c_int32),  # probes [nq, nprobe]
            ctypes.c_float,  # emin
            ctypes.c_int64,  # n_g
            ctypes.c_int64,  # nq
            ctypes.c_int,  # m
            ctypes.c_int,  # h
            ctypes.c_int,  # k
            ctypes.c_int,  # nprobe
            ctypes.c_int64,  # nlist
        ]
    lib.lsq_vecs_read.restype = ctypes.c_int64
    lib.lsq_vecs_read.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int64,
                                  ctypes.c_int64, ctypes.c_void_p,
                                  ctypes.POINTER(ctypes.c_int)]
    _LIB = lib
    return _LIB


def available() -> bool:
    return _load() is not None


def has_ivf() -> bool:
    """True when the built library exports the IVF segment scanner."""
    lib = _load()
    return lib is not None and hasattr(lib, "lsq_linscan_ivf")


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
        raise RuntimeError(NOT_BUILT)
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


def linscan_ivf(luts: np.ndarray, codes_g: np.ndarray, codesT_g: np.ndarray | None,
                extra_g: np.ndarray | None, order: np.ndarray, starts: np.ndarray,
                lives: np.ndarray, probes: np.ndarray, k: int, *, emin: float = 0.0):
    """Native IVF-ADC scan over probed grouped segments (lsq_linscan_ivf).

    luts [nq, m, h] f32; codes_g [n_g, m] uint8 grouped by list; codesT_g
    [m, n_g] uint8 planes (None forces the scalar path); order [n_g] int64
    original ids; starts [nlist + 1] 64-aligned padded offsets; lives [nlist]
    live rows per segment; probes [nq, nprobe] int32 list ids (-1 = unused).
    Returns (dists [nq, k] ascending, ids [nq, k] int64); short result sets
    pad with (+inf, -1).
    """
    lib = _load()
    if lib is None or not hasattr(lib, "lsq_linscan_ivf"):
        raise RuntimeError(NOT_BUILT)
    luts = np.ascontiguousarray(luts, np.float32)
    codes_g = np.ascontiguousarray(codes_g, np.uint8)
    nq, m, h = luts.shape
    n_g = codes_g.shape[0]
    if codes_g.shape[1] != m:
        raise ValueError(f"codes are [n_g, {codes_g.shape[1]}], LUTs have m={m}")
    probes = np.ascontiguousarray(probes, np.int32)
    starts = np.ascontiguousarray(starts, np.int64)
    lives = np.ascontiguousarray(lives, np.int64)
    order = np.ascontiguousarray(order, np.int64)
    dists = np.empty((nq, k), np.float32)
    ids = np.empty((nq, k), np.int64)
    if codesT_g is not None:
        codesT_g = np.ascontiguousarray(codesT_g, np.uint8)
        if codesT_g.shape != (m, n_g):
            raise ValueError(f"codesT_g must be [{m}, {n_g}], got {codesT_g.shape}")
    if extra_g is not None:
        extra_g = np.ascontiguousarray(extra_g, np.float32)
    rc = lib.lsq_linscan_ivf(
        dists.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        codes_g.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        None if codesT_g is None else codesT_g.ctypes.data,
        luts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        None if extra_g is None else extra_g.ctypes.data,
        order.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        lives.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        probes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        float(emin), n_g, nq, m, h, k, probes.shape[1], lives.shape[0])
    if rc != 0:
        raise RuntimeError(f"lsq_linscan_ivf failed with code {rc}")
    return dists, ids


def vecs_read(path: str, scalar: type, offset: int = 0, count: int | None = None):
    """Native bulk TEXMEX (.fvecs/.ivecs/.bvecs) reader: rows [offset,
    offset + count) of the file as [rows, d]; scalar in (np.float32, np.int32,
    np.uint8)."""
    lib = _load()
    if lib is None:
        raise RuntimeError(NOT_BUILT)
    scalar = np.dtype(scalar)
    sb = scalar.itemsize
    # Probe the dimension first to size the buffer.
    dim = ctypes.c_int(0)
    probe = np.empty(0, np.uint8)
    got = lib.lsq_vecs_read(path.encode(), sb, 0, 0, probe.ctypes.data, ctypes.byref(dim))
    if got < 0:
        raise IOError(f"failed to read {path} (rc={got})")
    d = dim.value
    total = os.path.getsize(path) // (4 + d * sb)
    want = total - offset if count is None else min(count, total - offset)
    out = np.empty((want, d), scalar)
    got = lib.lsq_vecs_read(path.encode(), sb, offset, want, out.ctypes.data,
                            ctypes.byref(dim))
    if got < 0:
        raise IOError(f"failed to read {path} (rc={got})")
    return out[:got]
