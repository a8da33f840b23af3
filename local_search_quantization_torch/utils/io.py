"""Dataset I/O: fvecs / ivecs / bvecs readers and the named-dataset registry.

NumPy-native counterparts of the reference's readers
(src/read/fvecs_read.jl, ivecs_read.jl, bvecs_read.jl,
read_datasets.jl). Same binary formats (TEXMEX SIFT1M/GIST1M/SIFT1B):
each record is an int32 dimension header followed by d values. Readers
validate the per-record dimension like the reference's asserts and support
range reads without loading the whole file. Returns row-major [n, d] arrays
(the reference returns d×n column-major — same memory layout, transposed
index convention).

A copy of `local_search_quantization_tpu.utils.io`: importing anything from
that package imports JAX, which the PyTorch port must not need.
"""

from __future__ import annotations

import os

import numpy as np

_DATA_ROOT = os.environ.get("LSQ_TPU_DATA", "./data")


def _vecs_read(filename: str, count: int | None, offset: int, scalar, scalar_bytes):
    with open(filename, "rb") as f:
        header = np.fromfile(f, dtype=np.int32, count=1)
        if header.size != 1:
            raise ValueError(f"{filename}: empty or truncated file")
        d = int(header[0])
        rec_bytes = 4 + d * scalar_bytes
        f.seek(0, os.SEEK_END)
        total = f.tell() // rec_bytes
        n = total - offset if count is None else min(count, total - offset)
        if n < 0:
            raise ValueError(f"{filename}: offset {offset} beyond {total} records")
        f.seek(offset * rec_bytes)
        raw = np.fromfile(f, dtype=np.uint8, count=n * rec_bytes)
    if raw.size != n * rec_bytes:
        raise ValueError(f"{filename}: short read ({raw.size} of {n * rec_bytes} B)")
    recs = raw.reshape(n, rec_bytes)
    dims = recs[:, :4].copy().view(np.int32)[:, 0]
    if not np.all(dims == d):
        raise ValueError(f"{filename}: inconsistent record dimensions")
    body = recs[:, 4:].copy().view(scalar)
    return np.ascontiguousarray(body.reshape(n, d))


def fvecs_read(filename: str, count: int | None = None, offset: int = 0) -> np.ndarray:
    """Read float32 vectors: [n, d] float32."""
    return _vecs_read(filename, count, offset, np.float32, 4)


def ivecs_read(filename: str, count: int | None = None, offset: int = 0) -> np.ndarray:
    """Read int32 vectors (e.g. ground truth): [n, d] int32."""
    return _vecs_read(filename, count, offset, np.int32, 4)


def bvecs_read(filename: str, count: int | None = None, offset: int = 0) -> np.ndarray:
    """Read uint8 vectors (SIFT1B-style): [n, d] uint8."""
    return _vecs_read(filename, count, offset, np.uint8, 1)


_DATASETS = {
    "SIFT1M": ("sift/sift_learn.fvecs", fvecs_read),
    "SIFT1M_base": ("sift/sift_base.fvecs", fvecs_read),
    "SIFT1M_query": ("sift/sift_query.fvecs", fvecs_read),
    "SIFT1M_groundtruth": ("sift/sift_groundtruth.ivecs", ivecs_read),
    "GIST1M": ("gist/gist_learn.fvecs", fvecs_read),
    "GIST1M_base": ("gist/gist_base.fvecs", fvecs_read),
    "GIST1M_query": ("gist/gist_query.fvecs", fvecs_read),
    "GIST1M_groundtruth": ("gist/gist_groundtruth.ivecs", ivecs_read),
    "SIFT1B": ("sift1b/bigann_learn.bvecs", bvecs_read),
    "SIFT1B_base": ("sift1b/bigann_base.bvecs", bvecs_read),
    "SIFT1B_query": ("sift1b/bigann_query.bvecs", bvecs_read),
}


def read_dataset(name: str, count: int | None = None, root: str | None = None):
    """Name -> array dispatch, as the reference's read_dataset
    (read_datasets.jl:8-45). Dataset root: $LSQ_TPU_DATA or ./data.
    """
    if name not in _DATASETS:
        raise ValueError(f"Dataset {name!r} unknown; known: {sorted(_DATASETS)}")
    rel, reader = _DATASETS[name]
    path = os.path.join(root or _DATA_ROOT, rel)
    return reader(path, count)


def dataset_available(name: str, root: str | None = None) -> bool:
    if name not in _DATASETS:
        return False
    return os.path.exists(os.path.join(root or _DATA_ROOT, _DATASETS[name][0]))
