"""Norm quantization for the additive-code query path (port of `ops/norms.py`).

LSQ's scanner needs ||reconstruction||^2 per database vector; these are
k-means-quantized into an h-entry norm codebook (one extra byte per vector).
"""

from __future__ import annotations

import numpy as np
import torch

from local_search_quantization_torch.ops.costs import reconstruct


def reconstruction_sqnorms(B: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """||sum_i C[i, B[:, i]]||^2 per vector: [n] float32."""
    CB = reconstruct(B, C)
    return torch.sum(CB * CB, dim=-1)


def scalar_kmeans(vals: np.ndarray, h: int, iters: int = 200) -> np.ndarray:
    """1-D Lloyd's in f64 on the host: [h] float64 centers, ascending.

    A copy of the JAX package's host trainer (norms.py:26-76): k-means++
    seeding with a fixed seed, then Lloyd sweeps by sorted bin boundaries.
    """
    v = np.sort(np.asarray(vals, dtype=np.float64))
    rng = np.random.default_rng(0)
    c = np.empty(h)
    c[0] = v[rng.integers(v.shape[0])]
    mind = (v - c[0]) ** 2
    for i in range(1, h):
        tot = mind.sum()
        if tot <= 0:
            c[i:] = c[i - 1]
            break
        idx = min(np.searchsorted(np.cumsum(mind), rng.random() * tot),
                  v.shape[0] - 1)
        c[i] = v[idx]
        np.minimum(mind, (v - c[i]) ** 2, out=mind)
    c = np.sort(c)
    eps = max(1e-9, 1e-12 * abs(v[-1]))
    for _ in range(iters):
        mids = (c[1:] + c[:-1]) / 2.0
        idx = np.searchsorted(mids, v)
        sums = np.bincount(idx, weights=v, minlength=h)
        cnts = np.bincount(idx, minlength=h)
        newc = np.where(cnts > 0, sums / np.maximum(cnts, 1), c)
        if np.max(np.abs(newc - c)) <= eps:
            c = newc
            break
        c = newc
    return c


def train_norm_codebook(B: torch.Tensor, C: torch.Tensor, h: int):
    """1-D k-means over reconstruction norms: (cbnorms [h] f32, codes [n] int32),
    both on C's device."""
    sqnorms = reconstruction_sqnorms(B, C).cpu().numpy()
    centers = scalar_kmeans(sqnorms, h)
    mids = (centers[1:] + centers[:-1]) / 2.0
    codes = np.searchsorted(mids, sqnorms.astype(np.float64))
    return (torch.as_tensor(centers, dtype=torch.float32, device=C.device),
            torch.as_tensor(codes, dtype=torch.int32, device=C.device))


def quantize_norms(B: torch.Tensor, C: torch.Tensor, cbnorms: torch.Tensor,
                   *, block: int = 1 << 16) -> torch.Tensor:
    """Nearest norm-codebook entry per vector: [n] int32 on C's device.

    Chunked over rows so the [n, d] reconstruction stays bounded.
    """
    B = torch.as_tensor(B).to(C.device)
    cbnorms = cbnorms.to(C.device)
    out = torch.empty((B.shape[0],), dtype=torch.int32, device=C.device)
    for s in range(0, B.shape[0], block):
        sq = reconstruction_sqnorms(B[s:s + block], C)
        d2 = (sq[:, None] - cbnorms[None, :]) ** 2
        out[s:s + block] = torch.argmin(d2, dim=-1).to(torch.int32)
    return out
