"""Reconstruction, quantization error and subspace spans (port of `ops/costs.py`)."""

from __future__ import annotations

import torch


def reconstruct(B: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """Additive reconstruction sum_i C[i, B[:, i], :]: B [n, m], C [m, h, d] -> [n, d].

    Summed in codebook order."""
    B = B.long()
    out = C[0][B[:, 0]]
    for i in range(1, C.shape[0]):
        out = out + C[i][B[:, i]]
    return out


def veccost(X: torch.Tensor, B: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """Per-vector squared reconstruction error ||x_n - sum_i C[i, b_ni]||^2: [n]."""
    diff = reconstruct(B, C) - X
    return torch.sum(diff * diff, dim=-1)


def qerror(X: torch.Tensor, B: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """Mean squared quantization error over the dataset (0-d tensor)."""
    return torch.mean(veccost(X, B, C))


def subspace_slices(d: int, m: int) -> list[tuple[int, int]]:
    """Contiguous (start, stop) spans splitting `d` dims into `m` parts; the
    first (d % m) parts get one extra dimension (costs.py:50-63)."""
    base, extra = divmod(d, m)
    spans = []
    start = 0
    for i in range(m):
        size = base + (1 if i < extra else 0)
        spans.append((start, start + size))
        start += size
    return spans
