"""Zero-padded subspace layout for PQ/OPQ codebooks (port of `ops/subspaces.py`).

When m does not divide d the subspaces have unequal sizes (the first d % m
one dimension wider). The stacked layout pads every subspace to the widest
size with zeros in both data and centers, so distances, means and
reconstructions are unaffected.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from local_search_quantization_torch.ops.costs import subspace_slices


def padded_width(d: int, m: int) -> int:
    return -(-d // m)


def split_subspaces(X: torch.Tensor, m: int) -> torch.Tensor:
    """[n, d] -> [m, n, ds_max], each subspace zero-padded on the right."""
    d = X.shape[1]
    w = padded_width(d, m)
    return torch.stack([F.pad(X[:, a:b], (0, w - (b - a)))
                        for a, b in subspace_slices(d, m)])


def merge_subspaces(blocks: torch.Tensor, d: int) -> torch.Tensor:
    """[m, n, ds_max] -> [n, d], stripping the zero padding."""
    spans = subspace_slices(d, blocks.shape[0])
    return torch.cat([blocks[i, :, :b - a] for i, (a, b) in enumerate(spans)], dim=1)


def reconstruct_pq(B: torch.Tensor, C_sub: torch.Tensor, d: int) -> torch.Tensor:
    """PQ reconstruction with the padded layout: [n, m] codes -> [n, d]."""
    Bl = B.long()
    gathered = torch.stack([C_sub[i][Bl[:, i]] for i in range(C_sub.shape[0])])
    return merge_subspaces(gathered, d)


def qerror_pq(X: torch.Tensor, B: torch.Tensor, C_sub: torch.Tensor) -> torch.Tensor:
    """Mean squared error of per-subspace (PQ) codebooks (0-d tensor)."""
    diff = reconstruct_pq(B, C_sub, X.shape[1]) - X
    return torch.mean(torch.sum(diff * diff, dim=-1))


def qerror_opq(X: torch.Tensor, B: torch.Tensor, C_sub: torch.Tensor,
               R: torch.Tensor) -> torch.Tensor:
    """Mean ||R @ cb_n - x_n||^2 for rotated PQ codebooks; row-major, so the
    reconstruction is rotated back as CB @ R^T."""
    diff = reconstruct_pq(B, C_sub, X.shape[1]) @ R.T - X
    return torch.mean(torch.sum(diff * diff, dim=-1))


def pq_full_codebooks(C_sub: torch.Tensor, d: int) -> torch.Tensor:
    """Lift padded per-subspace codebooks to full-dimensional [m, h, d],
    zero outside each codebook's span."""
    m, h, _ = C_sub.shape
    C = torch.zeros((m, h, d), dtype=C_sub.dtype, device=C_sub.device)
    for i, (a, b) in enumerate(subspace_slices(d, m)):
        C[i, :, a:b] = C_sub[i, :, :b - a]
    return C
