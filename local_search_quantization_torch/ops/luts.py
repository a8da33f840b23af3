"""Unary / pairwise lookup tables of the MCQ MRF.

The MCQ objective for a vector x and codes (b_1..b_m) is
    ||x - sum_i C[i, b_i]||^2
      = ||x||^2 + sum_i (||C[i,b_i]||^2 - 2 x.C[i,b_i])   (unary terms)
        + sum_{i<j} 2 C[i,b_i].C[j,b_j]                   (pairwise terms)

Port of `local_search_quantization_tpu.ops.luts`, which asks for
precision="highest" (luts.py:33,49). Float32 products here are full float32
as long as TF32 is off: the entry points set
`torch.backends.cuda.matmul.allow_tf32 = False`.
"""

from __future__ import annotations

import torch


def get_unaries(X: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """Unary terms: unaries[n, i, k] = ||C[i,k]||^2 - 2 x_n . C[i,k].

    X: [n, d], C: [m, h, d] -> [n, m, h] float32, contiguous.
    """
    cross = torch.einsum("nd,mhd->nmh", X, C)
    sqnorm = torch.sum(C * C, dim=-1)  # [m, h]
    return (sqnorm[None, :, :] - 2.0 * cross).contiguous()


def get_binaries(C: torch.Tensor) -> torch.Tensor:
    """All pairwise terms: binaries[i, j] = 2 * C[i] @ C[j]^T, an [h, h] table.

    Returns the full [m, m, h, h] tensor, contiguous (binaries[j, i] ==
    binaries[i, j]^T); the diagonal blocks are never read by ICM.
    """
    return (2.0 * torch.einsum("ihd,jkd->ijhk", C, C)).contiguous()
