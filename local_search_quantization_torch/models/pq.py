"""Product quantization: independent k-means per dimension subspace
(port of `models/pq.py`)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from local_search_quantization_torch.ops.kmeans import kmeans_batched
from local_search_quantization_torch.ops.subspaces import qerror_pq, split_subspaces
from local_search_quantization_torch.utils.config import PQConfig


class PQModel(NamedTuple):
    C_sub: torch.Tensor  # [m, h, ds_max] padded per-subspace codebooks
    B: torch.Tensor  # [n, m] int32 training codes
    error: torch.Tensor  # 0-d train MSE


def _assign_all(Xs: torch.Tensor, C_sub: torch.Tensor) -> torch.Tensor:
    """Per-subspace nearest center, lowest index on ties:
    [m, n, ds] x [m, h, ds] -> [n, m] int32."""
    cross = torch.bmm(Xs, C_sub.transpose(1, 2))  # [m, n, h]
    xsq = torch.sum(Xs * Xs, dim=-1)
    csq = torch.sum(C_sub * C_sub, dim=-1)
    d2 = xsq[:, :, None] - 2.0 * cross + csq[:, None, :]
    return torch.argmin(d2, dim=-1).to(torch.int32).T.contiguous()


def quantize_pq(X: torch.Tensor, C_sub: torch.Tensor) -> torch.Tensor:
    """Encode X with trained PQ codebooks: [n, m] int32 codes on X's device."""
    return _assign_all(split_subspaces(X, C_sub.shape[0]), C_sub)


def train_pq(X: torch.Tensor, config: PQConfig = PQConfig(), *,
             generator: torch.Generator | None = None) -> PQModel:
    """k-means++ Lloyd's in each subspace. `generator` defaults to one on
    X's device seeded with `config.seed`."""
    X = torch.as_tensor(X).to(torch.float32)
    if generator is None:
        generator = torch.Generator(device=X.device).manual_seed(config.seed)
    res = kmeans_batched(generator, split_subspaces(X, config.m), config.h,
                         maxiter=config.kmeans_maxiter, tol=config.kmeans_tol)
    B = res.assignments.T.contiguous()
    return PQModel(res.centers, B, qerror_pq(X, B, res.centers))
