"""Optimized product quantization: PQ plus a learned rotation
(port of `models/opq.py`).

Alternating minimization over (R, C, B): the orthogonal Procrustes rotation
from the SVD of the data/reconstruction cross-covariance, per-subspace center
means, and nearest-center assignments.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from local_search_quantization_torch.models.pq import _assign_all, quantize_pq
from local_search_quantization_torch.ops.subspaces import reconstruct_pq, split_subspaces
from local_search_quantization_torch.utils.config import OPQConfig


class OPQModel(NamedTuple):
    C_sub: torch.Tensor  # [m, h, ds_max]
    B: torch.Tensor  # [n, m] int32
    R: torch.Tensor  # [d, d] rotation
    obj: np.ndarray  # [niter+1] objective trace, float32


def quantize_opq(X: torch.Tensor, R: torch.Tensor, C_sub: torch.Tensor) -> torch.Tensor:
    """Rotate into code space (row-major: X @ R), then PQ-encode."""
    return quantize_pq(X @ R, C_sub)


def _update_centers_batched(Xs: torch.Tensor, B: torch.Tensor, h: int,
                            prev: torch.Tensor) -> torch.Tensor:
    """Per-subspace center means from assignments; an empty center keeps its
    previous value. Xs [m, n, ds], B [n, m], prev [m, h, ds]."""
    out = []
    for i in range(Xs.shape[0]):
        oh = F.one_hot(B[:, i].long(), h).to(Xs.dtype)  # [n, h], exact
        counts = torch.sum(oh, dim=0)
        means = (oh.T @ Xs[i]) / torch.clamp(counts, min=1.0)[:, None]
        out.append(torch.where((counts > 0)[:, None], means, prev[i]))
    return torch.stack(out)


def _opq_loop(X: torch.Tensor, C0: torch.Tensor, B0: torch.Tensor, R0: torch.Tensor,
              niter: int, h: int):
    """niter+1 updates of (R, C, B) from (C0, B0, R0), the objective recorded
    at the start of each (the reference's inclusive `for iter=0:niter`).
    Returns (C, B, R, obj [niter+1] float32 ndarray)."""
    m, d = C0.shape[0], X.shape[1]
    C, B, R = C0, B0, R0
    objs = []
    for _ in range(niter + 1):
        CB = reconstruct_pq(B, C, d)  # [n, d] in rotated space
        objs.append(torch.mean(torch.sum((CB @ R.T - X) ** 2, dim=-1)))
        U, _, Vh = torch.linalg.svd(X.T @ CB, full_matrices=False)
        R = U @ Vh
        RXs = split_subspaces(X @ R, m)
        C = _update_centers_batched(RXs, B, h, C)
        B = _assign_all(RXs, C)
    return C, B, R, torch.stack(objs).cpu().numpy().astype(np.float32)


def train_opq(X: torch.Tensor, config: OPQConfig = OPQConfig(), *,
              generator: torch.Generator | None = None) -> OPQModel:
    """Train OPQ on X's device. `generator` defaults to one on X's device
    seeded with `config.seed`."""
    X = torch.as_tensor(X).to(torch.float32)
    if generator is None:
        generator = torch.Generator(device=X.device).manual_seed(config.seed)
    n, d = X.shape
    m, h = config.m, config.h
    gdev = generator.device
    if config.init == "natural":
        R = torch.eye(d, dtype=torch.float32, device=X.device)
    elif config.init == "random":
        G = torch.randn((d, d), generator=generator, device=gdev).to(X.device)
        R = torch.linalg.svd(G)[0]
    else:
        raise ValueError(f"unknown OPQ init {config.init!r}")
    RXs = split_subspaces(X @ R, m)
    # h distinct training vectors per subspace, an independent draw for each
    # subspace (opq.py:124-133).
    C0 = torch.stack([RXs[i][torch.randperm(n, generator=generator, device=gdev)[:h]
                             .to(X.device)] for i in range(m)])
    B0 = _assign_all(RXs, C0)
    C, B, R, objs = _opq_loop(X, C0, B0, R, config.niter, h)
    return OPQModel(C, B, R, objs)
