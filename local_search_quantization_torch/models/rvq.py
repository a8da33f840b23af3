"""RVQ: residual vector quantization (port of `models/rvq.py`).

Stage j runs k-means on the residual that stages 0..j-1 leave, so training
is m Lloyd's runs and encoding m nearest-center assignments in turn. Its
codes are additive and full-dimensional, [n, m] -> C [m, h, d], like
ChainQ's and LSQ's, so the additive serving stack (norm codebook,
`adc.linscan_lsq`, IVF, refine, `Index`) serves them unchanged.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from local_search_quantization_torch.ops.kmeans import assign, kmeans
from local_search_quantization_torch.ops.norms import train_norm_codebook
from local_search_quantization_torch.utils.config import RVQConfig


class RVQModel(NamedTuple):
    C: torch.Tensor  # [m, h, d] stage codebooks (data space)
    B: torch.Tensor  # [n, m] int32 training codes
    cbnorms: torch.Tensor  # [h] norm codebook (squared reconstruction norms)
    B_norms: torch.Tensor  # [n] int32 norm codes of the training set
    obj: np.ndarray  # [m] residual MSE after each stage, float32


def train_rvq(X: torch.Tensor, config: RVQConfig = RVQConfig(), *,
              generator: torch.Generator | None = None,
              verbose: bool = False) -> RVQModel:
    """Greedy residual k-means, one stage a codebook, on X's device.
    `generator` defaults to one on X's device seeded with `config.seed`."""
    if generator is None:
        generator = torch.Generator(device=X.device).manual_seed(config.seed)
    residual = X.to(torch.float32)
    Cs, Bs, objs = [], [], []
    for j in range(config.m):
        res = kmeans(generator, residual, config.h, maxiter=config.kmeans_maxiter)
        labels, _ = assign(residual, res.centers)
        residual = residual - res.centers[labels.long()]
        obj = float(torch.mean(torch.sum(residual * residual, dim=-1)))
        Cs.append(res.centers)
        Bs.append(labels)
        objs.append(obj)
        if verbose:
            print(f"{j:3d} {obj:.6e}")
    C = torch.stack(Cs)
    B = torch.stack(Bs, dim=1)
    cbnorms, B_norms = train_norm_codebook(B, C, config.h)
    return RVQModel(C, B, cbnorms, B_norms, np.asarray(objs, np.float32))


def quantize_rvq(X: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """Greedy sequential encode: [n, m] int32 codes on C's device.

    Stage j assigns the residual after stages < j to its nearest center, the
    training rule, so encoding the training set (whole, as it was trained)
    gives back its training codes.
    """
    residual = torch.as_tensor(X).to(C.device, torch.float32)
    out = []
    for j in range(C.shape[0]):
        labels, _ = assign(residual, C[j])
        residual = residual - C[j][labels.long()]
        out.append(labels)
    return torch.stack(out, dim=1)
