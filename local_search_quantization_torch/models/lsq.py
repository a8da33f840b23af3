"""LSQ: local-search quantization, the flagship trainer (port of `models/lsq.py`).

EM loop alternating a least-squares codebook update with an ILS/ICM encode,
then a k-means norm codebook for the query path.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from local_search_quantization_torch.ops.costs import qerror
from local_search_quantization_torch.ops.icm import ils_encode, resolve_condition_mode
from local_search_quantization_torch.ops.norms import train_norm_codebook
from local_search_quantization_torch.ops.solver import update_codebooks
from local_search_quantization_torch.utils.config import LSQConfig


class LSQModel(NamedTuple):
    C: torch.Tensor  # [m, h, d] codebooks (in the unrotated data space)
    B: torch.Tensor  # [n, m] int32 training codes
    cbnorms: torch.Tensor  # [h] norm codebook (squared reconstruction norms)
    B_norms: torch.Tensor  # [n] int32 norm codes of the training set
    obj: np.ndarray  # objective trace, float32


def train_lsq(X: torch.Tensor, B, R, config: LSQConfig = LSQConfig(), *,
              generator: torch.Generator | None = None,
              verbose: bool = False) -> LSQModel:
    """Train LSQ from initial codes B and rotation R, on X's device.

    Solves the codebooks in the rotated space once, folds the rotation into
    them (C <- C @ R^T), then alternates encode (ILS/ICM) and codebook least
    squares in the data space. `generator` defaults to one on X's device
    seeded with `config.seed`.
    """
    dev = X.device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(config.seed)
    X = X.to(torch.float32)
    B = torch.as_tensor(B).to(dev, torch.int32)
    R = torch.as_tensor(R).to(dev, torch.float32)
    h = config.h
    ils_kwargs = dict(ilsiter=config.ilsiter, icmiter=config.icmiter,
                      npert=config.npert, randord=config.randord,
                      condition_mode=resolve_condition_mode(config.condition_mode))
    solve_kwargs = dict(method=config.codebook_method, ridge=config.ridge,
                        niter=config.lsqr_niter)

    C = update_codebooks(X @ R, B, h, **solve_kwargs)
    C = C @ R.T
    if verbose:
        print(f"{-2:3d} {float(qerror(X, B, C)):.6e}")

    def encode(B, C):
        res = ils_encode(generator, X, B, C, **ils_kwargs, with_stats=verbose)
        if verbose:
            fb = res.frac_better.cpu().numpy() * 100
            feq = res.frac_equal.cpu().numpy() * 100
            print("    ILS rounds: " + " ".join(
                f"[{b:.2f}% better, {e:.2f}% codes equal]" for b, e in zip(fb, feq)))
        return res.B, res.cost

    B, cost = encode(B, C)
    if verbose:
        print(f"{-1:3d} {float(torch.mean(cost)):.6e}")

    objs = []
    for it in range(1, config.niter + 1):
        obj = float(qerror(X, B, C))
        objs.append(obj)
        if verbose:
            print(f"{it:3d} {obj:.6e}")
        # Stochastic relaxation (LSQ++): noise annealed linearly to zero.
        temp = max(0.0, 1.0 - it / config.niter)
        if config.sr_method == "SR-D" and temp > 0.0:
            std = config.sr_scale * np.sqrt(temp * obj / X.shape[1])
            noise = torch.randn(X.shape, generator=generator, device=generator.device)
            C = update_codebooks(X + std * noise.to(dev), B, h, **solve_kwargs)
        else:
            C = update_codebooks(X, B, h, **solve_kwargs)
            if config.sr_method == "SR-C" and temp > 0.0:
                std = config.sr_scale * np.sqrt(temp * obj / (X.shape[1] * config.m))
                noise = torch.randn(C.shape, generator=generator, device=generator.device)
                C = C + std * noise.to(dev)
        B, cost = encode(B, C)

    cbnorms, B_norms = train_norm_codebook(B, C, h)
    return LSQModel(C, B, cbnorms, B_norms, np.asarray(objs, np.float32))
