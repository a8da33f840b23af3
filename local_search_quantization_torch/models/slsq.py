"""Sparse LSQ: additive codes with L1-constrained, thresholded codebooks
(port of `models/slsq.py`).

LSQ's EM loop, with the codebook update solved by FISTA on the L1 ball
(`ops/prox.py`) and then cut to the S largest entries; the codebooks start
as the full-dimensional lift of a PQ init, and training runs in the rotated
space with R fixed.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from local_search_quantization_torch.ops.costs import qerror
from local_search_quantization_torch.ops.icm import ils_encode, resolve_condition_mode
from local_search_quantization_torch.ops.norms import train_norm_codebook
from local_search_quantization_torch.ops.prox import solve_l1_constrained, threshold_top_s
from local_search_quantization_torch.ops.subspaces import pq_full_codebooks
from local_search_quantization_torch.utils.config import SLSQConfig


class SLSQModel(NamedTuple):
    C: torch.Tensor  # [m, h, d] sparse codebooks (rotated space)
    B: torch.Tensor  # [n, m] int32
    R: torch.Tensor  # [d, d] (fixed; from the PQ/OPQ init)
    cbnorms: torch.Tensor  # [h]
    B_norms: torch.Tensor  # [n] int32
    obj: np.ndarray  # per-iteration objective, float32
    l0: np.ndarray  # per-iteration nnz(C), float32
    l1: np.ndarray  # per-iteration ||C||_1, float32


def train_lsq_sparse(X: torch.Tensor, B, C_sub_init, R,
                     config: SLSQConfig = SLSQConfig(), *,
                     generator: torch.Generator | None = None,
                     verbose: bool = False) -> SLSQModel:
    """Train sparse LSQ from a PQ init, on X's device.

    X: [n, d] training data (unrotated); B: [n, m] init codes (PQ's);
    C_sub_init: [m, h, ds] padded PQ codebooks (lifted to full width here);
    R: [d, d] rotation (the identity for a plain PQ init). `generator`
    defaults to one on X's device seeded with `config.seed`.
    """
    dev = X.device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(config.seed)
    X = X.to(torch.float32)
    B = torch.as_tensor(B).to(dev, torch.int32)
    R = torch.as_tensor(R).to(dev, torch.float32)
    d = X.shape[1]
    h = config.h
    S = config.S if config.S > 0 else d * h
    ils_kwargs = dict(ilsiter=config.ilsiter, icmiter=config.icmiter,
                      npert=config.npert, randord=config.randord,
                      condition_mode=resolve_condition_mode(config.condition_mode, dev))

    RX = X @ R
    C = pq_full_codebooks(torch.as_tensor(C_sub_init).to(dev, torch.float32), d)
    # tau from the init codebooks' L1 norm (demo_lsq_sparse.jl:32-41).
    tau = torch.sum(torch.abs(C)) * float(np.float32(config.tau_scale))
    if verbose:
        print(f"Warm start error: {float(qerror(RX, B, C)):e}")

    def sparse_update(C_prev):
        K = solve_l1_constrained(B, RX, h, tau, C_prev, iters=config.prox_iters,
                                 lr=config.prox_lr)
        return threshold_top_s(K, S)

    C = sparse_update(C)
    if verbose:
        print(f"{int(torch.sum(C != 0))} non-zero elements. l1 norm is "
              f"{float(torch.sum(torch.abs(C))):e}")
    B = ils_encode(generator, RX, B, C, **ils_kwargs).B

    objs, l0s, l1s = [], [], []
    for it in range(1, config.niter + 1):
        obj = float(qerror(RX, B, C))
        objs.append(obj)
        if verbose:
            print(f"{it:3d} {obj:e}")
        C = sparse_update(C)
        l0s.append(float(torch.sum(C != 0)))
        l1s.append(float(torch.sum(torch.abs(C))))
        B = ils_encode(generator, RX, B, C, **ils_kwargs).B

    cbnorms, B_norms = train_norm_codebook(B, C, h)
    return SLSQModel(C, B, R, cbnorms, B_norms, np.asarray(objs, np.float32),
                     np.asarray(l0s, np.float32), np.asarray(l1s, np.float32))
