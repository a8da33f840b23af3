"""ChainQ: chain-structured multi-codebook quantization (port of `models/chainq.py`).

EM loop of a Procrustes rotation update, the chain-structured least-squares
codebook update (each dimension covered by at most two chain-adjacent
codebooks) and exact Viterbi encoding.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from local_search_quantization_torch.ops.costs import qerror, reconstruct
from local_search_quantization_torch.ops.solver import update_codebooks_chain
from local_search_quantization_torch.ops.viterbi import viterbi_encode
from local_search_quantization_torch.utils.config import ChainQConfig


class ChainQModel(NamedTuple):
    C: torch.Tensor  # [m, h, d] full-dimensional chain codebooks
    B: torch.Tensor  # [n, m] int32
    R: torch.Tensor  # [d, d]
    obj: np.ndarray  # [niter+1] objective trace, float32


def _procrustes(X: torch.Tensor, CB: torch.Tensor) -> torch.Tensor:
    """R = U V^T from the SVD of X^T CB: the rotation minimizing
    ||X R - CB||_F (unique when X^T CB has full rank)."""
    U, _, Vh = torch.linalg.svd(X.T @ CB, full_matrices=False)
    return U @ Vh


def train_chainq(X: torch.Tensor, B, R, config: ChainQConfig = ChainQConfig(), *,
                 C_sub_init=None, verbose: bool = False) -> ChainQModel:
    """Train a chain quantizer on X's device, warm-started from (B, R), e.g.
    OPQ's codes and rotation.

    The first step re-solves the codebooks from (X R, B), so initial
    codebooks only enter through B; `C_sub_init` is accepted for API parity
    and unused. The loop is the reference's inclusive `for iter = 0:niter`:
    niter+1 updates, the objective recorded at the start of each. With
    `verbose`, prints the objective after the first solve (-2), after the
    first encode (-1) and at each iteration.
    """
    X = torch.as_tensor(X).to(torch.float32)
    dev = X.device
    B = torch.as_tensor(B).to(dev, torch.int32)
    R = torch.as_tensor(R).to(dev, torch.float32)
    h = config.h
    RX = X @ R
    C = update_codebooks_chain(RX, B, h, ridge=config.ridge)
    if verbose:
        print(f"{-2:3d} {float(qerror(RX, B, C)):.6e}")
    B = viterbi_encode(RX, C)
    if verbose:
        print(f"{-1:3d} {float(qerror(RX, B, C)):.6e}")
    objs = []
    for it in range(config.niter + 1):
        obj = float(qerror(RX, B, C))
        objs.append(obj)
        if verbose:
            print(f"{it:3d} {obj:.6e}")
        R = _procrustes(X, reconstruct(B, C))
        RX = X @ R
        C = update_codebooks_chain(RX, B, h, ridge=config.ridge)
        B = viterbi_encode(RX, C)
    return ChainQModel(C, B, R, np.asarray(objs, np.float32))
