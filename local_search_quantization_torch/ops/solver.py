"""Codebook update: least squares against the one-hot code design.

Port of the unstructured update in `ops/solver.py` (solver.py:39-98,201-225):
with A = [onehot(B[:,0]) ... onehot(B[:,m-1])] the implicit [n, m*h] design,
solve (A^T A + lambda I) K = A^T X for all d columns at once. The one-hot
products are plain matrix products (the JAX package leaves them to XLA);
the solve is a Cholesky factorization with the same relative ridge.
"""

from __future__ import annotations

import torch


def code_gram(B: torch.Tensor, X: torch.Tensor, h: int, *,
              chunk: int = 1 << 13) -> tuple[torch.Tensor, torch.Tensor]:
    """G = A^T A [m*h, m*h] and A^T X [m*h, d], accumulated over n-chunks.

    Row/column i*h + a of G is codebook i's code a, so block (i, j) counts
    joint code assignments of codebooks i and j.
    """
    n, m = B.shape
    mh = m * h
    G = torch.zeros((mh, mh), dtype=torch.float32, device=X.device)
    AtX = torch.zeros((mh, X.shape[1]), dtype=torch.float32, device=X.device)
    offs = torch.arange(m, device=X.device) * h
    for s in range(0, n, chunk):
        b = B[s:s + chunk].long() + offs[None, :]
        oh = torch.zeros((b.shape[0], mh), dtype=torch.float32, device=X.device)
        oh.scatter_(1, b, 1.0)
        G += oh.T @ oh
        AtX += oh.T @ X[s:s + chunk]
    return G, AtX


def _solve_cholesky(B: torch.Tensor, X: torch.Tensor, h: int,
                    ridge: float = 1e-4) -> torch.Tensor:
    m = B.shape[1]
    G, AtX = code_gram(B, X, h)
    # Relative ridge (solver.py:94): keeps unused codes at ~0 and regularizes
    # the rank deficiency of additive codebooks.
    lam = ridge * torch.trace(G) / G.shape[0]
    L = torch.linalg.cholesky(
        G + lam * torch.eye(G.shape[0], dtype=G.dtype, device=G.device))
    K = torch.cholesky_solve(AtX, L)
    return K.reshape(m, h, X.shape[1])


def update_codebooks(X: torch.Tensor, B: torch.Tensor, h: int, *,
                     method: str = "cholesky", ridge: float = 1e-4,
                     niter: int = 32) -> torch.Tensor:
    """Full (unstructured) codebook update. Returns C [m, h, d].

    Only "cholesky" (the config default) is ported; "lsqr"/"lsmr" raise.
    """
    if method == "cholesky":
        return _solve_cholesky(B, X, h, ridge)
    if method in ("lsqr", "lsmr"):
        raise NotImplementedError(
            f"codebook method {method!r} is not ported yet (ROADMAP.md, "
            "modules queue, item 2: batched LSQR); use 'cholesky'")
    raise ValueError(f"unknown codebook update method: {method!r}")
