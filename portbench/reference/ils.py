"""The plain reference of the LSQ encoder: iterated local search (ILS) with
ICM sweeps, and the squared reconstruction error of codes.

The algorithm of the reference implementation (Martinez et al., LSQ, ECCV
2016; its `encode_icm` / ILS loop): start from uniform random codes; each
round re-draws `npert` codebook entries of every row, runs `icmiter` ICM
sweeps over the codebooks in a random order (each visit sets a codebook's
entry to the argmin of its unary plus the pairwise terms of the others'
current entries), and keeps the new codes of a row only where its
objective fell. Its draws are its own, so it gives other codes than the
program: what is compared is the error of the codes, not the codes.

Plain torch, computed in `dtype` (float64 for the reference; the control
runs it in bfloat16): no kernel, no TF32, nothing of the program imported.
"""

from __future__ import annotations

import torch


def _objective(xsq, U, P, B):
    """||x||^2 + sum_i U[n, i, B_i] + sum_{i<j} P[i, j, B_i, B_j] per row."""
    m = B.shape[1]
    total = xsq + torch.gather(U, 2, B[:, :, None])[:, :, 0].sum(1)
    for i in range(m):
        for j in range(i + 1, m):
            total = total + P[i, j][B[:, i], B[:, j]]
    return total


def encode(X: torch.Tensor, C: torch.Tensor, gen: torch.Generator, *, ilsiter: int,
           icmiter: int = 4, npert: int = 4, dtype=torch.float64) -> torch.Tensor:
    """Codes [n, m] int64 of X [n, d] against codebooks C [m, h, d]."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = X.device
    X, C = X.to(dtype), C.to(device=dev, dtype=dtype)
    n, (m, h, _) = X.shape[0], C.shape
    U = (C * C).sum(-1)[None] - 2.0 * torch.einsum("nd,ihd->nih", X, C)
    P = 2.0 * torch.einsum("ihd,jkd->ijhk", C, C)
    xsq = (X * X).sum(1)
    B = torch.randint(0, h, (n, m), generator=gen, device=dev)
    cost = _objective(xsq, U, P, B)
    rows = torch.arange(n, device=dev)
    for _ in range(ilsiter):
        order = torch.randperm(m, generator=gen, device=dev).tolist()
        u = torch.rand((n, m), generator=gen, device=dev)
        kth = torch.topk(u, npert, dim=1).values[:, -1:]
        Bp = torch.where(u >= kth, torch.randint(0, h, (n, m), generator=gen, device=dev), B)
        for _ in range(icmiter):
            for j in order:
                s = U[:, j, :]
                for k in range(m):
                    if k != j:
                        s = s + P[k, j][Bp[:, k]]
                Bp[rows, j] = torch.argmin(s, dim=1)
        new = _objective(xsq, U, P, Bp)
        better = new < cost
        B = torch.where(better[:, None], Bp, B)
        cost = torch.where(better, new, cost)
    return B


def sq_error(X: torch.Tensor, C: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """[n] float64 ||x - sum_i C[i, B_i]||^2 of codes B [n, m]."""
    X, C = X.double(), C.to(device=X.device, dtype=torch.float64)
    B = B.to(X.device, torch.long)
    rec = C[0][B[:, 0]]
    for i in range(1, C.shape[0]):
        rec = rec + C[i][B[:, i]]
    return ((X - rec) ** 2).sum(1)
