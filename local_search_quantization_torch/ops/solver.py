"""Codebook update: least squares against the one-hot code design.

Port of `ops/solver.py`: with A = [onehot(B[:,0]) ... onehot(B[:,m-1])] the
implicit [n, m*h] design, solve (A^T A + lambda I) K = A^T X for all d
columns at once (solver.py:39-98,201-225). The structured updates (chain,
and any dimension-to-codebook coverage; solver.py:233-375) split the problem
into smaller dense solves. The one-hot products are plain matrix products
(the JAX package leaves them to XLA); every dense solve is a Cholesky
factorization with the same relative ridge, lambda = ridge * trace(G) / rows.
Method "lsqr" is the matrix-free batched LSQR of solver.py:101-198: all d
columns iterate in lockstep, A @ V a gather-sum and A^T @ U a chunked
one-hot product (no atomics, so a solve is bit-identical run to run).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from local_search_quantization_torch.ops.costs import subspace_slices


def _onehot_chunks(B: torch.Tensor, h: int, chunk: int):
    """Yield (s, oh): the [<=chunk, m*h] one-hot of rows s:s+chunk of the
    design A, chunks in row order. `code_gram` and `_At_matvec` both
    accumulate over these chunks, so both sum in this one fixed order.

    A code outside [0, h) (the -1 that masks a pad row) has an all-zero
    one-hot, as `jax.nn.one_hot` gives it: its slot writes 0 into its own
    codebook's first column, which no other code of that row touches."""
    n, m = B.shape
    offs = torch.arange(m, device=B.device) * h
    for s in range(0, n, chunk):
        b = B[s:s + chunk].long()
        valid = (b >= 0) & (b < h)
        oh = torch.zeros((b.shape[0], m * h), dtype=torch.float32, device=B.device)
        oh.scatter_(1, torch.where(valid, b, 0) + offs[None, :], valid.float())
        yield s, oh


def code_gram(B: torch.Tensor, X: torch.Tensor, h: int, *,
              chunk: int = 1 << 13) -> tuple[torch.Tensor, torch.Tensor]:
    """G = A^T A [m*h, m*h] and A^T X [m*h, d], accumulated over n-chunks.

    Row/column i*h + a of G is codebook i's code a, so block (i, j) counts
    joint code assignments of codebooks i and j.
    """
    mh = B.shape[1] * h
    G = torch.zeros((mh, mh), dtype=torch.float32, device=X.device)
    AtX = torch.zeros((mh, X.shape[1]), dtype=torch.float32, device=X.device)
    for s, oh in _onehot_chunks(B, h, chunk):
        G += oh.T @ oh
        AtX += oh.T @ X[s:s + chunk]
    return G, AtX


def _ridge_solve(G: torch.Tensor, AtX: torch.Tensor, ridge: float) -> torch.Tensor:
    """(G + lambda I) K = AtX by Cholesky, lambda = ridge * trace(G) / rows.

    The relative ridge (solver.py:94) keeps unused codes at ~0 and
    regularizes the rank deficiency of additive codebooks. G may carry a
    leading batch axis.
    """
    r = G.shape[-1]
    lam = ridge * torch.diagonal(G, dim1=-2, dim2=-1).sum(-1) / r
    eye = torch.eye(r, dtype=G.dtype, device=G.device)
    L = torch.linalg.cholesky(G + lam[..., None, None] * eye)
    return torch.cholesky_solve(AtX, L)


def _solve_cholesky(B: torch.Tensor, X: torch.Tensor, h: int,
                    ridge: float = 1e-4) -> torch.Tensor:
    m = B.shape[1]
    G, AtX = code_gram(B, X, h)
    return _ridge_solve(G, AtX, ridge).reshape(m, h, X.shape[1])


def _A_matvec(V: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A @ V for V [m, h, d] -> [n, d]: the additive reconstruction, summed
    over the codebooks in order."""
    B = B.long()
    out = V[0][B[:, 0]]
    for i in range(1, B.shape[1]):
        out = out + V[i][B[:, i]]
    return out


def _At_matvec(U: torch.Tensor, B: torch.Tensor, h: int, *,
               chunk: int = 1 << 13) -> torch.Tensor:
    """A^T @ U for U [n, d] -> [m, h, d]: oh^T @ U per one-hot chunk of
    `_onehot_chunks`, accumulated over the chunks in order."""
    m = B.shape[1]
    d = U.shape[1]
    acc = torch.zeros((m * h, d), dtype=torch.float32, device=U.device)
    for s, oh in _onehot_chunks(B, h, chunk):
        acc += oh.T @ U[s:s + chunk]
    return acc.reshape(m, h, d)


def _solve_lsqr(B: torch.Tensor, X: torch.Tensor, h: int,
                niter: int = 32) -> torch.Tensor:
    """Batched matrix-free LSQR (Paige & Saunders) over all d right-hand
    sides at once: each column keeps its own Golub-Kahan scalars as a [d]
    lane, and the loop holds no host sync.

    A column freezes for good once its step |phi| falls below 1e-6 of its
    ||b|| (solver.py:182-190): A is rank-deficient (each one-hot block of a
    row sums to 1), so after ~rank(A) steps |phi| decays to round-off and
    then regrows from lost orthogonality.
    """
    m = B.shape[1]
    d = X.shape[1]
    X = X.to(torch.float32)
    eps = 1e-12

    def norm(v, dims):
        return torch.sqrt(torch.sum(v * v, dim=dims))

    beta = norm(X, 0)  # [d]
    U = X / torch.clamp(beta, min=eps)[None, :]
    V = _At_matvec(U, B, h)  # [m, h, d]
    alpha = norm(V, (0, 1))
    V = V / torch.clamp(alpha, min=eps)[None, None, :]
    W = V
    K = torch.zeros((m, h, d), dtype=torch.float32, device=X.device)
    phibar, rhobar = beta, alpha
    beta0 = beta  # ||b|| per column, for the relative freeze
    active = torch.ones((d,), dtype=torch.bool, device=X.device)
    for _ in range(niter):
        # beta_{i+1} u_{i+1} = A v_i - alpha_i u_i
        U = _A_matvec(V, B) - alpha[None, :] * U
        beta = norm(U, 0)
        U = U / torch.clamp(beta, min=eps)[None, :]
        # alpha_{i+1} v_{i+1} = A^T u_{i+1} - beta_{i+1} v_i
        V = _At_matvec(U, B, h) - beta[None, None, :] * V
        alpha = norm(V, (0, 1))
        V = V / torch.clamp(alpha, min=eps)[None, None, :]
        # Givens rotation of the bidiagonal system.
        rho = torch.sqrt(rhobar * rhobar + beta * beta)
        c = rhobar / torch.clamp(rho, min=eps)
        s = beta / torch.clamp(rho, min=eps)
        theta = s * alpha
        rhobar = -c * alpha
        phi = c * phibar
        active = active & (torch.abs(phi) > 1e-6 * beta0)
        phi = torch.where(active, phi, torch.zeros_like(phi))
        phibar = s * phibar
        K = K + (phi / torch.clamp(rho, min=eps))[None, None, :] * W
        W = V - (theta / torch.clamp(rho, min=eps))[None, None, :] * W
    return K


def update_codebooks(X: torch.Tensor, B: torch.Tensor, h: int, *,
                     method: str = "cholesky", ridge: float = 1e-4,
                     niter: int = 32) -> torch.Tensor:
    """Full (unstructured) codebook update. Returns C [m, h, d].

    method: "cholesky" (normal equations + relative ridge) or "lsqr"
    (`niter` batched LSQR steps); "lsmr" is an alias of "lsqr", as in the
    JAX package (solver.py:211-216).
    """
    if method == "cholesky":
        return _solve_cholesky(B, X, h, ridge)
    if method in ("lsqr", "lsmr"):
        return _solve_lsqr(B, X, h, niter)
    raise ValueError(f"unknown codebook update method: {method!r}")


def chain_dims(d: int, m: int) -> list[tuple[int, int]]:
    """Dimension span of each of m chain codebooks: codebook i spans
    subspaces i-1..i of the m-1 chain subspaces."""
    sub = subspace_slices(d, m - 1)
    spans = [sub[0]]
    for i in range(1, m - 1):
        spans.append((sub[i - 1][0], sub[i][1]))
    spans.append(sub[-1])
    return spans


def _chain_solve(B: torch.Tensor, Xpad: torch.Tensor, h: int,
                 ridge: float = 1e-4) -> torch.Tensor:
    """The m-1 independent 2-codebook systems of the chain layout, batched.

    Subspace s is covered by exactly the codebook pair (s, s+1), so each is
    one [2h, 2h] solve. Xpad: [m-1, n, ds_max] (subspaces zero-padded to
    equal width). Returns [m-1, 2h, ds_max].
    """
    onehot = F.one_hot(B.long(), h).to(Xpad.dtype).transpose(0, 1)  # [m, n, h]
    counts = torch.sum(onehot, dim=1)  # [m, h]
    oh_a, oh_b = onehot[:-1], onehot[1:]  # [m-1, n, h]
    cooc = torch.bmm(oh_a.transpose(1, 2), oh_b)  # [m-1, h, h]
    G = torch.cat([torch.cat([torch.diag_embed(counts[:-1]), cooc], dim=2),
                   torch.cat([cooc.transpose(1, 2), torch.diag_embed(counts[1:])],
                             dim=2)], dim=1)  # [m-1, 2h, 2h]
    AtX = torch.cat([torch.bmm(oh_a.transpose(1, 2), Xpad),
                     torch.bmm(oh_b.transpose(1, 2), Xpad)], dim=1)  # [m-1, 2h, ds]
    return _ridge_solve(G, AtX, ridge)


def update_codebooks_chain(X: torch.Tensor, B: torch.Tensor, h: int, *,
                           ridge: float = 1e-4) -> torch.Tensor:
    """Chain-structured codebook update: full-dimensional C [m, h, d]."""
    n, d = X.shape
    m = B.shape[1]
    sub = subspace_slices(d, m - 1)
    ds_max = max(b - a for a, b in sub)
    Xpad = torch.stack([F.pad(X[:, a:b], (0, ds_max - (b - a))) for a, b in sub])
    K = _chain_solve(B, Xpad, h, ridge)  # [m-1, 2h, ds_max]
    C = torch.zeros((m, h, d), dtype=torch.float32, device=X.device)
    for s, (a, b) in enumerate(sub):
        C[s, :, a:b] += K[s, :h, :b - a]
        C[s + 1, :, a:b] += K[s, h:, :b - a]
    return C


def update_codebooks_struct(X: torch.Tensor, B: torch.Tensor, h: int,
                            dim2cb: np.ndarray, *, ridge: float = 1e-4) -> torch.Tensor:
    """Structured update for any coverage: dim2cb [d, m] bool, dim2cb[dim, i]
    iff codebook i spans dimension `dim`. Dimensions that share a coverage
    pattern form one restricted dense solve. Returns C [m, h, d], zero
    outside each codebook's span."""
    n, d = X.shape
    m = B.shape[1]
    dim2cb = np.asarray(dim2cb, bool)
    if dim2cb.shape != (d, m):
        raise ValueError(f"dim2cb must be [d, m] = {(d, m)}, got {dim2cb.shape}")
    patterns: dict[tuple, list[int]] = {}
    for dim in range(d):
        patterns.setdefault(tuple(dim2cb[dim]), []).append(dim)
    G_full, AtX_full = code_gram(B, X, h)
    C = torch.zeros((m, h, d), dtype=torch.float32, device=X.device)
    for pat, dims in patterns.items():
        active = [i for i in range(m) if pat[i]]
        if not active:
            continue
        cols = torch.as_tensor(np.concatenate(
            [np.arange(i * h, (i + 1) * h) for i in active]), device=X.device)
        dims_t = torch.as_tensor(dims, device=X.device)
        K = _ridge_solve(G_full[cols][:, cols], AtX_full[cols][:, dims_t], ridge)
        K = K.reshape(len(active), h, len(dims))
        for ai, i in enumerate(active):
            C[i][:, dims_t] += K[ai]
    return C
