"""L1-constrained least squares for sparse codebooks (port of `ops/prox.py`).

Solves

    min_K 0.5 || A @ K - X ||_F^2   s.t.  ||K||_1 <= tau

with A the implicit [n, m*h] one-hot code design, by FISTA with a projection
onto the L1 ball (sort + threshold, Duchi et al. 2008). The operator
applications are the batched LSQR solver's gather-sum and one-hot product.
Every branch of the JAX package's `lax.cond` is computed and selected with
`torch.where`, so no step waits on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from local_search_quantization_torch.ops.solver import _A_matvec, _At_matvec


def _inclusive_scan(x: torch.Tensor) -> torch.Tensor:
    """Cumulative sum of a 1-D tensor in a fixed order (log2(n) shifted adds),
    so every run gives the same bits: torch.cumsum on CUDA adds floats in an
    order that varies from run to run, and the projection's threshold would
    follow it."""
    shift = 1
    while shift < x.shape[0]:
        x = torch.cat([x[:shift], x[shift:] + x[:-shift]])
        shift *= 2
    return x


def project_l1_ball(K: torch.Tensor, tau) -> torch.Tensor:
    """Euclidean projection of K (any shape) onto {||K||_1 <= tau}; K itself
    when it already lies inside."""
    flat = K.reshape(-1)
    v = torch.abs(flat)
    tau = torch.as_tensor(tau, dtype=v.dtype, device=v.device)
    u = torch.sort(v, descending=True).values
    cssv = _inclusive_scan(u) - tau
    idx = torch.arange(1, u.shape[0] + 1, dtype=v.dtype, device=v.device)
    rho = torch.sum(u * idx > cssv) - 1
    theta = torch.clamp(cssv[rho] / (rho + 1.0), min=0.0)
    proj = (torch.sign(flat) * torch.clamp(v - theta, min=0.0)).reshape(K.shape)
    return torch.where(torch.sum(v) <= tau, K, proj)


def estimate_lipschitz(B: torch.Tensor, h: int, iters: int = 12) -> torch.Tensor:
    """Power iteration on A^T A for the FISTA step size: a 0-d estimate of
    its largest eigenvalue."""
    m = B.shape[1]
    v = torch.ones((m, h, 1), dtype=torch.float32, device=B.device)
    for _ in range(iters):
        v = v / torch.clamp(torch.sqrt(torch.sum(v * v)), min=1e-30)
        v = _At_matvec(_A_matvec(v, B), B, h)
    return torch.sqrt(torch.sum(v * v))


def solve_l1_constrained(B: torch.Tensor, X: torch.Tensor, h: int, tau,
                         K0: torch.Tensor, *, iters: int = 100,
                         lr: float | None = None) -> torch.Tensor:
    """FISTA for the tau-constrained problem, warm-started at K0 [m, h, d].

    lr: an explicit step size; None steps 1/L with L from
    `estimate_lipschitz`.
    """
    if lr is None:
        step = 1.0 / torch.clamp(estimate_lipschitz(B, h), min=1e-12)
    else:
        step = torch.tensor(lr, dtype=torch.float32, device=X.device)
    K = Y = project_l1_ball(K0, tau)
    # The momentum scalars in float32, as the JAX package's scan carries them.
    one = np.float32(1.0)
    t = one
    for _ in range(iters):
        grad = _At_matvec(_A_matvec(Y, B) - X, B, h)
        K_new = project_l1_ball(Y - step * grad, tau)
        t_new = np.float32(0.5) * (one + np.sqrt(one + np.float32(4.0) * t * t))
        Y = K_new + float((t - one) / t_new) * (K_new - K)
        K, t = K_new, t_new
    return K


def threshold_top_s(K: torch.Tensor, S: int) -> torch.Tensor:
    """Keep the entries of K with |K| >= the S-th largest |K| (every tie at
    the cutoff stays), zero the rest."""
    flat = torch.abs(K.reshape(-1))
    if S >= flat.shape[0]:
        return K
    cutoff = torch.sort(flat).values[-S]
    return torch.where(torch.abs(K) >= cutoff, K, torch.zeros_like(K))
