"""Lloyd's k-means with k-means++ seeding (port of `ops/kmeans.py`).

Distances are ||x||^2 - 2 x.c + ||c||^2 with the cross term as one matrix
product; the center update is a one-hot matrix product (deterministic, no
atomics); both go a block of points at a time where [points, centers] would
pass `_BLOCK_ELEMS`. Randomness comes from an explicit `torch.Generator`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


# Elements of the largest [points, centers] temporary that `assign` and
# `_update_centers` make at once (1 GiB of f32). Above it they work a block of
# points at a time: 2^20 points against 16,384 centers (an IVF coarse
# quantizer at BIGANN-10M) would need 64 GiB a temporary whole. At or below
# it they make one product.
_BLOCK_ELEMS = 1 << 28


class KMeansResult(NamedTuple):
    centers: torch.Tensor  # [k, d]
    assignments: torch.Tensor  # [n] int32
    cost: torch.Tensor  # 0-d: mean squared distance
    iterations: int | torch.Tensor  # Lloyd iterations executed ([m] if batched)


def sq_distances(X: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """Pairwise squared Euclidean distances: [n, k]."""
    cross = X @ centers.T
    xsq = torch.sum(X * X, dim=-1)
    csq = torch.sum(centers * centers, dim=-1)
    return xsq[:, None] - 2.0 * cross + csq[None, :]


def _block_rows(k: int) -> int:
    """Points a block of `assign` and `_update_centers` holds against k
    centers."""
    return max(1, _BLOCK_ELEMS // max(k, 1))


def _assign_block(X: torch.Tensor, centers: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    d2 = sq_distances(X, centers)
    labels = torch.argmin(d2, dim=-1)
    costs = torch.gather(d2, 1, labels[:, None])[:, 0]
    return labels.to(torch.int32), costs


def assign(X: torch.Tensor, centers: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Nearest center, lowest index on ties: ([n] int32 labels, [n] costs).
    A block of `_block_rows` points at a time; each point's label and cost
    are its own row's, whatever the blocks."""
    rows = _block_rows(centers.shape[0])
    parts = [_assign_block(X[s:s + rows], centers)
             for s in range(0, max(X.shape[0], 1), rows)]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def _update_centers(X: torch.Tensor, labels: torch.Tensor,
                    k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean of the assigned points per center: (centers [k, d], counts [k]).
    One-hot products (deterministic, no atomics), summed over blocks of
    `_block_rows` points in their order."""
    rows = _block_rows(k)
    sums = counts = None
    for s in range(0, max(X.shape[0], 1), rows):
        oh = F.one_hot(labels[s:s + rows].long(), k).to(X.dtype)  # [rows, k], exact
        part, n_part = oh.T @ X[s:s + rows], torch.sum(oh, dim=0)
        sums, counts = (part, n_part) if sums is None else (sums + part, counts + n_part)
    return sums / torch.clamp(counts, min=1.0)[:, None], counts


def kmeans_pp_init(gen: torch.Generator, X: torch.Tensor, k: int) -> torch.Tensor:
    """k-means++ seeding (D^2 sampling): [k, d] centers drawn from X's rows."""
    n = X.shape[0]
    first = torch.randint(0, n, (1,), generator=gen, device=gen.device).to(X.device)
    centers = [X[first[0]]]
    mind = torch.sum((X - centers[0][None, :]) ** 2, dim=-1)
    for _ in range(k - 1):
        total = torch.sum(mind)
        probs = torch.where(total > 0, mind / torch.clamp(total, min=1e-30),
                            torch.full_like(mind, 1.0 / n))
        idx = torch.multinomial(probs.to(gen.device), 1, generator=gen).to(X.device)
        c = X[idx[0]]
        centers.append(c)
        mind = torch.minimum(mind, torch.sum((X - c[None, :]) ** 2, dim=-1))
    return torch.stack(centers)


def kmeans(gen: torch.Generator | None, X: torch.Tensor, k: int, *,
           maxiter: int = 100, tol: float = 1e-6,
           centers: torch.Tensor | None = None) -> KMeansResult:
    """Lloyd's k-means with k-means++ init (or the given `centers`) and
    empty-cluster repair.

    Empty clusters are re-seeded at the highest-cost points (kmeans.py:112-119).
    The loop runs while `prev - cost > tol * prev` in float32, with a finite
    first `prev` (the float32 maximum), at most `maxiter` times.
    """
    if centers is None:
        centers = kmeans_pp_init(gen, X, k)
    centers = centers.to(X.device, X.dtype)

    def repair(centers, counts, costs):
        worst = torch.sort(costs, descending=True, stable=True).indices[:k]
        empty = counts == 0.0
        rank = torch.cumsum(empty.to(torch.int64), dim=0) - 1
        repl = X[worst[torch.clamp(rank, 0, worst.shape[0] - 1)]]
        return torch.where(empty[:, None], repl, centers)

    labels, costs = assign(X, centers)
    prev = torch.tensor(torch.finfo(torch.float32).max, dtype=torch.float32,
                        device=X.device)
    cost = torch.mean(costs)
    it = 0
    while it < maxiter and bool((prev - cost) > tol * prev):
        new_centers, counts = _update_centers(X, labels, k)
        centers = repair(new_centers, counts, costs)
        labels, costs = assign(X, centers)
        prev, cost = cost, torch.mean(costs)
        it += 1
    return KMeansResult(centers, labels, cost, it)


def kmeans_batched(gen: torch.Generator | None, Xs: torch.Tensor, k: int, *,
                   maxiter: int = 100, tol: float = 1e-6) -> KMeansResult:
    """Independent k-means over the leading axis of Xs [m, n, ds] (the m
    subspaces of PQ), one after another from `gen`. Returns centers
    [m, k, ds], assignments [m, n], cost [m] and iterations [m]."""
    res = [kmeans(gen, Xs[i], k, maxiter=maxiter, tol=tol) for i in range(Xs.shape[0])]
    return KMeansResult(torch.stack([r.centers for r in res]),
                        torch.stack([r.assignments for r in res]),
                        torch.stack([r.cost for r in res]),
                        torch.tensor([r.iterations for r in res]))
