"""Recall@N evaluation against exact nearest-neighbor ground truth.

(Reference: eval_recall, src/linscan/Linscan.jl:76-117,
itself derived from H. Jegou's test_compute_stats.m.) Returns the full
recall@N curve and prints the standard milestones.

A copy of `local_search_quantization_tpu.utils.eval` (that package imports
JAX on import).
"""

from __future__ import annotations

import numpy as np

_MILESTONES = (1, 2, 5, 10, 20, 50, 100, 200, 500, 1000, 2000, 5000, 10000)


def eval_recall(
    gt: np.ndarray, ids_predicted: np.ndarray, k: int, *, verbose: bool = True
) -> np.ndarray:
    """Recall@N curve for N = 1..k.

    Args:
      gt: [nq] true nearest-neighbor id per query (0-based).
      ids_predicted: [nq, k] predicted ids, best first (0-based).
      k: curve length.

    Returns:
      [k] float64: recall_at[N-1] = fraction of queries whose true NN appears
      in the first N predictions.
    """
    gt = np.asarray(gt).reshape(-1)
    ids = np.asarray(ids_predicted)
    nq = ids.shape[0]
    assert gt.shape[0] == nq, f"{gt.shape[0]} ground-truth ids for {nq} queries"

    hits = ids[:, :k] == gt[:, None]  # [nq, k]
    found = hits.any(axis=1)
    ranks = np.where(found, hits.argmax(axis=1) + 1, k + 1)  # 1-based rank

    recall_at = np.cumsum(np.bincount(ranks, minlength=k + 2)[1 : k + 1]) / nq
    if verbose:
        for nn in _MILESTONES:
            if nn <= k:
                print(f"r@{nn} = {100.0 * recall_at[nn - 1]:.2f}")
    return recall_at
