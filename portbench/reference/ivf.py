"""The plain reference of a probed (IVF) search: which lists a query must
probe and which it may, from the program's coarse centroids in float64, and
the exact ADC top-k over the lists it must probe (`reference.adc`).

A query probes the nprobe lists of least coarse score s(c) = ||c||^2 - 2 q.c.
Let t be the nprobe-th least score in float64. The program scores in
float32, so a list whose score lies within `eps_q` of t may rightly be
probed or not: the CERTAIN lists have s < t - eps_q, the POSSIBLE lists
s <= t + eps_q. An answered row must lie in a possible list
(`probe_miss`), and at each rank the program's distance must be no worse
than the reference's exact top-k over the certain lists (`rank_gap`).

Plain torch: no kernel, no TF32, nothing of the program imported. The lists
are read as the partition holds them: `order` (the id at each grouped
position, -1 on pads), `starts` (each list's first position) and `lives`
(its live rows). The partition holds every row of the index (no rows added
since it was built).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.adc import Searcher, _f64

# Relative slack on a coarse score, from float32 rounding: a float32 dot
# product of d = 128 terms is within d * 2^-24 = 7.6e-6 of the float64 one,
# relative to sum |q_i c_i| <= |q| |c|, and the norms and the subtraction add
# less; a list's rank can flip only where two scores are within twice one
# score's error of each other. So eps_q = 2e-5 (|c|^2 + 2 |q| |c|), with the
# largest centroid norm, bounds the flips the program may rightly make.
COARSE_EPS = 2e-5


class Lists:
    """The partition's coarse quantizer and lists, on `device` in float64:
    centroids [nlist, d], order [n_g], starts [nlist + 1] (or [nlist]),
    lives [nlist] (host arrays)."""

    def __init__(self, centroids, order, starts, lives, device):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.device = torch.device(device)
        self.cent = _f64(centroids, device)
        self.cn = (self.cent * self.cent).sum(1)
        self.order = np.asarray(order, np.int64)
        self.starts = np.asarray(starts, np.int64)[:len(lives)]
        self.lives = np.asarray(lives, np.int64)
        n = int(self.lives.sum())
        # The list of each id (ids of the partition are 0..n-1).
        list_of = np.full(n, -1, np.int64)
        for li in np.flatnonzero(self.lives):
            s0 = self.starts[li]
            list_of[self.order[s0:s0 + self.lives[li]]] = li
        self.list_of = torch.as_tensor(list_of, device=self.device)

    @property
    def nlist(self) -> int:
        return int(self.lives.shape[0])

    def scores(self, Q) -> torch.Tensor:
        """[s, nlist] coarse scores ||c||^2 - 2 q.c."""
        return self.cn[None, :] - 2.0 * (_f64(Q, self.device) @ self.cent.T)

    def sets(self, Q, nprobe: int) -> tuple[torch.Tensor, torch.Tensor]:
        """(certain, possible) [s, nlist] bool: the lists a query must probe
        and those it may."""
        Q = _f64(Q, self.device)
        sc = self.scores(Q)
        p = min(nprobe, self.nlist)
        t = torch.topk(sc, p, dim=1, largest=False).values[:, -1:]
        qn = Q.norm(dim=1, keepdim=True)
        cmax = self.cent.norm(dim=1).max()
        eps = COARSE_EPS * (cmax * cmax + 2.0 * qn * cmax)
        return sc < t - eps, sc <= t + eps

    def rows_probed(self, Q, nprobe: int) -> int:
        """The live rows of the nprobe lists of least score, summed over the
        queries Q: the scan's work, whatever implements it."""
        p = min(nprobe, self.nlist)
        idx = torch.topk(self.scores(Q), p, dim=1, largest=False).indices
        return int(torch.as_tensor(self.lives, device=self.device)[idx].sum())

    def ids(self, lists: torch.Tensor) -> np.ndarray:
        """The ids of the live rows of `lists` (a [nlist] bool mask)."""
        segs = [self.order[self.starts[li]:self.starts[li] + self.lives[li]]
                for li in torch.nonzero(lists).flatten().tolist()]
        return np.concatenate(segs) if segs else np.zeros(0, np.int64)


def topk_hi_over(searcher: Searcher, luts: torch.Tensor, ids: np.ndarray,
                 k: int) -> torch.Tensor:
    """[k] the k least upper distances of one query (luts [1, m, h]) over
    the rows `ids`, ascending, +inf past them."""
    out = torch.full((k,), float("inf"), dtype=torch.float64, device=searcher.device)
    if ids.size:
        codes = torch.as_tensor(np.asarray(searcher.B)[ids]).to(searcher.device, torch.long)
        _, hi = searcher._rows(codes)
        d = searcher._lutsum(luts, codes)[0] + hi
        kk = min(k, d.shape[0])
        out[:kk] = torch.topk(d, kk, largest=False).values
    return out


def judge(searcher: Searcher, lists: Lists, Q, ids, dists, k: int, nprobe: int) -> dict:
    """The comparison of one set of probed answers with the reference.

    Q [s, d] the queries; ids, dists [s, k] what the program answered.
    Returns {"bad_ids": rows with an id out of range, repeated, or without a
    finite distance, "probe_miss": answered rows that lie in no list the
    query may probe, "rank_gap": the largest amount, as a share of the
    query's summand magnitude, by which an answered row's distance lies
    above the reference's exact top-k over the certain lists at the same
    rank, "dist_gap": the largest amount, likewise, by which an answered
    distance lies outside the row's true distance}.
    """
    n = searcher.B.shape[0]
    ids = torch.as_tensor(np.asarray(ids)).to(searcher.device, torch.long)
    dists = _f64(dists, searcher.device)
    valid = (ids >= 0) & (ids < n)
    srt = torch.sort(torch.where(valid, ids, -1 - torch.arange(
        ids.shape[1], device=ids.device)[None, :]), dim=1).values
    dup = (srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)
    luts = searcher.luts(Q)
    scale = searcher.scale(luts)[:, None]
    certain, possible = lists.sets(Q, nprobe)
    t_hi = torch.stack([topk_hi_over(searcher, luts[i:i + 1], lists.ids(certain[i]), k)
                        for i in range(luts.shape[0])])
    lut, lo, hi = searcher.at(luts, ids)
    ok = valid & torch.isfinite(dists)
    # A row outside the partition (no list: an id past it) is a miss too.
    grouped = lists.list_of.shape[0]
    li = torch.where(ids < grouped, lists.list_of[ids.clamp(0, grouped - 1)], -1)
    miss = ok & ((li < 0) | ~torch.gather(possible, 1, li.clamp(min=0)))
    rank = torch.where(ok, (lut + lo - t_hi[:, :ids.shape[1]]) / scale,
                       torch.zeros_like(dists))
    inside = torch.clamp(dists, lut + lo, lut + hi)
    dist = torch.where(ok, (dists - inside).abs() / scale, torch.zeros_like(dists))
    bad = (~ok).any(1) | dup.any(1)
    return {"bad_ids": int(bad.sum()), "probe_miss": int(miss.sum()),
            "rank_gap": max(float(rank.max()), 0.0), "dist_gap": float(dist.max())}
