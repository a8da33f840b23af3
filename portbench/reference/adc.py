"""The plain reference of an additive-code search: exact ADC distances and
their top-k in float64, a block of rows at a time.

For a query q and a row with codes b_1..b_m, the distance the index ranks by
is  sum_i -2 q.C[i, b_i]  +  cbnorms[norm code],  the norm code being the
norm-codebook entry nearest to ||sum_i C[i, b_i]||^2. The reference works
the norm code out again from the codes in float64. Where a row's squared
norm lies within `NORM_EPS` (relative) of the midpoint between two entries,
a float32 computation may rightly pick either, so the row's distance is an
interval [lo, hi] over the entries it may take; elsewhere lo == hi.

Plain torch: no kernel, no TF32, nothing of the program imported.
"""

from __future__ import annotations

import numpy as np
import torch

# Relative slack on a squared norm within which two norm-codebook entries
# are equally near: a float32 norm of 7 summed 128-wide vectors is within
# about 1e-6 of the float64 one; 1e-5 leaves room and is 300 times below the
# gap between adjacent entries (about 3e-3 of the norm at h=256).
NORM_EPS = 1e-5
BLOCK = 1 << 19


def _f64(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x
                           ).to(device=device, dtype=torch.float64)


def norm_interval(sq: torch.Tensor, cbn: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(lo, hi) [n]: the least and the largest norm-codebook value a row of
    squared norm `sq` may take (cbn sorted ascending)."""
    h = cbn.shape[0]
    j = torch.searchsorted(cbn, sq).clamp(1, h - 1)
    below, above = cbn[j - 1], cbn[j]
    d_below, d_above = (sq - below).abs(), (above - sq).abs()
    slack = NORM_EPS * sq.abs()
    lo = torch.where(d_below <= d_above + slack, below, above)
    hi = torch.where(d_above <= d_below + slack, above, below)
    # sq beyond either end: the end entry alone.
    lo = torch.where(sq <= cbn[0], cbn[0], torch.where(sq >= cbn[-1], cbn[-1], lo))
    hi = torch.where(sq <= cbn[0], cbn[0], torch.where(sq >= cbn[-1], cbn[-1], hi))
    return lo, hi


class Searcher:
    """The reference over one index's state: codes B [n, m] (host), codebooks
    C [m, h, d] and norm codebook cbnorms [h], on `device` in float64."""

    def __init__(self, B, C, cbnorms, device):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.B = B
        self.device = torch.device(device)
        self.C = _f64(C, device)
        self.cbn = torch.sort(_f64(cbnorms, device)).values

    def _rows(self, codes: torch.Tensor):
        """The norm intervals (lo, hi) [r] of codes [r, m] on the device."""
        m = self.C.shape[0]
        rec = self.C[0][codes[:, 0]]
        for i in range(1, m):
            rec = rec + self.C[i][codes[:, i]]
        return norm_interval((rec * rec).sum(1), self.cbn)

    def luts(self, Q) -> torch.Tensor:
        """[s, m, h] float64 tables -2 q.C[i, c]."""
        return -2.0 * torch.einsum("sd,ihd->sih", _f64(Q, self.device), self.C)

    @staticmethod
    def _lutsum(luts: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
        """[s, r] sum_i luts[s, i, codes[r, i]]."""
        out = luts[:, 0, codes[:, 0]]
        for i in range(1, luts.shape[1]):
            out = out + luts[:, i, codes[:, i]]
        return out

    def topk_hi(self, luts: torch.Tensor, k: int) -> torch.Tensor:
        """[s, k] the k least upper distances over every row, ascending."""
        best = None
        n = self.B.shape[0]
        for s0 in range(0, n, BLOCK):
            codes = torch.as_tensor(np.asarray(self.B[s0:s0 + BLOCK])).to(
                self.device, torch.long)
            _, hi = self._rows(codes)
            d = self._lutsum(luts, codes) + hi[None, :]
            if best is not None:
                d = torch.cat([best, d], 1)
            best = torch.topk(d, min(k, d.shape[1]), dim=1, largest=False).values
        return best

    def at(self, luts: torch.Tensor, ids: torch.Tensor):
        """(lutsum, lo, hi) [s, k] of the rows `ids` [s, k] (valid ids only)."""
        n = self.B.shape[0]
        flat = ids.reshape(-1).clamp(0, n - 1).cpu().numpy()
        codes = torch.as_tensor(np.asarray(self.B)[flat]).to(self.device, torch.long)
        lo, hi = self._rows(codes)
        s, k = ids.shape
        codes = codes.reshape(s, k, -1)
        lut = torch.gather(luts[:, 0, :], 1, codes[:, :, 0])
        for i in range(1, luts.shape[1]):
            lut = lut + torch.gather(luts[:, i, :], 1, codes[:, :, i])
        return lut, lo.reshape(s, k), hi.reshape(s, k)

    def scale(self, luts: torch.Tensor) -> torch.Tensor:
        """[s] the summand magnitude of each query: its tables' largest
        entries plus the largest norm."""
        return luts.abs().amax(2).sum(1) + self.cbn.abs().max()


def judge(searcher: Searcher, Q, ids, dists, k: int) -> dict:
    """The comparison of one set of answers with the reference.

    Q [s, d] the queries; ids, dists [s, k] what the program answered.
    Returns {"bad_ids": rows with an id out of range or repeated,
    "rank_gap": the largest amount, as a share of the query's summand
    magnitude, by which an answered row's distance lies above the
    reference's distance at the same rank, "dist_gap": the largest amount,
    likewise, by which an answered distance lies outside the row's true
    distance}.
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
    t_hi = searcher.topk_hi(luts, k)
    lut, lo, hi = searcher.at(luts, ids)
    ok = valid & torch.isfinite(dists)
    rank = torch.where(ok, (lut + lo - t_hi) / scale, torch.zeros_like(dists))
    inside = torch.clamp(dists, lut + lo, lut + hi)
    dist = torch.where(ok, (dists - inside).abs() / scale, torch.zeros_like(dists))
    bad = (~ok).any(1) | dup.any(1)
    return {"bad_ids": int(bad.sum()),
            "rank_gap": max(float(rank.max()), 0.0),
            "dist_gap": float(dist.max())}
