"""The plain reference of a refined probed search: which rows the first stage
(the probed ADC top-(refine * k)) must hand to the re-rank and which it may,
and the exact squared L2 of each, decoded in float64 from the program's SQ8
store.

The first stage. Over the rows of the lists a query may probe
(`reference.ivf.Lists.sets`), each row's ADC distance is the interval
[lut + lo, lut + hi] of `reference.adc`. The program computes it in float32,
within `eps` = `ADC_EPS` x the query's summand magnitude of the float64
value. With r = refine * k, let T be the r-th least upper distance over the
rows of the lists the query must probe, and L the r-th least lower distance
over the rows of the lists it may probe. A row is a POSSIBLE candidate if it
lies in a possible list and its lower distance is at most T + 2 eps (a row
above that is beaten by r rows the program scans); it is a CERTAIN candidate
if it lies in a certain list and its upper distance plus 2 eps lies below L
(fewer than r rows can then beat it). This is `reference.ivf`'s
`COARSE_EPS` rule applied to ranks.

The re-rank. Each candidate's row is decoded from the program's store
(`data`, `off`, `scale`) in float64, and its exact squared L2 to the query
taken in float64. An answer must be a possible candidate (`cand_miss`); at
each rank its exact distance must be no worse than the float64 top-k among
the certain candidates (`rank_gap`); its distance must be its row's
(`dist_gap`); both as a share of the query's magnitude |q|^2 + |x|^2, x the
largest row among its candidates and answers.

The store itself (`store_bad`): its offset and scale against the float64
least value and range / 255 of the base vectors, and the codes of a sample
of base rows against their float64 quantization.

Plain torch: no kernel, no TF32, nothing of the program imported.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.adc import Searcher, _f64
from portbench.reference.ivf import Lists

# Relative slack on a first-stage (ADC) distance, as a share of the query's
# summand magnitude (`Searcher.scale`): the same 2e-5 that bounds the IVF
# and exhaustive cells' `rank_gap` and `dist_gap` (float32's worst error on
# a 128-term table entry is 7.6e-6 of it; their sound readings lie below
# 2e-7). Only loosens: a larger eps makes fewer rows certain, more possible.
ADC_EPS = 2e-5
# An SQ8 offset or scale may differ from its float64 value by f32 rounding:
# the least value is exact, the range over 255 is rounded twice (half an ulp,
# 2^-24 relative, each), so two ulps of room.
STORE_REL = 2.0 ** -22


class Store:
    """The program's SQ8 store as the reference reads it: the u8 codes
    `data` [n, d] (left on their device) and `off`, `scale` [d], in float64
    on `device`."""

    def __init__(self, data, off, scale, device):
        self.device = torch.device(device)
        self.data = data
        self.off = _f64(off, device)
        self.scale = _f64(scale, device)

    def decode(self, ids) -> torch.Tensor:
        """[r, d] float64 rows off + code x scale of ids [r]."""
        ids = torch.as_tensor(np.asarray(ids) if not isinstance(ids, torch.Tensor) else ids)
        rows = self.data[ids.to(self.data.device, torch.long)]
        return self.off + rows.to(self.device, torch.float64) * self.scale


def candidates(searcher: Searcher, lists: Lists, q, luts, nprobe: int, r: int):
    """(ids [c] int64 host, certain [c] bool, possible [c] bool) of one query
    q [1, d] with its float64 tables luts [1, m, h]: the rows of its possible
    lists, and which are certain and possible first-stage candidates."""
    certain_l, possible_l = lists.sets(q, nprobe)
    ids = lists.ids(possible_l[0])
    dev = searcher.device
    if ids.size == 0:
        none = torch.zeros(0, dtype=torch.bool, device=dev)
        return ids, none, none
    codes = torch.as_tensor(np.asarray(searcher.B)[ids]).to(dev, torch.long)
    lo, hi = searcher._rows(codes)
    lut = searcher._lutsum(luts, codes)[0]
    lo, hi = lut + lo, lut + hi
    eps = ADC_EPS * searcher.scale(luts)[0]
    in_certain = certain_l[0][lists.list_of[torch.as_tensor(ids, device=dev)]]
    hi_c = hi[in_certain]
    inf = torch.tensor(float("inf"), dtype=torch.float64, device=dev)
    T = torch.kthvalue(hi_c, r).values if hi_c.numel() >= r else inf
    L = torch.kthvalue(lo, r).values if lo.numel() >= r else inf
    return ids, in_certain & (hi + 2 * eps < L), lo <= T + 2 * eps


def judge(searcher: Searcher, lists: Lists, store: Store, Q, ids, dists, k: int,
          refine: int, nprobe: int) -> dict:
    """The comparison of one set of refined probed answers with the
    reference.

    Q [s, d] the queries; ids, dists [s, k] what the program answered.
    Returns {"bad_ids": queries with an id out of range, repeated, or
    without a finite distance, "cand_miss": answered rows that are not even
    possible candidates, "rank_gap": the largest amount, as a share of the
    query's magnitude, by which an answered row's exact distance lies above
    the float64 one at the same rank among the certain candidates,
    "dist_gap": the largest amount, likewise, by which an answered distance
    differs from its row's float64 distance}.
    """
    dev = searcher.device
    n = searcher.B.shape[0]
    ids = torch.as_tensor(np.asarray(ids)).to(dev, torch.long)
    dists = _f64(dists, dev)
    Q = _f64(Q, dev)
    valid = (ids >= 0) & (ids < n)
    srt = torch.sort(torch.where(valid, ids, -1 - torch.arange(
        ids.shape[1], device=dev)[None, :]), dim=1).values
    dup = (srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)
    ok = valid & torch.isfinite(dists)
    r = min(refine * k, n)
    luts = searcher.luts(Q)
    bad = int(((~ok).any(1) | dup.any(1)).sum())
    miss, rank_gap, dist_gap = 0, 0.0, 0.0
    for i in range(Q.shape[0]):
        q = Q[i:i + 1]
        cids, certain, possible = candidates(searcher, lists, q, luts[i:i + 1], nprobe, r)
        got = ids[i][ok[i]]
        x_c = store.decode(cids)
        x_a = store.decode(got)
        e_c = ((x_c - q) ** 2).sum(1)
        e_a = ((x_a - q) ** 2).sum(1)
        mag = (q * q).sum() + torch.cat([(x_c * x_c).sum(1), (x_a * x_a).sum(1),
                                         torch.zeros(1, dtype=torch.float64, device=dev)]).max()
        cid_t = torch.as_tensor(cids, device=dev)
        miss += int((~torch.isin(got, cid_t[possible])).sum())
        best = torch.sort(e_c[certain]).values[:k]
        best = torch.cat([best, torch.full((k - best.numel(),), float("inf"),
                                           dtype=torch.float64, device=dev)])
        # Ranks of the answered rows, in the program's order.
        at = torch.nonzero(ok[i]).flatten()
        if at.numel():
            rank_gap = max(rank_gap, float(((e_a - best[at]) / mag).max()))
            dist_gap = max(dist_gap, float(((dists[i][ok[i]] - e_a).abs() / mag).max()))
    return {"bad_ids": bad, "cand_miss": miss, "rank_gap": max(rank_gap, 0.0),
            "dist_gap": dist_gap}


def store_bad(store: Store, sample_ids, sample_rows, base_lo, base_hi) -> int:
    """The store's offset and scale entries that differ from the float64
    least value and range / 255 of the base (base_lo, base_hi [d]) by more
    than f32 rounding, plus the sampled rows (ids [s], their float64 values
    [s, d]) whose code differs by more than one step from the float64
    quantization round((x - lo) / scale), clipped to 0..255."""
    dev = store.device
    lo, hi = _f64(base_lo, dev), _f64(base_hi, dev)
    scale = (hi - lo) / 255.0
    bad = int(((store.off - lo).abs() > STORE_REL * lo.abs()).sum())
    bad += int(((store.scale - scale).abs() > STORE_REL * scale.abs()).sum())
    x = _f64(sample_rows, dev)
    want = torch.where(scale > 0, torch.round((x - lo) / torch.where(scale > 0, scale, 1.0)),
                       torch.zeros_like(x)).clamp(0, 255)
    sid = torch.as_tensor(np.asarray(sample_ids) if not isinstance(sample_ids, torch.Tensor)
                          else sample_ids)
    codes = store.data[sid.to(store.data.device, torch.long)].to(dev, torch.float64)
    return bad + int(((codes - want).abs() > 1).any(1).sum())
