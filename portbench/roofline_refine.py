"""The least time the card could take for a refined probed search, on the
yardstick of `roofline.py`: the probed first stage at k = refine * k
(`roofline_ivf.ivf_search_s`), then the exact re-rank of its candidates. It
counts the work, whatever implements it.
"""

from __future__ import annotations

from portbench.roofline import least_s
from portbench.roofline_ivf import ivf_search_s


def rerank_s(nq: int, c: int, d: int, k: int) -> float:
    """The re-rank of c candidate slots a query: for each, its d SQ8 bytes
    gathered and its 8-byte id read, and d subtractions, multiplications and
    adds; the [nq, k] f32 distances and int64 ids written once."""
    return least_s(3 * nq * c * d, nq * c * d + nq * c * 8 + nq * k * 12)


def refine_search_s(nq: int, nlist: int, d: int, rows: int, m: int, h: int, rk: int,
                    c: int, k: int) -> float:
    """nq queries probing lists that hold `rows` live rows in all: the first
    stage's least time at k = rk, plus the re-rank's of c candidates a query
    to k answers."""
    return ivf_search_s(nq, nlist, d, rows, m, h, rk) + rerank_s(nq, c, d, k)
