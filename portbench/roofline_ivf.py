"""The least time the card could take for a probed (IVF) search, on the
yardstick of `roofline.py` (67 TFLOP/s in float32, 3.35 TB/s of HBM): the
work of the search, whatever implements it.
"""

from __future__ import annotations

from portbench.roofline import least_s


def ivf_search_s(nq: int, nlist: int, d: int, rows: int, m: int, h: int, k: int) -> float:
    """nq queries probing lists that hold `rows` live rows in all (summed
    over the queries): the coarse scores' nq * nlist * d multiply-adds (2
    operations each) and the [nlist, d] f32 centroids read once; for each
    live probed row, m adds and one compare, its m code bytes and its 4-byte
    norm term read; the [nq, m, h] f32 tables read once and the [nq, k] f32
    distances and int32 ids written once."""
    return least_s(2 * nq * nlist * d + rows * (m + 1),
                   nlist * d * 4 + rows * (m + 4) + nq * m * h * 4 + nq * k * 8)
