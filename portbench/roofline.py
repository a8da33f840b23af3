"""The least time the card could take for the work of a window: the larger of
its operations at the float32 peak and its bytes at the memory rate.

One H100 SXM's published peaks (NVIDIA's data sheet, dense, at 700 W):
67 TFLOP/s in float32 outside the tensor cores, 3.35 TB/s of HBM. The
counts are those of the port's kernel table (PERF.md, section 6): every
input byte read once, every output byte written once, whatever a kernel
reads again.
"""

from __future__ import annotations

PEAK_F32 = 67e12
HBM = 3.35e12


def least_s(ops: float, nbytes: float) -> float:
    return max(ops / PEAK_F32, nbytes / HBM)


def scan_topk_s(nq: int, n: int, k: int, m: int, h: int, code_bytes: int = 1) -> float:
    """An exact ADC top-k of nq queries over n rows (K2's work): m adds and
    one compare a (query, row); the [nq, m, h] f32 tables, the [m, n] codes
    and the [n] f32 norms read once; the [nq, k] f32 distances and int32 ids
    written once."""
    return least_s(nq * n * (m + 1),
                   nq * m * h * 4 + m * n * code_bytes + 4 * n + nq * k * 8)


def ils_encode_s(n: int, m: int, h: int, rounds: int, icmiter: int = 4,
                 npert: int = 4) -> float:
    """An ILS encode of n rows (K1's work): each of `rounds` rounds makes
    icmiter * m visits a row, a visit scoring h candidates with m - 1 adds
    and one compare each; the [n, m, h] f32 unaries, the [m, m, h, h] f32
    pair table, the codes (read and written), the squared norms and costs,
    each round's perturbation keys and codes and its visit order read or
    written once. Every visit is counted: K1 skips visits whose inputs did
    not change, so this is the most the algorithm asks, not what the inputs
    need (PERF.md)."""
    visits = n * rounds * icmiter * m
    nbytes = (n * m * h * 4 + m * m * h * h * 4 + 2 * n * m * 4 + n * 4 * 2
              + rounds * n * (m + npert) * 4 + rounds * m * 4)
    return least_s(visits * h * m, nbytes)
