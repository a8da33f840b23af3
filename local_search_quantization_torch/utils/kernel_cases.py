"""Every C entry point of `csrc/` that launches a kernel, as small cases.

    python -m local_search_quantization_torch.utils.kernel_cases [--device cuda|cpu]
        [--fill none|nan|zero|ones[,...]] [--only TEXT]

A case makes its inputs with numpy from a seed, calls the kernel's wrapper
and its plain PyTorch version on the same tensors, and compares the two as
chip_smoke.py and tests/test_torch_kernels_gpu.py do: bit for bit, or within
the tolerance they state. The cases are the edge shapes those name, kept
small (n <= 50,000 rows, nq <= 64, but for the coarse probes' batches of
1000 queries over at most 1,024 lists) so that a run under compute-sanitizer
ends:

- K1, K5/K6 and K7: the lane maps m=5 at h=40 (idle lanes),
  h=300 (one element a lane, a masked tail) and h=512 (two loads a row),
  the SIFT map m=7 at h=256, n no multiple of a block, milestones and stats
  on and off;
- the scans: a ragged base of 30,007 rows with deleted rows (+inf extra),
  uint8 and int32 codes, nq 1 and 33, k=1 and k >= n where the wrapper
  takes it, K2's certificate failing for one query (the dense rerun), K2's
  dense path with a tie block at the k-th distance across a segment edge,
  K4 with a cap that overflows, and the L2 probe;
- the IVF probed scan: ragged and empty lists, -1 probe slots, tombstoned
  rows, no extra (a PQ store), fewer candidates than k, one query over
  every list, each k capacity, one slice a query and many (the merge);
- the IVF coarse probes: the kernel at nq 1, 7 and 1000, nlist 256, 500
  (one chunk), 1000, 1001 (no multiple of 4: element-wise staging), 1024
  and 16,384, d 32, 100 and 128, nprobe 1, 8 and 20 (P = 32) and 64 (the
  largest it serves); integer data,
  whose scores are exact in f32 and tie often (ids identical to the plain
  version's), continuous data with duplicated centroids (`_probes_compare`:
  the near ties by the certain and possible sets, the exact ties to the
  lower id), a list whose score is not finite and a query whose scores are
  all not finite (+inf, -inf, NaN); and the shapes it leaves to the torch
  form (d 960, nprobe 65, 1024, 2048 and nlist), judged by the sets alone
  (`torch.topk` orders exact ties as it likes).

The wrappers run on the card unless given `--device cpu`; on the CPU they
take their plain versions, so only the plain halves run. The run stops with
exit code 1 at the first mismatch; a clean run's last line is
"kernel_cases: all N cases passed on DEVICE (L kernel launches, fill F)".

`--fill` sets what memory a kernel finds that it did not write (a comma
list runs every case once under each, in turn):
"nan" runs in PyTorch's deterministic mode with
`torch.utils.deterministic.fill_uninitialized_memory`, so every
`torch.empty` holds NaN or the largest integer; "zero" and "ones" (on the
card) fill the caching allocator's free memory with 0x00 or 0xFF bytes
before each case and give each input as the head of an allocation whose
4 KiB tail holds the same bytes, which must hold them still after the case. A kernel that reads a
slot nobody wrote, or past an input's end, then gives another answer under
one of the fills than its plain version.

`sanitize(tool)` runs this module on the card under one compute-sanitizer
tool (memcheck, racecheck, initcheck, synccheck), with PyTorch's caching
allocator off so that every tensor is an allocation of its own, and reads
the tool's verdict.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
import time
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
import torch.utils.deterministic

from local_search_quantization_torch import _build
from local_search_quantization_torch import ivf
from local_search_quantization_torch.ops import icm_kernels as ik
from local_search_quantization_torch.ops import l2_probe, launch_counts
from local_search_quantization_torch.ops import luts as _luts
from local_search_quantization_torch.ops import select_kernels as sk

FILLS = ("none", "nan", "zero", "ones")
_GUARD_BYTES = 4096
# Poison for the allocator's free memory: its small pool (blocks up to 1 MiB,
# carved from 2 MiB segments) and its large pool.
_POISON_SMALL, _POISON_LARGE = 64, 512 << 20


@dataclass(frozen=True)
class Case:
    """One call of a kernel's wrapper against its plain version.

    entries: the C entry points the call reaches (none where the wrapper
    must leave the shape to its torch form); params: the values it
    passes for the entry's switches ({"variant": 3}, {"code_bytes": 1},
    ...), so that the catalogue's coverage can be checked against the
    sources. make(device) -> the inputs (a tuple); kernel(inputs) and
    plain(inputs) -> the outputs; compare(got, want, inputs) -> None, or
    what differs.
    """

    name: str
    entries: tuple[str, ...]
    params: dict
    make: Callable
    kernel: Callable
    plain: Callable
    compare: Callable


def _same(got, want, inputs=None):
    """Every output identical (None where the other is None)."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for k, (g, w) in enumerate(zip(got, want)):
        if (g is None) != (w is None):
            return f"output {k}: {g is None=} but {w is None=}"
        if g is not None and not (g.shape == w.shape and g.dtype == w.dtype
                                  and torch.equal(g, w)):
            bad = "shape/dtype" if g.shape != w.shape or g.dtype != w.dtype else \
                int((g != w).sum())
            return f"output {k} differs ({bad} elements)"
    return None


# ---------------------------------------------------------------------------
# The ICM kernels.


def _icm_data(rng, n, d, m, h, integer):
    if integer:
        X = rng.integers(-3, 4, (n, d)).astype(np.float32)
        C = rng.integers(-1, 2, (m, h, d)).astype(np.float32)
    else:
        X = rng.normal(size=(n, d)).astype(np.float32) * 10
        C = rng.normal(size=(m, h, d)).astype(np.float32) * 3
    return X, C


def _k1_make(n, d, m, h, R, npert, integer, seed):
    def make(dev):
        rng = np.random.default_rng(seed)
        X, C = (torch.as_tensor(a, device=dev) for a in _icm_data(rng, n, d, m, h, integer))
        return (_luts.get_unaries(X, C), _luts.get_binaries(C), (X * X).sum(-1),
                torch.as_tensor(rng.integers(0, h, (n, m), dtype=np.int32), device=dev),
                torch.as_tensor(np.stack([rng.permutation(m) for _ in range(R)])
                                .astype(np.int32), device=dev),
                torch.as_tensor(rng.random((R, n, m), dtype=np.float32), device=dev),
                torch.as_tensor(rng.integers(0, h, (R, n, npert), dtype=np.int32),
                                device=dev))
    return make


def _k1(label, n, d, m, h, R, npert, integer, milestones, stats, seed):
    kw = dict(icmiter=2, milestones=milestones, with_stats=stats)
    return Case(f"K1 {label}", ("lsq_ils_encode",), {},
                _k1_make(n, d, m, h, R, npert, integer, seed),
                lambda a: ik.ils_encode_streamed(*a, **kw),
                lambda a: ik.ils_encode_streamed_reference(*a, **kw), _same)


def _sweeps_make(n, d, m, h, integer, seed):
    def make(dev):
        rng = np.random.default_rng(seed)
        X, C = (torch.as_tensor(a, device=dev) for a in _icm_data(rng, n, d, m, h, integer))
        return (torch.as_tensor(rng.integers(0, h, (n, m), dtype=np.int32), device=dev),
                _luts.get_unaries(X, C), _luts.get_binaries(C).to(torch.bfloat16),
                torch.as_tensor(rng.permutation(m).astype(np.int32), device=dev))
    return make


def _sweeps(variant, label, n, d, m, h, integer, seed):
    kw = dict(icmiter=2, variant=variant)
    return Case(f"K{5 if variant == 'v2' else 6} {label}", (f"lsq_icm_sweeps_{variant}",), {},
                _sweeps_make(n, d, m, h, integer, seed),
                lambda a: ik.fused_icm_sweeps(*a, **kw),
                lambda a: ik.fused_icm_sweeps_reference(*a, **kw), _same)


def _k7_compare(variant):
    def compare(got, want, inputs):
        if not torch.equal(got[0], want[0]):
            return f"codes differ in {int((got[0] != want[0]).sum())} places"
        if variant in ("noargmin", "mmonly"):  # score sums, in the kernel's order
            tol = 1e-5 * float(want[1].abs().mean())
            if not torch.allclose(got[1], want[1], rtol=1e-5, atol=tol):
                return f"sink beyond 1e-5: max diff {float((got[1] - want[1]).abs().max())}"
            return None
        return _same(got[1], want[1])
    return compare


def _k7(variant, label, n, d, m, h, integer, seed):
    kw = dict(icmiter=2, variant=variant)
    return Case(f"K7 {variant} {label}", ("lsq_icm_sweeps_dissect",),
                {"variant": ik.DISSECT_VARIANTS.index(variant)},
                _sweeps_make(n, d, m, h, integer, seed),
                lambda a: ik.icm_sweeps_dissect(*a, **kw),
                lambda a: ik.icm_sweeps_dissect_reference(*a, **kw), _k7_compare(variant))


# ---------------------------------------------------------------------------
# The scans.

_N = 30_007  # a ragged base: no multiple of a tile, a warp or 16 bytes
_DELETED = 300


def _scan_data(dev, n, nq, m, h, seed, deleted):
    """Integer LUTs (tie-heavy distances), codes [m, n] int32, extra in
    [0, 3) with `deleted` rows at +inf."""
    rng = np.random.default_rng(seed)
    lut = torch.as_tensor(rng.integers(-4, 5, (nq, m, h)).astype(np.float32), device=dev)
    B = rng.integers(0, h, (n, m), dtype=np.int32)
    extra = rng.integers(0, 3, n).astype(np.float32)
    if deleted:
        extra[rng.choice(n, deleted, replace=False)] = np.inf
    return lut, torch.as_tensor(B.T.copy(), device=dev), torch.as_tensor(extra, device=dev)


def _kth_t0(lut, Bt, extra, rank):
    """Each query's rank-th smallest distance (1-based) as a [nq, 1] bound."""
    d, _ = sk.scan_select_reference(lut, Bt, extra, rank)
    return d[:, rank - 1:rank].contiguous()


def _scan_make(n, nq, m, h, dtype, seed, deleted=_DELETED, t0_rank=None):
    """(lut, Bt, extra[, t0]) with Bt in `dtype`; t0 the t0_rank-th distance."""
    def make(dev):
        lut, Bt, extra = _scan_data(dev, n, nq, m, h, seed, deleted)
        out = (lut, Bt.to(dtype).contiguous(), extra)
        return out if t0_rank is None else out + (_kth_t0(lut, Bt, extra, t0_rank),)
    return make


def _code_bytes(dtype):
    return {torch.uint8: 1, torch.int32: 4}[dtype]


def _k2_dense(label, n, nq, m, h, dtype, k, seed, deleted=_DELETED):
    return Case(f"K2 dense {label}", ("lsq_scan_topk",), {"code_bytes": _code_bytes(dtype)},
                _scan_make(n, nq, m, h, dtype, seed, deleted),
                lambda a: sk.scan_topk(*a, k), lambda a: sk.scan_topk_reference(*a, k), _same)


def _tie_edge_make(n, nq, m, h, edge, ties, seed):
    """Tie-heavy scan inputs whose smallest distance is shared by the `ties`
    rows from edge - ties // 2 on (same codes, extra -100; every other row's
    extra is 50): the tie block straddles row `edge`."""
    def make(dev):
        lut, Bt, _ = _scan_data(dev, n, nq, m, h, seed, 0)
        lo = edge - ties // 2
        Bt[:, lo:lo + ties] = Bt[:, lo:lo + 1]
        extra = torch.full((n,), 50.0, device=dev)
        extra[lo:lo + ties] = -100.0
        return lut, Bt.to(torch.uint8).contiguous(), extra
    return make


def _k2_dense_tie_edge():
    """Few queries over one-tile segments (`sk.dense_segments`: 4096 rows
    each here), k inside a tie block that straddles the edge at row 4096:
    the lowest ids of the block, across the edge."""
    k = 9
    return Case(f"K2 dense n={_N} nq=3 uint8 k={k}, a tie block across a segment edge",
                ("lsq_scan_topk",), {"code_bytes": 1},
                _tie_edge_make(_N, 3, 7, 256, sk._DENSE_TILE, 12, 44),
                lambda a: sk.scan_topk_dense(*a, k), lambda a: sk.scan_topk_reference(*a, k),
                _same)


def _sorted_keys(cand, count, cap, q):
    f = min(int(count[q]), cap)
    return torch.sort(cand[q, :f] ^ sk._SIGN64).values ^ sk._SIGN64


def _k2_filter_compare(got, want, inputs):
    lut, Bt, extra, t0 = inputs
    (cand, count), (want_c, want_n) = got, want
    if not torch.equal(count, want_n):
        return "counts differ"
    cap = want_c.shape[1]
    for q in range(count.shape[0]):
        keys = _sorted_keys(cand, count, cap, q)
        if count[q] <= cap:
            if not torch.equal(keys, _sorted_keys(want_c, want_n, cap, q)):
                return f"query {q}: other keys"
            continue
        # Overflow: cap distinct keys of rows below t0, in no fixed order.
        ids = (keys & 0xFFFFFFFF).long()
        dist = sk.lut_scan_block(lut[q:q + 1], Bt[:, ids], extra[ids])[0]
        if (torch.unique(ids).numel() != cap or not bool((dist < t0[q]).all())
                or not torch.equal(sk._unmono((keys >> 32) & 0xFFFFFFFF), dist)):
            return f"query {q}: overflowed keys are not {cap} distinct rows below t0"
    return None


def _k2_filter(label, nq, dtype, rank, cap, seed):
    return Case(f"K2 filter {label}", ("lsq_k2_filter",), {"code_bytes": _code_bytes(dtype)},
                _scan_make(_N, nq, 7, 256, dtype, seed, t0_rank=rank),
                lambda a: sk.k2_filter(*a, cap),
                lambda a: sk.k2_filter_reference(*a, cap), _k2_filter_compare)


def _k2_select_make(nq, cap, seed):
    def make(dev):
        rng = np.random.default_rng(seed)
        d = torch.as_tensor(rng.integers(-50, 50, (nq, cap)).astype(np.float32), device=dev)
        ids = torch.as_tensor(np.stack([rng.permutation(10 * cap)[:cap] for _ in range(nq)]),
                              device=dev)
        count = rng.integers(0, 2 * cap + 2, nq).astype(np.int32)
        count[0] = cap  # full, and below k where cap < k
        return sk._k2_keys(d, ids), torch.as_tensor(count, device=dev)
    return make


def _k2_select(nq, cap, k, seed):
    return Case(f"K2 select nq={nq} cap={cap} k={k}", ("lsq_k2_select",), {},
                _k2_select_make(nq, cap, seed),
                lambda a: sk.k2_select(*a, k, cap),
                lambda a: sk.k2_select_reference(*a, k, cap), _same)


def _k2_staged(a, *, filt, select, dense, k):
    """K2's staged path with a pre-scan whose bound for query 0 is its
    (k/2)-th distance: too tight, so its certificate fails and it reruns
    dense. Returns (dists, ids, queries rerun)."""
    def prescan(luts, Bt, extra, kk):
        t0, cap = sk.warm_bound(luts, Bt, extra, k=kk, variant="sorted")
        t0[0] = _kth_t0(luts[:1], Bt, extra, kk // 2)[0]
        return t0, cap
    d, i, failed = sk.k2_staged(*a, k, prescan=prescan, filt=filt, select=select,
                                dense=dense, chunk=a[0].shape[0])
    return d, i, torch.tensor([failed])


def _k2_certificate_case():
    k = 300
    return Case("K2 staged n=30007 nq=33 uint8 k=300, query 0's certificate fails (dense rerun)",
                ("lsq_k2_filter", "lsq_k2_select", "lsq_scan_topk", "lsq_select_topk"),
                {"code_bytes": 1}, _scan_make(_N, 33, 7, 256, torch.uint8, 14),
                lambda a: _k2_staged(a, filt=sk.k2_filter, select=sk.k2_select,
                                     dense=sk.scan_topk_dense, k=k),
                lambda a: sk.scan_topk_reference(*a, k) + (torch.tensor([1]),), _same)


def _k3_compare(unsorted, k):
    def compare(got, want, inputs):
        kk = got[0].shape[1]
        if kk != min(k, inputs[1].shape[1]):
            return f"{kk} columns"
        if not torch.equal(got[0], want[0][:, :kk]):
            return "dists differ"
        if not unsorted:
            return None if torch.equal(got[1], want[1][:, :kk]) else "ids differ"
        # "unsorted" is value-exact; its ids are free within a tie block
        # across the k-th value.
        if kk < want[0].shape[1]:
            cert = want[0][:, kk - 1] < want[0][:, kk]
            if not torch.equal(got[1][cert], want[1][cert, :kk]):
                return "ids differ where the k-th value is not tied"
        return None
    return compare


def _k3(label, n, nq, m, h, dtype, k, unsorted, warm_rank, seed, deleted=_DELETED):
    def kernel(a):
        return sk.scan_select(*a[:3], k, a[3] if warm_rank else None, unsorted=unsorted)

    def plain(a):
        return sk.scan_select_reference(*a[:3], min(a[1].shape[1], k + 1),
                                        a[3] if warm_rank else None)
    kind = "unsorted" if unsorted else "sorted"
    return Case(f"K3 {kind} {label}", ("lsq_select_topk",),
                {"code_bytes": _code_bytes(dtype), "lex": int(not unsorted)},
                _scan_make(n, nq, m, h, dtype, seed, deleted, warm_rank),
                kernel, plain, _k3_compare(unsorted, k))


def _k4_compare(got, want, inputs):
    lut, Bt, extra, t0 = inputs
    (ids, count), (want_ids, want_count) = got, want
    cap = want_ids.shape[1]
    if not torch.equal(count, want_count):
        return "counts differ"
    all_ids, _ = sk.scan_key_reference(lut, Bt, extra, t0, Bt.shape[1])
    filled = torch.clamp(count, max=cap)
    for q in range(ids.shape[0]):
        f = int(filled[q])
        kept = torch.sort(ids[q, :f])[0]
        if not bool((ids[q, f:] == -1).all()):
            return f"query {q}: slots past the hits are not -1"
        if count[q] <= cap:
            if not torch.equal(kept, want_ids[q, :f]):
                return f"query {q}: other ids"
        elif not (bool(torch.isin(kept, all_ids[q, :int(count[q])]).all())
                  and torch.unique(kept).numel() == cap):
            return f"query {q}: overflowed ids are not {cap} distinct hits"
    return None


def _k4(label, n, nq, m, h, dtype, rank, cap, seed):
    return Case(f"K4 {label}", ("lsq_scan_key",), {"code_bytes": _code_bytes(dtype)},
                _scan_make(n, nq, m, h, dtype, seed, n // 50, rank),
                lambda a: sk.scan_key(*a, cap),
                lambda a: sk.scan_key_reference(*a, cap), _k4_compare)


def _key_route(k, cap):
    """The key route: K4's appends re-ranked, sorted and certified; its plain
    half is the same route on CPU copies, which runs K4's plain version."""
    def route(a):
        return sk.fused_scan_topk(*a[:3], k=k, t0=a[3], variant="key", append_cap=cap)

    def plain(a):
        d, i, bad = route(tuple(t.cpu() for t in a))
        return d.to(a[0].device), i.to(a[0].device), bad.to(a[0].device)
    return Case(f"K4 key route n=30007 nq=33 uint8 k={k} cap={cap}", ("lsq_scan_key",),
                {"code_bytes": 1}, _scan_make(_N, 33, 7, 256, torch.uint8, 15, t0_rank=2 * k),
                route, plain, _same)


def _ivf_store(rng, sizes, m, h, extra, dead=0):
    """A grouped store as `ivf.IVFPartition` lays it out, as numpy: lists
    of `sizes` live rows, each padded to 64; codes [n_g, m] uint8 below h;
    order a permutation of the live ids (-1 on pads); extra "norms"
    (integers in [0, 3), so distances tie), "none" (a PQ store) or with
    `dead` live rows tombstoned (+inf). Returns (starts [nlist + 1], lives,
    codes_g, extra_g or None, order)."""
    lives = np.asarray(sizes, np.int64)
    starts = ivf._padded_starts(lives)
    n_g, n = int(starts[-1]), int(lives.sum())
    live_pos = np.concatenate([np.arange(starts[i], starts[i] + lives[i])
                               for i in range(lives.size)]).astype(np.int64)
    order = np.full(n_g, -1, np.int64)
    order[live_pos] = rng.permutation(n)
    codes = np.zeros((n_g, m), np.uint8)
    codes[live_pos] = rng.integers(0, h, (n, m))
    if extra == "none":
        return starts, lives, codes, None, order
    extra_g = np.zeros(n_g, np.float32)
    extra_g[live_pos] = rng.integers(0, 3, n)
    extra_g[rng.choice(live_pos, dead, replace=False)] = np.inf
    return starts, lives, codes, extra_g, order


def _ivf_make(sizes, nq, p, m, h, extra, dead, unused, seed):
    """Inputs of `ivf.ivf_scan`: integer tables (tie-heavy distances),
    each query's p distinct lists with `unused` slots -1, and the store of
    `_ivf_store`."""
    def make(dev):
        rng = np.random.default_rng(seed)
        starts, lives, codes, extra_g, order = _ivf_store(rng, sizes, m, h, extra, dead)
        probes = np.stack([rng.permutation(len(sizes))[:p] for _ in range(nq)])
        for row in probes:
            row[rng.choice(p, unused, replace=False)] = -1
        def t(a):
            return torch.as_tensor(a, device=dev)
        luts = t(rng.integers(-4, 5, (nq, m, h)).astype(np.float32))
        return (luts, t(probes), t(starts[:-1].copy()), t(lives),
                t(np.ascontiguousarray(codes.T)), None if extra_g is None else t(extra_g),
                t(order), float(lives.mean()))
    return make


def _ivf(label, sizes, nq, p, m, h, k, extra="norms", dead=0, unused=0, seed=0):
    def plain(a):
        luts, probes, starts, lives, codesT, extra_g, order, _ = a
        return ivf.ivf_scan_reference(luts, k, probes, starts, lives, codesT.t(), extra_g,
                                      order)
    return Case(f"IVF scan {label}", ("lsq_ivf_scan",), {"kcap": ivf.ivf_kcap(k)},
                _ivf_make(sizes, nq, p, m, h, extra, dead, unused, seed),
                lambda a: ivf.ivf_scan(a[0], k, *a[1:]), plain, _same)


def _ragged(seed, nlist, lo, hi, empty, big):
    """List sizes in [lo, hi) with `empty` lists of 0 rows and one of `big`."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(lo, hi, nlist)
    sizes[rng.choice(nlist, empty, replace=False)] = 0
    sizes[np.argmax(sizes)] = big
    return sizes


# The slack on a coarse score: an f32 dot product of d terms is within d *
# 2^-24 of the exact one, relative to |q| |c|, so two lists' order may flip
# within twice that; never below the benchmark reference's 2e-5, which is
# that bound at d = 128 (portbench/reference/ivf.py `COARSE_EPS`).
def _coarse_eps(d: int) -> float:
    return max(2e-5, d * 2.0 ** -23)


def _probes_make(nq, nlist, d, integer, seed, inf_list=None, inf_query=None):
    """Inputs of `ivf.ivf_probes`: queries Q [nq, d], the centroids
    transposed [d, nlist] and their squared norms. Integer data lies in
    [-8, 8] (every score exact in f32, ties everywhere); continuous data is
    normal, with every 20th list from the 10th a copy of a lower one and
    query 0 on the first copy, so that its two nearest lists tie exactly.
    `inf_list`: a list with an infinite coordinate (its score not finite);
    `inf_query`: a query with an infinite coordinate (its scores -inf, +inf
    or NaN, by the sign of the lists' coordinate)."""
    def make(dev):
        rng = np.random.default_rng(seed)
        if integer:
            C = rng.integers(-8, 9, (nlist, d)).astype(np.float32)
            Q = rng.integers(-8, 9, (nq, d)).astype(np.float32)
        else:
            C = (rng.normal(size=(nlist, d)) * 10).astype(np.float32)
            Q = (rng.normal(size=(nq, d)) * 10).astype(np.float32)
            dup = np.arange(10, nlist, 20)
            C[dup] = C[(rng.random(dup.size) * dup).astype(np.int64)]
            Q[0] = C[dup[0]]
        if inf_list is not None:
            C[inf_list, 0] = np.inf
        if inf_query is not None:
            Q[inf_query, 0] = np.inf
        return (torch.as_tensor(Q, device=dev), torch.as_tensor(np.ascontiguousarray(C.T),
                                                                device=dev),
                torch.as_tensor((C * C).sum(1), device=dev))
    return make


def _group_ranks(CT):
    """(group [nlist], rank [nlist]): the group of lists with identical
    centroids each list is in, and its rank by id within the group."""
    nlist = CT.shape[1]
    _, group = torch.unique(CT.t(), dim=0, return_inverse=True)
    order = torch.argsort(group * nlist + torch.arange(nlist, device=CT.device))
    gs = group[order]
    rank = torch.empty(nlist, dtype=torch.int64, device=CT.device)
    rank[order] = _run_index(gs[None])[0]
    return group, rank


def _run_index(g):
    """Each element's index within its run of equal neighbours, row by row."""
    idx = torch.arange(g.shape[1], device=g.device).expand_as(g)
    start = torch.ones_like(g, dtype=torch.bool)
    start[:, 1:] = g[:, 1:] != g[:, :-1]
    return idx - torch.cummax(torch.where(start, idx, 0), dim=1).values


def _probes_compare(exact, ties=True):
    """The kernel's probes against the plain version's. exact (integer
    data, exact scores): identical. Else judged as the benchmark reference
    judges a probe set: with s the exact (f64) scores, t each query's
    nprobe-th least and eps_q = `_coarse_eps`(d) (|c|max^2 + 2 |q| |c|max),
    every list below t - eps_q returned, none above t + eps_q, and where the
    ids differ from the plain version's their scores within eps_q; with
    `ties`, lists with identical centroids (an exact tie) in order of id,
    the lowest kept."""
    def compare(got, want, inputs):
        if got.shape != want.shape or got.dtype != torch.int64:
            return f"shape/dtype {tuple(got.shape)} {got.dtype}"
        if torch.equal(got, want):
            return None
        if exact:
            return f"ids differ in {int((got != want).sum())} slots (exact integer scores)"
        Q, CT, cn = (t.double() for t in inputs)
        nlist = cn.shape[0]
        if bool(((got < 0) | (got >= nlist)).any()):
            return "an id out of range"
        srt = torch.sort(got, dim=1).values
        if bool((srt[:, 1:] == srt[:, :-1]).any()):
            return "a list returned twice"
        s = cn[None, :] - 2.0 * (Q @ CT)
        t = torch.topk(s, got.shape[1], dim=1, largest=False).values[:, -1:]
        cmax = CT.norm(dim=0).max()
        eps = _coarse_eps(CT.shape[0]) * (cmax * cmax + 2.0 * Q.norm(dim=1, keepdim=True) * cmax)
        taken = torch.zeros_like(s, dtype=torch.bool).scatter_(1, got, True)
        if bool((~taken & (s < t - eps)).any()):
            return "a certain list is missing"
        if bool((taken & (s > t + eps)).any()):
            return "a list outside the possible set"
        if bool(((got != want) & ((s.gather(1, got) - s.gather(1, want)).abs() > eps)).any()):
            return "ids out of the plain version's order beyond eps_q"
        if not ties:
            return None
        group, rank = _group_ranks(inputs[1])
        g = group[got]
        order = torch.argsort(g * nlist + got, dim=1)
        gs = torch.gather(g, 1, order)
        same = gs[:, 1:] == gs[:, :-1]
        if bool((same & (order[:, 1:] < order[:, :-1])).any()):
            return "an exact tie out of id order"
        if bool((rank[torch.gather(got, 1, order)] != _run_index(gs)).any()):
            return "an exact tie kept a higher id"
        return None
    return compare


def _probes(label, nq, nlist, d, nprobe, integer, seed, inf_list=None, inf_query=None):
    """A case the kernel serves (nprobe <= 64, d <= 128)."""
    return Case(f"IVF probes {label}", ("lsq_ivf_probes",), {},
                _probes_make(nq, nlist, d, integer, seed, inf_list, inf_query),
                lambda a: ivf.ivf_probes(*a, nprobe),
                lambda a: ivf.coarse_probes_reference(*a, nprobe), _probes_compare(integer))


def _probes_wide(label, nq, nlist, d, nprobe, seed):
    """A shape the kernel leaves to the torch form, on continuous data with
    duplicated lists: the probe sets judged, not the order of exact ties."""
    return Case(f"IVF probes {label}", (), {}, _probes_make(nq, nlist, d, False, seed),
                lambda a: ivf.ivf_probes(*a, nprobe),
                lambda a: ivf.coarse_probes_reference(*a, nprobe), _probes_compare(False, False))


def _l2(dtype, wide):
    elems = 512 // torch.tensor([], dtype=dtype).element_size()

    def make(dev):
        rng = np.random.default_rng(elems + wide)
        return (torch.as_tensor(rng.integers(-2, 3, (1024, elems)).astype(np.float32),
                                device=dev).to(dtype),)
    kw = dict(warps=256, rows_per_warp=8, seed=5)
    return Case(f"L2 probe {str(dtype)[6:]} wide={int(wide)}", ("lsq_l2_gather",),
                {"elem_bytes": 512 // elems, "wide": int(wide)}, make,
                lambda a: l2_probe.l2_gather(*a, wide=wide, **kw),
                lambda a: l2_probe.l2_gather_reference(*a, **kw), _same)


CASES: tuple[Case, ...] = (
    _k1("m=5 h=40 n=1001 milestones (1, 3) stats", 1001, 16, 5, 40, 3, 3, False, (1, 3), True, 1),
    _k1("m=5 h=300 n=515", 515, 16, 5, 300, 2, 2, False, (), False, 2),
    _k1("m=5 h=512 n=258 milestones (2,) stats", 258, 16, 5, 512, 2, 2, False, (2,), True, 3),
    _k1("m=7 h=256 n=2050 integer milestones (1, 2)", 2050, 32, 7, 256, 2, 4, True, (1, 2),
        False, 4),
    _k1("m=4 h=20 n=3001 stats", 3001, 16, 4, 20, 2, 2, False, (), True, 5),
    _sweeps("v2", "m=5 h=40 n=1001", 1001, 16, 5, 40, False, 6),
    _sweeps("v2", "m=5 h=300 n=515", 515, 16, 5, 300, False, 7),
    _sweeps("v2", "m=5 h=512 n=258", 258, 16, 5, 512, False, 8),
    _sweeps("v2", "m=7 h=256 n=4097 integer", 4097, 32, 7, 256, True, 9),
    _sweeps("v1", "m=5 h=40 n=1001", 1001, 16, 5, 40, False, 6),
    _sweeps("v1", "m=7 h=256 n=2050 integer", 2050, 32, 7, 256, True, 10),
    *(_k7(v, "m=7 h=256 n=1030 integer", 1030, 32, 7, 256, True, 11)
      for v in ik.DISSECT_VARIANTS),
    _k7("full", "m=5 h=40 n=1001", 1001, 16, 5, 40, False, 12),
    _k7("mmonly", "m=5 h=40 n=1001", 1001, 16, 5, 40, False, 12),
    _k2_dense("n=30007 nq=33 uint8 k=100", _N, 33, 7, 256, torch.uint8, 100, 21),
    _k2_dense("n=30007 nq=33 int32 k=1", _N, 33, 7, 256, torch.int32, 1, 22),
    _k2_dense("n=30007 nq=1 uint8 k=40000 (k >= n)", _N, 1, 7, 256, torch.uint8, 40_000, 23),
    _k2_dense("m=3 h=300 n=1000 nq=2 int32 k=1000 (k == n)", 1000, 2, 3, 300, torch.int32,
              1000, 24, 0),
    _k2_dense_tie_edge(),
    _k2_filter("n=30007 nq=33 uint8 rank=700 cap=1024", 33, torch.uint8, 700, 1024, 25),
    _k2_filter("n=30007 nq=33 int32 rank=700 cap=256 (overflow)", 33, torch.int32, 700, 256,
               26),
    _k2_filter("n=30007 nq=1 uint8 rank=50 cap=2688", 1, torch.uint8, 50, 2688, 27),
    _k2_select(7, 100, 30, 28),
    _k2_select(3, 1, 1, 29),
    _k2_select(33, 2688, 1000, 30),
    _k2_certificate_case(),
    _k3("n=30007 nq=33 uint8 k=100", _N, 33, 7, 256, torch.uint8, 100, False, None, 31),
    _k3("n=30007 nq=33 int32 k=100", _N, 33, 7, 256, torch.int32, 100, True, None, 32),
    _k3("warm t0 n=30007 nq=1 uint8 k=1", _N, 1, 7, 256, torch.uint8, 1, False, 3, 33),
    _k3("warm t0 n=30007 nq=33 uint8 k=1000", _N, 33, 7, 256, torch.uint8, 1000, True, 1507,
        34),
    _k3("n=300 nq=3 uint8 k=1000 (k >= n)", 300, 3, 7, 256, torch.uint8, 1000, False, None, 35),
    _k3("m=3 h=300 n=3000 nq=2 int32 k=500", 3000, 2, 3, 300, torch.int32, 500, False, None,
        36, 0),
    _k3("m=16 n=20000 nq=64 uint8 k=300", 20_000, 64, 16, 256, torch.uint8, 300, False, None,
        37),
    _k4("n=30007 nq=33 uint8 rank=700 cap=2048", _N, 33, 7, 256, torch.uint8, 700, 2048, 41),
    _k4("n=30007 nq=1 int32 rank=700 cap=256 (overflow)", _N, 1, 7, 256, torch.int32, 700,
        256, 42),
    _k4("m=16 h=1024 n=5000 nq=6 int32 rank=300 cap=1024", 5000, 6, 16, 1024, torch.int32,
        300, 1024, 43),
    _key_route(350, 2048),
    _ivf("m=7 h=256 nq=33 p=12 k=10, ragged and empty lists, -1 slots, tombstones",
         _ragged(50, 40, 1, 300, 6, 1500), 33, 12, 7, 256, 10, dead=200, unused=3, seed=51),
    _ivf("m=4 h=40 nq=5 p=nlist=30 k=100, no extra", _ragged(52, 30, 0, 200, 3, 700), 5, 30,
         4, 40, 100, extra="none", seed=53),
    _ivf("m=7 h=256 nq=3 p=4 k=2048, fewer candidates than k", _ragged(54, 20, 1, 130, 2, 400),
         3, 4, 7, 256, 2048, dead=20, unused=1, seed=55),
    _ivf("m=7 h=256 nq=2 p=nlist=40 k=2048, slices merged", _ragged(56, 40, 500, 1100, 1, 2000),
         2, 40, 7, 256, 2048, dead=100, seed=57),
    _ivf("m=16 h=256 nq=1 p=nlist=25 k=1, a slice a few chunks", _ragged(58, 25, 0, 300, 4, 900),
         1, 25, 16, 256, 1, seed=59),
    _probes("nq=1000 nlist=1024 d=128 nprobe=64, integer", 1000, 1024, 128, 64, True, 61),
    _probes("nq=7 nlist=16384 d=128 nprobe=64, duplicated lists", 7, 16_384, 128, 64, False, 62),
    _probes("nq=1 nlist=16384 d=100 nprobe=1, integer", 1, 16_384, 100, 1, True, 63),
    _probes("nq=7 nlist=1024 d=128 nprobe=64, integer, a list and a query not finite", 7, 1024,
            128, 64, True, 65, inf_list=77, inf_query=3),
    _probes("nq=7 nlist=1001 d=100 nprobe=20, integer", 7, 1001, 100, 20, True, 67),
    _probes("nq=1000 nlist=256 d=32 nprobe=8, integer, one chunk of one tile", 1000, 256, 32, 8,
            True, 71),
    _probes("nq=7 nlist=500 d=128 nprobe=64, duplicated lists, one chunk", 7, 500, 128, 64,
            False, 72),
    _probes_wide("nq=7 nlist=1000 d=960 nprobe=1, duplicated lists (the torch form)", 7, 1000,
                 960, 1, 64),
    _probes_wide("nq=1000 nlist=1000 d=100 nprobe=nlist, duplicated lists (the torch form)",
                 1000, 1000, 100, 1000, 66),
    _probes_wide("nq=33 nlist=16384 d=128 nprobe=1024, duplicated lists (the torch form)", 33,
                 16_384, 128, 1024, 68),
    _probes_wide("nq=1 nlist=16384 d=128 nprobe=65, duplicated lists (the torch form)", 1,
                 16_384, 128, 65, 69),
    _probes_wide("nq=1 nlist=16384 d=100 nprobe=2048, duplicated lists (the torch form)", 1,
                 16_384, 100, 2048, 70),
    *(_l2(dtype, wide) for dtype in (torch.bfloat16, torch.float32) for wide in (False, True)),
)


# ---------------------------------------------------------------------------
# Running them.


def kernel_launches() -> int:
    """Every wrapper's launch count, on the path or not."""
    c = launch_counts.read()
    return sum(c[key] for key in launch_counts.LAUNCHES)


def _poison_allocator(dev, byte: int) -> None:
    """Fill the caching allocator's free memory on `dev` with `byte`: hand
    back what it caches, then allocate, fill and free a small-pool and a
    large-pool region, which it keeps for the next allocations."""
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    small = [torch.full((1 << 20,), byte, dtype=torch.uint8, device=dev)
             for _ in range(_POISON_SMALL)]
    large = torch.full((_POISON_LARGE,), byte, dtype=torch.uint8, device=dev)
    torch.cuda.synchronize(dev)
    del small, large


def _guarded(t, byte: int, guards: list):
    """t copied to the head of an allocation whose last _GUARD_BYTES hold
    `byte`; the allocation and the guard's start go to `guards`."""
    if not isinstance(t, torch.Tensor):
        return t
    t = t.contiguous()
    nbytes = t.numel() * t.element_size()
    buf = torch.full((nbytes + _GUARD_BYTES,), byte, dtype=torch.uint8, device=t.device)
    head = buf[:nbytes]
    head.copy_(t.reshape(-1).view(torch.uint8))
    guards.append((buf, nbytes))
    return head.view(t.dtype).view(t.shape)


def run_case(case: Case, dev, fill: str = "none") -> tuple[str | None, int]:
    """Run one case on `dev`; returns (what differs or None, kernel launches)."""
    inputs = case.make(dev)
    guards = []
    if fill in ("zero", "ones") and dev.type == "cuda":
        byte = 0 if fill == "zero" else 0xFF
        inputs = tuple(_guarded(t, byte, guards) for t in inputs)
        _poison_allocator(dev, byte)
    before = kernel_launches()
    got = case.kernel(inputs)
    launched = kernel_launches() - before
    want = case.plain(inputs)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    bad = case.compare(got, want, inputs)
    if bad is None and dev.type == "cuda" and launched == 0 and case.entries:
        bad = "no kernel launched"
    if bad is None and dev.type == "cuda" and launched > 0 and not case.entries:
        bad = f"{launched} kernel launches where the torch form was due"
    for buf, start in guards:
        if bad is None and not bool((buf[start:] == byte).all()):
            bad = "an input's guard bytes changed"
    return bad, launched


# The port's kernels by a part of their mangled names: the sanitizer checks
# these and no kernel of PyTorch's.
SANITIZED_KERNELS = ("ils_kernel", "icm_sweeps_kernel", "adc_scan", "dense_hist",
                     "dense_collect", "dense_tie_count", "dense_tie_take", "k2_filter",
                     "k2_select", "scan_select", "scan_key", "ivf_scan", "ivf_merge",
                     "ivf_probes", "ivf_probes_select", "l2_gather_kernel")
SANITIZER_TOOLS = ("memcheck", "racecheck", "initcheck", "synccheck")
# What the sanitizer prints where it cannot instrument the card.
SANITIZER_REFUSAL = "Device not supported"


def sanitizer_command(tool: str) -> list[str]:
    """This module on the card under compute-sanitizer's `tool`, filtered to
    the port's kernels; raises if the toolkit has no compute-sanitizer."""
    san = _build.sanitizer()
    if san is None:
        raise RuntimeError("compute-sanitizer not found in "
                           + ", ".join(_build.sanitizer_paths()))
    opts = {"memcheck": ["--leak-check", "no"], "racecheck": ["--racecheck-report", "all"],
            "initcheck": [], "synccheck": []}[tool]
    names = [a for k in SANITIZED_KERNELS for a in ("--kernel-name", f"kns={k}")]
    return [san, "--tool", tool, *opts, *names, "--error-exitcode", "99",
            sys.executable, "-m", __name__, "--device", "cuda"]


def sanitize(tool: str, *, timeout: float = 900.0) -> dict:
    """Run the cases under one compute-sanitizer tool in a subprocess, the
    caching allocator off. Returns {"ok": the tool's "ERROR SUMMARY: 0
    errors", exit code 0 and the cases' pass line, "refused": the tool's
    refusal line where it cannot instrument the card, else None, "errors",
    "launches" (the kernel launches it checked), "seconds", "rc", "tail":
    the output's last lines}."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, PYTORCH_NO_CUDA_MEMORY_CACHING="1")
    t0 = time.perf_counter()
    proc = subprocess.run(sanitizer_command(tool), cwd=root, env=env,
                          capture_output=True, text=True, timeout=timeout)
    out = proc.stdout + proc.stderr
    summary = re.search(r"ERROR SUMMARY: (\d+) error", out)
    passed = re.search(r"kernel_cases: all \d+ cases passed on cuda \((\d+) kernel launches",
                       out)
    refused = next((line.strip("= ").strip() for line in out.splitlines()
                    if SANITIZER_REFUSAL in line), None)
    errors = int(summary.group(1)) if summary else None
    return {"tool": tool, "ok": proc.returncode == 0 and errors == 0 and passed is not None,
            "refused": refused if passed is None else None, "errors": errors,
            "launches": int(passed.group(1)) if passed else 0,
            "seconds": time.perf_counter() - t0, "rc": proc.returncode,
            "tail": "\n".join(out.splitlines()[-40:])}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--fill", default="none",
                   help=f"one of {FILLS}, or a comma list of them run in turn")
    p.add_argument("--only", default="", help="run the cases whose name holds this text")
    args = p.parse_args(argv)
    fills = args.fill.split(",")
    if not set(fills) <= set(FILLS):
        p.error(f"--fill takes {FILLS}, got {args.fill!r}")
    from local_search_quantization_torch.utils.device import entry_device

    dev = entry_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    cases = [c for c in CASES if args.only in c.name]
    total = 0
    for fill in fills:
        torch.use_deterministic_algorithms(fill == "nan")
        torch.utils.deterministic.fill_uninitialized_memory = True
        for case in cases:
            t0 = time.perf_counter()
            bad, launched = run_case(case, dev, fill)
            total += launched
            print(f"case {case.name} (fill {fill}): "
                  f"{'ok' if bad is None else 'FAILED: ' + bad} "
                  f"({launched} launches, {time.perf_counter() - t0:.3f} s)", flush=True)
            if bad is not None:
                print(f"kernel_cases: FAILED on {dev.type}, fill {fill}: {case.name}: {bad}",
                      file=sys.stderr)
                return 1
    torch.use_deterministic_algorithms(False)
    print(f"kernel_cases: all {len(cases)} cases passed on {dev.type} ({total} kernel "
          f"launches, fill {args.fill})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
