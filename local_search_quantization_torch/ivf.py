"""IVF coarse partition over a quantized code store (port of `ivf.py`).

An inverted-file (IVF) coarse quantizer in front of the ADC scan, so that a
query scans only the few lists nearest to it:

    part = ivf.build_partition(B, xhat, extra, nlist=1024, device=dev)
    res  = ivf.search(part, luts, k=100, probes=ivf.coarse_probes(Q, part, 32))

- The coarse quantizer trains on CODE RECONSTRUCTIONS, not original vectors:
  the ADC distance of a row is a function of its reconstruction only, and
  the partition can be built from a saved index alone.
- Grouped storage pads every list segment to 64-row alignment (the native
  scanner, native/lsq_native.cpp: lsq_linscan_ivf, runs whole chunks); pad
  rows are excluded by the per-list live lengths and are never returned.
- Distances over the probed candidate set are EXACT; only which rows are
  candidates is approximate, so recall converges to the exhaustive scan's as
  nprobe -> nlist.
- Rows appended after the partition was built (Index.add) form a TAIL that
  callers scan exhaustively and merge (Index.search does this).

The partition's arrays are host numpy with the JAX package's names, dtypes
and padding: `to_arrays`/`from_arrays` read and write its `ivf.npz`, and the
host functions here (`topk_lex`, `coarse_probes`, `search`, `exhaustive_scan`,
`merge_knn`) are its numpy functions. `build_partition` trains and assigns
with torch on the device it is given. `DeviceScan` is the probed scan on the
index's device: the grouped store uploaded once; the probes by `ivf_probes`,
which on a CUDA device launches the kernel of `csrc/ivf_probes.cu` where it
serves the shape (each query's coarse scores in registers and its
top-`nprobe` kept on chip, no [nq, nlist] score matrix in device memory;
elsewhere the torch form `coarse_probes_topk`) and on the CPU runs its plain
version `coarse_probes_reference`; and `ivf_scan`, which on a CUDA device
launches the kernel of `csrc/ivf_scan.cu` (each query's probed segments
scored in place, the exact (dist, id) top-k kept on chip, no read back to
the host; the JAX package has no kernel here) and on the CPU runs its plain
version `ivf_scan_reference`: the probed segments' rows gathered a chunk of
queries at a time, distances summed in `lut_scan_block`'s order, and a
lexicographic (dist, id) top-k.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from local_search_quantization_torch import _build
from local_search_quantization_torch.ops import adc, launch_counts
from local_search_quantization_torch.ops.select_kernels import _check, lex_topk

__all__ = ["DeviceScan", "IVFPartition", "build_partition", "coarse_probes",
           "coarse_probes_reference", "coarse_probes_topk", "exhaustive_scan", "ivf_kcap",
           "ivf_probe_plan", "ivf_probes", "ivf_scan",
           "ivf_scan_reference", "ivf_slices", "merge_knn", "merge_knn_device", "search",
           "topk_lex"]

# Candidates (queries x the longest probed list) one chunk of the plain device
# scan gathers at once: some ten int64 or f32 temporaries of this many elements.
_DEVICE_CHUNK_ELEMS = 1 << 24
_ASSIGN_CHUNK = 1 << 16
# The probed scan's kernel (csrc/ivf_scan.cu): the k capacities it is built
# for; the largest table a block holds; the scan blocks an SM holds; the
# rows a slice aims at (on the H100 at the IVF cell's shapes, 3 slices of
# ~13k rows took 0.44 ms, 10 of ~4k 0.51 ms: a block's set-up is dear), the
# rows a slice keeps per unit of k, the most slices a query, and the most
# keys of the slices' workspace.
_IVF_KCAPS = (32, 256, 2048)
_IVF_LUT_MAX_BYTES = 160 * 1024
_IVF_BLOCKS_PER_SM = 6
_IVF_SLICE_ROWS = 16384
_IVF_ROWS_PER_K = 8
_IVF_MAX_SLICES = 256
_IVF_WORK_KEYS = 1 << 25
# The coarse probes' kernel (csrc/ivf_probes.cu): the queries a block scores
# and the lists a tile, one block an SM (its grid is query tiles x chunks).
_PROBES_QTILE = 64
_PROBES_CTILE = 256


def topk_lex(d: np.ndarray, ids: np.ndarray, k: int):
    """Lexicographic-(dist, id) top-k of the FINITE candidates, with the
    scanners' sentinel padding: (dists [k] ascending f32, ids [k] int64),
    (+inf, -1) past the live candidates. A tie block across the k-th value
    keeps its lowest ids: everything strictly below the boundary value plus
    the `need` lowest ids within the tie block.
    """
    out_d = np.full(k, np.inf, np.float32)
    out_i = np.full(k, -1, np.int64)
    keep = np.flatnonzero(np.isfinite(d))
    kq = min(k, keep.size)
    if kq:
        dk = d[keep]
        thr = dk[np.argpartition(dk, kq - 1)[:kq]].max()
        below = keep[dk < thr]
        tie = keep[dk == thr]
        need = kq - below.size  # >= 1: the boundary value is in the top-kq
        if need < tie.size:
            tie = tie[np.argpartition(ids[tie], need - 1)[:need]]
        cand = np.concatenate([below, tie])
        o2 = np.lexsort((ids[cand], d[cand]))[:kq]
        out_d[:kq] = d[cand][o2]
        out_i[:kq] = ids[cand][o2]
    return out_d, out_i


def _lut_scan_row(luts_q: np.ndarray, codes: np.ndarray, extra: np.ndarray | None,
                  ids: np.ndarray, k: int):
    """One query's numpy ADC scan: the LUT entries summed in codebook order,
    then the extra term, then `topk_lex`."""
    d = np.zeros(codes.shape[0], np.float32)
    for j in range(luts_q.shape[0]):
        d += luts_q[j][codes[:, j]]
    if extra is not None:
        d = d + extra
    return topk_lex(d, ids, k)


@dataclasses.dataclass
class IVFPartition:
    """Grouped code store + coarse centroids. All arrays are host numpy."""

    centroids: np.ndarray  # [nlist, d] f32, original space
    cnorms: np.ndarray  # [nlist] f32 squared centroid norms
    order: np.ndarray  # [n_g] int64 original ids (-1 on pad rows)
    starts: np.ndarray  # [nlist+1] int64 padded segment offsets (64-aligned)
    lives: np.ndarray  # [nlist] int64 live rows per segment
    codes_g: np.ndarray  # [n_g, m] uint8 grouped codes
    codesT_g: np.ndarray  # [m, n_g] uint8 plane-major copy (native VBMI path)
    extra_g: np.ndarray | None  # [n_g] f32 norm terms / +inf tombstones
    pos_of_id: np.ndarray  # [n_grouped] int64: grouped position of each id
    n_grouped: int  # ids < n_grouped are in the partition; rest = tail
    emin: float  # lower bound of finite extra_g values (0 when None)

    @property
    def nlist(self) -> int:
        return int(self.lives.shape[0])

    def tombstone(self, ids: np.ndarray) -> None:
        """Mirror Index.delete into the grouped store: +inf the rows so no
        scan can return them. Ids >= n_grouped live in the tail and are the
        caller's; negative ids are ignored."""
        ids = np.asarray(ids, np.int64)
        ids = ids[(ids >= 0) & (ids < self.n_grouped)]
        if ids.size == 0:
            return
        if self.extra_g is None:
            self.extra_g = np.zeros(self.order.shape[0], np.float32)
        self.extra_g[self.pos_of_id[ids]] = np.inf

    def compact(self, new_of_old: np.ndarray) -> None:
        """Re-number after an Index.compact(): drop the rows whose
        new_of_old[old_id] is -1, renumber the survivors, re-pad every
        segment. List assignments are kept, so a compact costs no coarse
        k-means. new_of_old must cover [0, n_grouped)."""
        nlist = self.nlist
        seg_rows = []  # per list: (codes, extras, new_ids)
        for li in range(nlist):
            s0, live = int(self.starts[li]), int(self.lives[li])
            pos = np.arange(s0, s0 + live)
            news = new_of_old[self.order[pos]]
            keep = news >= 0
            seg_rows.append((self.codes_g[pos[keep]],
                             None if self.extra_g is None else self.extra_g[pos[keep]],
                             news[keep]))
        counts = np.array([r[2].size for r in seg_rows], np.int64)
        starts = _padded_starts(counts)
        n_g = int(starts[-1])
        order = np.full(n_g, -1, np.int64)
        codes_g = np.zeros((n_g, self.codes_g.shape[1]), np.uint8)
        extra_g = None if self.extra_g is None else np.zeros(n_g, np.float32)
        for li, (cb, eb, ids) in enumerate(seg_rows):
            s0 = starts[li]
            order[s0:s0 + ids.size] = ids
            codes_g[s0:s0 + ids.size] = cb
            if extra_g is not None:
                extra_g[s0:s0 + ids.size] = eb
        self.order, self.starts, self.lives = order, starts, counts
        self.codes_g = codes_g
        self.codesT_g = np.ascontiguousarray(codes_g.T)
        self.extra_g = extra_g
        self.n_grouped = int(counts.sum())
        self.pos_of_id = _positions(order, self.n_grouped)
        # emin stays valid: dropping rows can only raise the true minimum.

    def to_arrays(self) -> dict:
        """Flat dict for npz persistence (extra_g omitted when None)."""
        out = {"centroids": self.centroids, "order": self.order, "starts": self.starts,
               "lives": self.lives, "codes_g": self.codes_g,
               "n_grouped": np.int64(self.n_grouped), "emin": np.float32(self.emin)}
        if self.extra_g is not None:
            out["extra_g"] = self.extra_g
        return out

    @classmethod
    def from_arrays(cls, a: dict) -> "IVFPartition":
        """Rebuild from `to_arrays` output (of either package), validating
        the structural invariants the scanners rely on: a corrupt file fails
        here, not as an out-of-bounds read."""
        codes_g = np.ascontiguousarray(a["codes_g"], np.uint8)
        order = np.asarray(a["order"], np.int64)
        n_grouped = int(a["n_grouped"])
        starts = np.asarray(a["starts"], np.int64)
        lives = np.asarray(a["lives"], np.int64)
        n_g = codes_g.shape[0]
        if (order.shape[0] != n_g or starts.shape[0] != lives.shape[0] + 1
                or starts[0] != 0 or starts[-1] != n_g
                or (starts % 64).any() or (np.diff(starts) < lives).any()
                or (lives < 0).any()):
            raise ValueError("corrupt IVF partition arrays")
        ids = order[order >= 0]
        if (ids.size != n_grouped or ids.max(initial=-1) >= n_grouped
                or np.unique(ids).size != n_grouped):
            raise ValueError("corrupt IVF partition ids")
        cent = np.asarray(a["centroids"], np.float32)
        return cls(
            centroids=cent, cnorms=(cent * cent).sum(axis=1), order=order, starts=starts,
            lives=lives, codes_g=codes_g, codesT_g=np.ascontiguousarray(codes_g.T),
            extra_g=(np.asarray(a["extra_g"], np.float32).copy() if "extra_g" in a
                     else None),
            pos_of_id=_positions(order, n_grouped), n_grouped=n_grouped,
            emin=float(a["emin"]))


def _padded_starts(counts: np.ndarray) -> np.ndarray:
    """[nlist + 1] segment offsets with every segment padded to 64 rows."""
    starts = np.zeros(counts.shape[0] + 1, np.int64)
    np.cumsum(counts + (-counts) % 64, out=starts[1:])
    return starts


def _positions(order: np.ndarray, n: int) -> np.ndarray:
    """[n] grouped position of each id of `order` (-1 on pad rows)."""
    pos = np.empty(n, np.int64)
    live = order >= 0
    pos[order[live]] = np.flatnonzero(live)
    return pos


def build_partition(B: np.ndarray, xhat, extra: np.ndarray | None, nlist: int, *,
                    device, seed: int = 0, sample: int = 1 << 18,
                    iters: int = 25) -> IVFPartition:
    """Train coarse centroids on reconstructions and group the code store.

    B [n, m] codes (any int dtype, values < 256); xhat [n, d] f32
    reconstructions (numpy, or a tensor on `device`); extra [n] f32 norm
    terms / +inf tombstones or None. The row sample is numpy's
    `default_rng(seed)`, as in the JAX package; the k-means (`ops/kmeans.py`,
    from a `torch.Generator` seeded with `seed`) and the assignment (a chunked
    full-f32 matmul and argmin) run on `device`, so the centroids are this
    package's own. A tensor `xhat` that lies on another device than `device`
    is refused, not moved.
    """
    from local_search_quantization_torch.ops import kmeans as km

    n, m = B.shape
    ns = min(sample, n)
    if nlist < 1 or nlist > ns:
        raise ValueError(f"nlist={nlist} out of range [1, {ns}] "
                         f"(min of sample={sample} and n={n})")
    if int(B.max(initial=0)) > 255:
        raise ValueError("IVF grouped store is uint8: needs h <= 256 codes")
    device = torch.device(device)
    if isinstance(xhat, torch.Tensor) and xhat.device.type != device.type:
        raise ValueError(f"build_partition: xhat lies on {xhat.device}, device={device}")
    xhat = torch.as_tensor(xhat, dtype=torch.float32).to(device)

    rng = np.random.default_rng(seed)
    sel = rng.choice(n, ns, replace=False) if ns < n else np.arange(n)
    gen = torch.Generator(device=device).manual_seed(seed)
    res = km.kmeans(gen, xhat[torch.as_tensor(sel, device=device)], nlist, maxiter=iters)
    cent = res.centers.to(torch.float32)
    cn = (cent * cent).sum(dim=1)
    # Every row to its nearest centroid, chunked [c, nlist] scores.
    assign = torch.empty(n, dtype=torch.int64, device=device)
    for s0 in range(0, n, _ASSIGN_CHUNK):
        blk = xhat[s0:s0 + _ASSIGN_CHUNK]
        assign[s0:s0 + _ASSIGN_CHUNK] = torch.argmin(cn[None, :] - 2.0 * (blk @ cent.T), dim=1)
    assign = assign.cpu().numpy()
    centroids = cent.cpu().numpy()

    counts = np.bincount(assign, minlength=nlist).astype(np.int64)
    starts = _padded_starts(counts)
    n_g = int(starts[-1])
    # Stable grouping keeps ascending original ids inside each list.
    by_list = np.argsort(assign, kind="stable")
    live_pos = np.repeat(starts[:-1] - (np.cumsum(counts) - counts), counts) + np.arange(n)
    order = np.full(n_g, -1, np.int64)
    order[live_pos] = by_list
    codes_g = np.zeros((n_g, m), np.uint8)
    codes_g[live_pos] = np.ascontiguousarray(B, np.uint8)[by_list]
    extra_arr = None if extra is None else np.asarray(extra, np.float32)
    extra_g = None
    if extra_arr is not None:
        extra_g = np.zeros(n_g, np.float32)
        extra_g[live_pos] = extra_arr[by_list]
    # emin over the LIVE rows only: the 0.0 alignment pads would drag the
    # bound below the true minimum.
    finite = (np.array([], np.float32) if extra_arr is None
              else extra_arr[np.isfinite(extra_arr)])
    return IVFPartition(
        centroids=centroids, cnorms=(centroids * centroids).sum(axis=1), order=order,
        starts=starts, lives=counts, codes_g=codes_g,
        codesT_g=np.ascontiguousarray(codes_g.T), extra_g=extra_g,
        pos_of_id=_positions(order, n), n_grouped=n,
        emin=float(finite.min()) if finite.size else 0.0)


def coarse_probes(Q: np.ndarray, part: IVFPartition, nprobe: int) -> np.ndarray:
    """[nq, nprobe] int32 nearest-list ids per query, ascending by coarse
    distance (closest first)."""
    Q = np.asarray(Q, np.float32)
    nprobe = min(nprobe, part.nlist)
    sc = part.cnorms[None, :] - 2.0 * (Q @ part.centroids.T)
    idx = np.argpartition(sc, nprobe - 1, axis=1)[:, :nprobe]
    dsel = np.take_along_axis(sc, idx, axis=1)
    idx = np.take_along_axis(idx, np.argsort(dsel, axis=1, kind="stable"), axis=1)
    return np.ascontiguousarray(idx, np.int32)


def _numpy_scan(part: IVFPartition, luts: np.ndarray, k: int,
                probes: np.ndarray) -> adc.KNNResult:
    """The numpy oracle: exact distances, lexicographic (dist, id), (+inf,
    -1) sentinels past the live candidates. The native scanner returns the
    same distances; at an exact tie across the k-th value it may keep another
    tied row (it accepts in probe and scan order)."""
    nq = luts.shape[0]
    dists = np.full((nq, k), np.inf, np.float32)
    ids = np.full((nq, k), -1, np.int64)
    for q in range(nq):
        segs = [np.arange(part.starts[p], part.starts[p] + part.lives[p])
                for p in probes[q] if p >= 0]
        rows = np.concatenate(segs) if segs else np.array([], np.int64)
        if rows.size == 0:
            continue
        dists[q], ids[q] = _lut_scan_row(
            luts[q], part.codes_g[rows],
            None if part.extra_g is None else part.extra_g[rows], part.order[rows], k)
    return adc.KNNResult(dists, ids)


def search(part: IVFPartition, luts: np.ndarray, k: int, probes: np.ndarray, *,
           method: str = "auto") -> adc.KNNResult:
    """Scan the probed segments on the host. luts [nq, m, h] f32 per-query
    ADC tables (`adc.pq_query_luts` / `adc.lsq_query_luts` semantics, so the
    distances compare with the exhaustive scans').

    method: "auto" = the native scanner when it is built, "numpy" = the
    oracle. Both return the same distances; ids at an exact tie across the
    k-th value may differ (see `_numpy_scan`). Numpy arrays in and out.
    """
    from local_search_quantization_torch.utils import native

    luts = np.ascontiguousarray(luts, np.float32)
    if method == "numpy" or not native.has_ivf():
        return _numpy_scan(part, luts, k, probes)
    d, i = native.linscan_ivf(luts, part.codes_g, part.codesT_g, part.extra_g, part.order,
                              part.starts, part.lives, probes, k, emin=part.emin)
    return adc.KNNResult(d, i)


def exhaustive_scan(luts: np.ndarray, codes: np.ndarray, extra: np.ndarray | None,
                    k: int) -> adc.KNNResult:
    """Exhaustive host ADC scan of a code block with PREBUILT per-query LUTs:
    the tail of `Index._search_ivf` (rows appended after the partition). The
    native scanner when it is built and the codes fit a byte; numpy
    otherwise."""
    from local_search_quantization_torch.utils import native

    codes = np.asarray(codes)
    n = codes.shape[0]
    k = min(k, n)
    if native.available() and int(codes.max(initial=0)) <= 255:
        return adc.KNNResult(*native.linscan(luts, codes, extra, k))
    nq = luts.shape[0]
    dists = np.full((nq, k), np.inf, np.float32)
    ids = np.full((nq, k), -1, np.int64)
    row_ids = np.arange(n, dtype=np.int64)
    extra_arr = None if extra is None else np.asarray(extra, np.float32)
    for q in range(nq):
        dists[q], ids[q] = _lut_scan_row(luts[q], codes, extra_arr, row_ids, k)
    return adc.KNNResult(dists, ids)


def merge_knn(a: adc.KNNResult, b: adc.KNNResult, k: int) -> adc.KNNResult:
    """Merge two per-query top-k lists (numpy) into one lexicographic-(dist,
    id) top-k, keeping the (+inf, -1) sentinel padding."""
    d = np.concatenate([a.dists, b.dists], axis=1)
    i = np.concatenate([a.ids, b.ids], axis=1)
    order = np.lexsort((i, d), axis=1)[:, :k]
    d = np.take_along_axis(d, order, axis=1)
    i = np.take_along_axis(i, order, axis=1)
    i[~np.isfinite(d)] = -1
    return adc.KNNResult(d, i)


# ---------------------------------------------------------------------------
# The coarse probes on the index's device: the kernel, its plain version, and
# the torch form above the kernel's capacity.


def coarse_probes_reference(Q: torch.Tensor, centroidsT: torch.Tensor, cnorms: torch.Tensor,
                            nprobe: int) -> torch.Tensor:
    """Plain version of `ivf_probes`, the function of `coarse_probes` on a
    device: Q [nq, d] f32, centroidsT [d, nlist] f32 (the centroids
    transposed), cnorms [nlist] f32. Returns [nq, min(nprobe, nlist)] int64:
    each query's lists of least score cnorms - 2 Q @ centroidsT in (score,
    list id) order, so that an exact tie goes to the lower id; a list whose
    score is not finite is never returned, and the slots past the finite
    scores are -1 (`lex_topk`)."""
    nq, nlist = Q.shape[0], cnorms.shape[0]
    sc = cnorms[None, :] - 2.0 * (Q @ centroidsT)
    ids = torch.arange(nlist, device=Q.device).expand(nq, nlist)
    return lex_topk(sc, ids, min(nprobe, nlist))[1]


def coarse_probes_topk(Q: torch.Tensor, centroidsT: torch.Tensor, cnorms: torch.Tensor,
                       nprobe: int) -> torch.Tensor:
    """The torch form of the probes (a GEMM, the scores and `torch.topk`,
    whose order among exact ties is unspecified): `ivf_probes` takes it
    where the kernel does not serve the shape. Arguments and result as
    `coarse_probes_reference`."""
    sc = cnorms[None, :] - 2.0 * (Q @ centroidsT)
    return torch.topk(sc, min(nprobe, cnorms.shape[0]), dim=1, largest=False).indices


def ivf_probe_plan(nq: int, nlist: int, sms: int) -> int:
    """The chunks the probes kernel cuts the lists into (its grid is query
    tiles of `_PROBES_QTILE` x chunks), from shapes the host knows: as many
    as fill the card's `sms` SMs in one wave of blocks, one an SM, but each
    at least a tile of `_PROBES_CTILE` lists (at least 4 P, so that a
    chunk's P candidates are a small share of its scores)."""
    qtiles = -(-nq // _PROBES_QTILE)
    return max(1, min(sms // max(qtiles, 1), nlist // _PROBES_CTILE))


def ivf_probes(Q: torch.Tensor, centroidsT: torch.Tensor, cnorms: torch.Tensor,
               nprobe: int) -> torch.Tensor:
    """Each query's `nprobe` nearest lists, closest first: the function of
    `coarse_probes_reference` (same arguments and result). On a CUDA device
    the kernel of csrc/ivf_probes.cu where it serves the shape (nprobe <= 64,
    d <= 128: the scores in f32 FMAs, no TF32; its workspace and the ids in
    one allocation; no host sync), counted as "ivf_probes"; elsewhere the
    torch form `coarse_probes_topk`, the faster there, counted as
    "ivf_probes_wide". On the CPU the plain version. nprobe is cut to nlist;
    an nprobe below 1 raises."""
    dev = Q.device
    nlist = cnorms.shape[0]
    nprobe = min(nprobe, nlist)
    if nprobe < 1:
        raise ValueError(f"ivf_probes: nprobe={nprobe} (of nlist={nlist}) must be >= 1")
    if dev.type == "cpu":
        return coarse_probes_reference(Q, centroidsT, cnorms, nprobe)
    if dev.type != "cuda":
        raise ValueError(f"ivf_probes: unsupported device {dev}")
    nq, d = Q.shape
    lib = _build.load("ivf_probes")
    if not lib.lsq_ivf_probes_serves(d, nprobe):
        launch_counts.COUNTS["ivf_probes_wide"] += 1
        return coarse_probes_topk(Q, centroidsT, cnorms, nprobe)
    _check("ivf_probes", dev, [
        (Q, Q.dtype == torch.float32 and Q.ndim == 2, "Q must be f32 [nq, d]"),
        (centroidsT, centroidsT.dtype == torch.float32
         and tuple(centroidsT.shape) == (d, nlist) and nlist < 1 << 31,
         "centroidsT must be f32 [d, nlist], nlist below 2^31"),
        (cnorms, cnorms.dtype == torch.float32 and cnorms.ndim == 1,
         "cnorms must be f32 [nlist]")])
    if nq == 0:
        return torch.empty((0, nprobe), dtype=torch.int64, device=dev)
    chunks = ivf_probe_plan(nq, nlist, torch.cuda.get_device_properties(dev).multi_processor_count)
    buf = torch.empty(nq * nprobe + lib.lsq_ivf_probes_work_words(nq, chunks, nprobe),
                      dtype=torch.int64, device=dev)
    out, work = buf[:nq * nprobe].view(nq, nprobe), buf[nq * nprobe:]
    lib.lsq_ivf_probes(Q.data_ptr(), nq, d, centroidsT.data_ptr(), cnorms.data_ptr(), nlist,
                       nprobe, chunks, work.data_ptr(), out.data_ptr(),
                       torch.cuda.current_stream(dev).cuda_stream, what="ivf_probes kernel launch")
    launch_counts.COUNTS["ivf_probes"] += 1
    return out


# ---------------------------------------------------------------------------
# The probed scan on the index's device: the kernel, and its plain version.


def ivf_scan_reference(luts: torch.Tensor, k: int, probes: torch.Tensor,
                       starts: torch.Tensor, lives: torch.Tensor, codes: torch.Tensor,
                       extra: torch.Tensor | None, order: torch.Tensor) -> adc.KNNResult:
    """Plain version of `ivf_scan`, the function of `_numpy_scan` on a
    device: luts [nq, m, h] f32, probes [nq, p] list ids (-1 = unused),
    the grouped store's starts and lives [nlist], codes [n_g, m], extra
    [n_g] or None, order [n_g]. A chunk of queries gathers its probed
    segments' positions, padded to the chunk's longest candidate list (pads
    at +inf); distances are the LUT gathers summed in j order, then the
    extra term. Returns (dists [nq, k] f32, ids [nq, k] int64), (+inf, -1)
    past the live candidates. Counts the queries and the live rows of their
    probed lists (`ivf_queries`, `ivf_rows_scanned`), read with the longest
    list at one host sync."""
    nq, m, _ = luts.shape
    dev = starts.device
    probes = probes.to(dev, torch.int64)
    used = probes >= 0
    lens = torch.where(used, lives[probes.clamp(min=0)], 0)  # [nq, p]
    ends = torch.cumsum(lens, dim=1)
    longest = rows = 0
    if nq and probes.shape[1]:
        launch_counts.sync(ends)
        longest, rows = torch.stack([ends[:, -1].max(), ends[:, -1].sum()]).tolist()
    launch_counts.COUNTS["ivf_queries"] += nq
    launch_counts.COUNTS["ivf_rows_scanned"] += rows
    if longest == 0:
        return adc.KNNResult(torch.full((nq, k), float("inf"), device=dev),
                             torch.full((nq, k), -1, dtype=torch.int64, device=dev))
    first = starts[probes.clamp(min=0)] - (ends - lens)  # position - slot
    slots = torch.arange(longest, device=dev)
    chunk = max(1, _DEVICE_CHUNK_ELEMS // longest)
    out_d, out_i = [], []
    for s in range(0, nq, chunk):
        e, f, lq = ends[s:s + chunk], first[s:s + chunk], luts[s:s + chunk]
        c = e.shape[0]
        live = slots[None, :] < e[:, -1:]
        # The probe each slot falls into: the first whose end is past it.
        which = torch.searchsorted(e, slots[None, :].expand(c, -1).contiguous(),
                                   right=True).clamp(max=e.shape[1] - 1)
        pos = torch.where(live, torch.gather(f, 1, which) + slots[None, :], 0)
        rows_c = codes[pos]  # [c, longest, m]
        d = torch.gather(lq[:, 0, :], 1, rows_c[:, :, 0].long())
        for j in range(1, m):
            d = d + torch.gather(lq[:, j, :], 1, rows_c[:, :, j].long())
        if extra is not None:
            d = d + extra[pos]
        dd, ii = lex_topk(d, torch.where(live, order[pos], -1), k)
        out_d.append(dd)
        out_i.append(ii)
    return adc.KNNResult(torch.cat(out_d), torch.cat(out_i))


def ivf_kcap(k: int) -> int:
    """The k capacity of the kernel build that takes k: the least of
    `_IVF_KCAPS` >= k. A k beyond the largest raises."""
    for cap in _IVF_KCAPS:
        if 1 <= k <= cap:
            return cap
    raise ValueError(f"ivf_scan: k={k} out of the probed scan kernel's range [1, "
                     f"{_IVF_KCAPS[-1]}] (its largest k capacity)")


def ivf_slices(nq: int, p: int, k: int, mean_rows: float, sms: int) -> int:
    """Slices a query's probed chunks are cut into (the scan's grid is nq x
    slices), from what the host knows without reading the lists: the rows a
    query probes estimated as p x the mean list. Enough slices that the grid
    fills the card (`_IVF_BLOCKS_PER_SM` blocks an SM) and that a slice holds
    about `_IVF_SLICE_ROWS` rows, so that a heavy query is spread like a
    light one; at most one slice a `_IVF_ROWS_PER_K` x k rows, so that each
    slice's top-k is a small share of its rows; at most `_IVF_MAX_SLICES`,
    and at most `_IVF_WORK_KEYS` keys in the slices' workspace."""
    rows = p * mean_rows
    want = max(-(-_IVF_BLOCKS_PER_SM * sms // max(nq, 1)), int(-(-rows // _IVF_SLICE_ROWS)))
    most = min(_IVF_MAX_SLICES, int(rows // (_IVF_ROWS_PER_K * k)),
               _IVF_WORK_KEYS // max(nq * k, 1))
    return max(1, min(want, most))


def ivf_scan(luts: torch.Tensor, k: int, probes: torch.Tensor, starts: torch.Tensor,
             lives: torch.Tensor, codesT: torch.Tensor, extra: torch.Tensor | None,
             order: torch.Tensor, mean_rows: float) -> adc.KNNResult:
    """The probed scan of `ivf_scan_reference` (same arguments and
    results, codes given as planes codesT [m, n_g] uint8; mean_rows: the
    mean live rows of a list, a host number that sizes the grid). On a CUDA
    device the kernel of csrc/ivf_scan.cu, for k <= 2048 (`ivf_kcap`; a
    larger k raises), with no host sync: `ivf_queries` is counted on the
    host, `ivf_rows_scanned` on the device (`launch_counts.device_counter`).
    On the CPU the plain version. Counts launches as "ivf_scan" and the
    merge's as "ivf_merge"."""
    dev = luts.device
    if dev.type == "cpu":
        return ivf_scan_reference(luts, k, probes, starts, lives, codesT.t(), extra, order)
    if dev.type != "cuda":
        raise ValueError(f"ivf_scan: unsupported device {dev}")
    cap = ivf_kcap(k)
    nq, m, h = luts.shape
    p = probes.shape[-1]
    n_g = codesT.shape[1]
    checks = [(luts, luts.dtype == torch.float32, "luts must be f32 [nq, m, h]"),
              (probes, probes.dtype == torch.int64 and probes.ndim == 2
               and probes.shape[0] == nq, "probes must be int64 [nq, p]"),
              (starts, starts.dtype == torch.int64 and starts.ndim == 1,
               "starts must be int64 [nlist]"),
              (lives, lives.dtype == torch.int64 and lives.shape == starts.shape,
               "lives must be int64 [nlist]"),
              (codesT, codesT.dtype == torch.uint8 and codesT.shape[0] == m
               and n_g % 64 == 0 and n_g < 1 << 31 and codesT.data_ptr() % 16 == 0,
               "codesT must be uint8 [m, n_g], n_g a multiple of 64 below 2^31, 16-byte aligned"),
              (order, order.dtype == torch.int64 and tuple(order.shape) == (n_g,),
               "order must be int64 [n_g]")]
    if extra is not None:
        checks.append((extra, extra.dtype == torch.float32 and tuple(extra.shape) == (n_g,)
                       and extra.data_ptr() % 16 == 0,
                       "extra must be f32 [n_g], 16-byte aligned"))
    _check("ivf_scan", dev, checks)
    if m * h * 4 > _IVF_LUT_MAX_BYTES:
        raise ValueError(f"ivf_scan: a [{m}, {h}] f32 table exceeds the "
                         f"{_IVF_LUT_MAX_BYTES} bytes a scan block holds")
    launch_counts.COUNTS["ivf_queries"] += nq
    out_d = torch.empty((nq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, k), dtype=torch.int64, device=dev)
    if nq == 0 or p == 0:
        return adc.KNNResult(out_d.fill_(float("inf")), out_i.fill_(-1))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    slices = ivf_slices(nq, p, k, mean_rows, sms)
    work = (torch.empty((nq * slices * k,), dtype=torch.int64, device=dev)
            if slices > 1 else None)
    rows = launch_counts.device_counter("ivf_rows_scanned", dev)
    _build.load("ivf_scan").lsq_ivf_scan(
        luts.data_ptr(), nq, m, h, probes.data_ptr(), p, starts.data_ptr(), lives.data_ptr(),
        codesT.data_ptr(), n_g, None if extra is None else extra.data_ptr(), order.data_ptr(),
        k, cap, slices, None if work is None else work.data_ptr(), rows.data_ptr(),
        out_d.data_ptr(), out_i.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        what="ivf_scan kernel launch")
    launch_counts.COUNTS["ivf_scan"] += 1
    launch_counts.COUNTS["ivf_merge"] += slices > 1
    return adc.KNNResult(out_d, out_i)


class DeviceScan:
    """A partition's grouped store on a torch device, for the probed scan
    there (`ivf_scan`). Build it anew after the partition or its tombstones
    change."""

    def __init__(self, part: IVFPartition, device):
        dev = torch.device(device)
        self.device = dev
        self.nlist = part.nlist
        # [d, nlist]: the probes kernel loads a tile of lists for each coordinate.
        self.centroidsT = torch.as_tensor(np.ascontiguousarray(part.centroids.T)).to(dev)
        self.cnorms = torch.as_tensor(part.cnorms).to(dev)
        self.starts = torch.as_tensor(part.starts[:-1].copy()).to(dev)
        self.lives = torch.as_tensor(part.lives).to(dev)
        # [m, n_g] uint8 planes; the plain version reads their transpose's rows.
        self.codesT = torch.as_tensor(part.codesT_g).to(dev)
        self.order = torch.as_tensor(part.order).to(dev)
        self.extra = None if part.extra_g is None else torch.as_tensor(part.extra_g).to(dev)
        # The mean live rows of a list: sizes the kernel's grid with no read.
        self.mean_rows = float(part.lives.mean()) if part.nlist else 0.0

    def probes(self, Q: torch.Tensor, nprobe: int) -> torch.Tensor:
        """[nq, min(nprobe, nlist)] int64 nearest-list ids, closest first
        (the function of `coarse_probes`, ties to the lower id; Q f32 in the
        original space); see `ivf_probes`."""
        return ivf_probes(Q.contiguous(), self.centroidsT, self.cnorms, nprobe)

    def search(self, luts: torch.Tensor, k: int, probes: torch.Tensor) -> adc.KNNResult:
        """The function of `_numpy_scan` on the device: luts [nq, m, h] f32,
        probes [nq, p] list ids (-1 = unused). Returns (dists [nq, k] f32,
        ids [nq, k] int64), (+inf, -1) past the live candidates; see
        `ivf_scan`."""
        return ivf_scan(luts, k, probes.to(self.device, torch.int64).contiguous(), self.starts,
                        self.lives, self.codesT, self.extra, self.order, self.mean_rows)


def merge_knn_device(a: adc.KNNResult, b: adc.KNNResult, k: int) -> adc.KNNResult:
    """`merge_knn` for tensors on one device: the lexicographic-(dist, id)
    top-k of two per-query lists, ids int64, (+inf, -1) sentinels kept."""
    d = torch.cat([a.dists, b.dists], dim=1)
    i = torch.cat([a.ids.long(), b.ids.long()], dim=1)
    return adc.KNNResult(*lex_topk(d, i, min(k, d.shape[1])))
