"""The ADC scan with a top-k select: kernels K2, K3, K4 and the select API.

Port of `local_search_quantization_tpu.ops.select_pallas`. Every version
here computes, for query q and base row i,

    dist[q, i] = sum_j luts[q, j, Bt[j, i]] + extra[i]    (j order, then extra)

in f32, the same values as `lut_scan_block`. Ids are 0-based int32; +inf
rows are never returned and empty slots are (+inf, -1).

- K2 `scan_topk` (`csrc/scan_topk.cu`; TPU `_select_kernel_grouped`): the
  exact (dist, id)-lexicographic top-k in three stages, `k2_staged`: a
  sampled threshold t0 (`warm_bound`, on K3), `k2_filter` appending the
  rows below t0 as (dist, id) keys, and `k2_select` sorting them with a
  per-query certificate; the queries that fail it, and the shapes the
  stages do not take, run the dense path `scan_topk_dense` (radix select
  over a distance scratch). Variants "grouped" and "grouped_unsorted".
- K3 `scan_select` (`csrc/scan_select.cu`; TPU `_select_kernel`): the same
  top-k cut at a warm bound t0, streamed through per-query shared-memory
  buffers with no distance scratch: a block serves `k3_geometry`'s queries
  on one of `k3_segments`' row segments, and `merge_segments` merges the
  segments' survivors. Variants "sorted" (lexicographic) and "unsorted"
  (value-exact: which ids survive a tie block across the k-th value is
  free).
- K4 `scan_key` (`csrc/scan_key.cu`; TPU `_select_kernel_key`): a scan over
  bf16-rounded LUTs that appends every id whose truncated monotone key lies
  below t0's: a block serves `k4_geometry`'s queries, their tables
  interleaved in shared memory (`k4_interleave`), on one of `k4_segments`'
  row segments. `fused_scan_topk(variant="key")` re-ranks the ids in f32
  and certifies each query (`_key_scan_topk`); `rerun_uncertified` reruns
  the ones that fail.

A wrapper runs its kernel's plain version (`*_reference`) only for tensors
on the CPU; a CUDA tensor goes to the kernel, or the call raises. Each
wrapper that launches a kernel counts its launches under its name in
`launch_counts` (K2's dense path as "scan_topk_dense"). Every merge of
(dist, id) candidates, here and in the modules above, is `lex_topk`.
"""

from __future__ import annotations

import functools
import math
import os

import torch

from local_search_quantization_torch import _build
from local_search_quantization_torch.ops import launch_counts
from local_search_quantization_torch.utils.profiling import span

# K2's dense path: distance scratch per launch, at most this many f32
# elements (1 GiB), and at most this many queries a launch; the rows a
# select block loads at once (a segment is a whole number of them).
_SCRATCH_ELEMS = 1 << 28
_DENSE_QUERIES = 256
_DENSE_TILE = 4096
# K2's staged path (csrc/scan_topk.cu): rows a filter block stages at once,
# the most keys a select block sorts, the fewest rows it takes, and the
# candidate keys one chunk of queries may hold (128 MB).
_K2_TILE = 2048
_K2_SELECT_MAX = 16384
_K2_MIN_N = 1 << 16
_K2_CHUNK_KEYS = 1 << 24
_SIGN64 = -(1 << 63)
# Shared memory one block may use on Hopper (227 KB).
_SMEM_LIMIT = 227 * 1024
# K3 (csrc/scan_select.cu): threads a block, the rows a segment is a multiple
# of, the static shared memory reserved beside the dynamic, one radix
# histogram a query, and the fewest keys of room a query's buffer keeps
# beyond `keep` and one step's appends.
_K3_THREADS = 1024
_K3_ROWS_UNIT = 1024
_K3_STATIC_SMEM = 1024
_K3_HIST_BYTES = 1024
_K3_MIN_SLACK = 64
# K4 (csrc/scan_key.cu): the geometries that are built, as (queries a block,
# queries a lane, rows a lane); the one that runs at each block width; the
# most steps a staged tile holds; the shared memory the runtime keeps of every
# block; and what one more block costs `k4_segments`, in tiles of scan (its
# tables' copy).
_K4_BUILT = ((32, 8, 2), (16, 4, 4), (8, 4, 4), (4, 4, 4), (4, 4, 1))
_K4_LANE = {32: (8, 2), 16: (4, 4), 8: (4, 4), 4: (4, 4)}
_K4_MAX_TILE_STEPS = 4
_K4_BLOCK_RESERVE = 1024
_K4_COLD_TILES = 2
# K4's monotone keys drop their low 13 bits, as the TPU kernel's lane bits
# (select_pallas.py:74).
_LANE_BITS = 13
_KEY_MASK = -(1 << _LANE_BITS)
_MININT = -(1 << 31)

VARIANTS = ("grouped", "grouped_unsorted", "sorted", "unsorted", "key")


def lut_scan_block(luts: torch.Tensor, Bt_block: torch.Tensor,
                   extra: torch.Tensor | None = None) -> torch.Tensor:
    """[nq, m, h] LUTs x [m, nb] codes -> [nq, nb] distances, summed in j order."""
    Bl = Bt_block.long()
    acc = luts[:, 0, :][:, Bl[0]]
    for j in range(1, luts.shape[1]):
        acc = acc + luts[:, j, :][:, Bl[j]]
    if extra is not None:
        acc = acc + extra[None, :]
    return acc


def lex_topk(d: torch.Tensor, ids: torch.Tensor, k: int):
    """The k smallest of each row's candidates in (dist, id) order: d [nq, c]
    f32, ids [nq, c] int32 or int64, distinct within a row but for -1.

    One `torch.topk` of the signed 64-bit keys (mono(d) - 2^31) << 32 | id,
    whose order is the (dist, id) order (-0.0 ranks with +0.0, as in a
    float comparison). `_k2_keys`' bit patterns are not: their signed order
    puts every positive distance before every negative one. A slot whose
    distance is not finite, or whose id is below 0, comes back as (+inf,
    -1), as do the columns past c. Returns (dists [nq, k], ids [nq, k] in
    ids' dtype).

    On the card each elementwise op costs about 11 us of host dispatch at
    the merges' shapes, more than the top-k itself, so the key is built in
    few: the high word the f32 bits made signed-monotone (-0.0 to 0), the
    low word the id, stacked as int32 pairs and read as int64 (little-
    endian)."""
    inf = float("inf")
    d = torch.where(ids >= 0, torch.nan_to_num(d, nan=inf, posinf=inf, neginf=inf), inf)
    ids = torch.where(d < inf, ids, -1)
    b = d.view(torch.int32)
    hi = torch.where(b < 0, _MININT - b, b)
    keys = torch.stack([ids.to(torch.int32), hi], dim=2).view(torch.int64)[:, :, 0]
    pos = torch.topk(keys, min(k, keys.shape[1]), dim=1, largest=False).indices
    return _pad_cols(torch.gather(d, 1, pos), torch.gather(ids, 1, pos), k)


def _check(name: str, dev, checks) -> None:
    for t, ok, msg in checks:
        if not ok or t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: {msg}, contiguous, on {dev}; got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _code_bytes(Bt: torch.Tensor) -> int | None:
    return {torch.uint8: 1, torch.int32: 4}.get(Bt.dtype)


def _cuda_device(name: str, luts: torch.Tensor):
    """The device a wrapper runs on: None for the CPU (plain version)."""
    dev = luts.device
    if dev.type == "cpu":
        return None
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev


# ---------------------------------------------------------------------------
# K2 and K3: the exact top-k, cold or cut at t0.


def scan_select_reference(luts: torch.Tensor, Bt: torch.Tensor,
                          extra: torch.Tensor | None, k: int,
                          t0: torch.Tensor | None = None, *,
                          block: int = 1 << 16):
    """Plain version of K2 and K3: a streaming merge over id-ascending blocks.

    Distances >= t0 ([nq, 1], optional) are dropped. Each block's distances
    are appended to the running top-k and a STABLE sort keeps the first k,
    so equal distances stay in ascending id order: the result is the exact
    (dist, id)-lexicographic top-k of the rows below t0, [nq, k] with
    k = min(k, n). K3's "unsorted" variant shares it.
    """
    nq = luts.shape[0]
    n = Bt.shape[1]
    k = min(k, n)
    dev = luts.device
    best_d = torch.full((nq, k), float("inf"), dtype=torch.float32, device=dev)
    best_i = torch.full((nq, k), -1, dtype=torch.int64, device=dev)
    for s in range(0, n, block):
        e = None if extra is None else extra[s:s + block]
        tile = lut_scan_block(luts, Bt[:, s:s + block], e)
        if t0 is not None:
            tile = torch.where(tile < t0, tile, float("inf"))
        ids = torch.arange(s, s + tile.shape[1], device=dev)
        cand_d = torch.cat([best_d, tile], dim=1)
        cand_i = torch.cat([best_i, ids[None, :].expand(nq, -1)], dim=1)
        best_d, pos = torch.sort(cand_d, dim=1, stable=True)
        best_d = best_d[:, :k]
        best_i = torch.gather(cand_i, 1, pos[:, :k])
    best_i = torch.where(torch.isinf(best_d), -1, best_i)
    return best_d, best_i.to(torch.int32)


def scan_topk_reference(luts: torch.Tensor, Bt: torch.Tensor,
                        extra: torch.Tensor | None, k: int, *,
                        block: int = 1 << 16):
    """Plain version of K2: `scan_select_reference` with no t0."""
    return scan_select_reference(luts, Bt, extra, k, block=block)


def _scan_inputs(name: str, luts: torch.Tensor, Bt: torch.Tensor,
               extra: torch.Tensor | None, t0: torch.Tensor | None = None):
    """Check a scan's inputs on the card (K2, K3, K4: luts, codes, extra and
    t0 where given); returns (extra, zeros where it is None, code bytes)."""
    dev = luts.device
    nq, m, h = luts.shape
    n = Bt.shape[1]
    if extra is None:
        extra = torch.zeros((n,), dtype=torch.float32, device=dev)
    code_bytes = _code_bytes(Bt)
    checks = [
        (luts, luts.dtype == torch.float32, "luts must be f32 [nq, m, h]"),
        (Bt, code_bytes is not None and Bt.shape[0] == m,
         "Bt must be uint8 or int32 [m, n]"),
        (extra, extra.dtype == torch.float32 and tuple(extra.shape) == (n,),
         "extra must be f32 [n]"),
    ]
    if t0 is not None:
        checks.append((t0, t0.dtype == torch.float32 and tuple(t0.shape) == (nq, 1),
                       "t0 must be f32 [nq, 1]"))
    _check(name, dev, checks)
    if n >= 1 << 31:
        raise ValueError(f"{name}: n must be < 2^31")
    return extra, code_bytes


def scan_topk(luts: torch.Tensor, Bt: torch.Tensor, extra: torch.Tensor | None,
              k: int):
    """K2: exact lexicographic top-k ADC scan of all queries.

    luts [nq, m, h] f32; Bt [m, n] uint8 or int32 codes (each < h); extra
    [n] f32 or None. Returns (dists [nq, k] f32, ids [nq, k] int32) with
    k = min(k, n), sorted by (dist, id).

    On the card it runs `k2_staged` with the kernel stages: the pre-scan
    `warm_bound` (K3), `k2_filter` and `k2_select`, with no [nq, n]
    scratch; the queries that fail the certificate rerun through
    `scan_topk_dense`. The dense path takes every query where the stages do
    not hold the shape (n < 65,536, an append capacity above 16,384, or
    LUTs too large for `k2_group`). Each stage's wrapper counts its own
    launches in `launch_counts` ("k2_filter", "k2_select",
    "scan_topk_dense"; the pre-scan under "scan_select");
    "scan_topk_failed" counts the queries rerun dense after a failed
    certificate.
    """
    dev = _cuda_device("scan_topk", luts)
    if dev is None:
        return scan_topk_reference(luts, Bt, extra, k)
    extra, code_bytes = _scan_inputs("scan_topk", luts, Bt, extra)
    nq, m, h = luts.shape
    n = Bt.shape[1]
    k = min(k, n)
    if not scan_topk_fits(m, h):
        raise ValueError(f"scan_topk: m*h={m * h} LUTs exceed one block's "
                         "shared memory")
    if nq == 0 or k == 0:
        return (torch.empty((nq, k), dtype=torch.float32, device=dev),
                torch.empty((nq, k), dtype=torch.int32, device=dev))
    rank, cap = warm_rank_cap(k)
    if (n < _K2_MIN_N or cap > _K2_SELECT_MAX or k2_group(m, h, code_bytes) == 0
            or not select_kernel_fits(rank, m, h)):
        return scan_topk_dense(luts, Bt, extra, k)
    chunk = max(1, min(nq, _K2_CHUNK_KEYS // cap))
    d, i, failed = k2_staged(luts, Bt, extra, k, prescan=_k2_prescan,
                             filt=k2_filter, select=k2_select,
                             dense=scan_topk_dense, chunk=chunk)
    launch_counts.COUNTS["scan_topk_failed"] += failed
    return d, i


def k2_staged(luts: torch.Tensor, Bt: torch.Tensor, extra: torch.Tensor | None,
              k: int, *, prescan, filt, select, dense, chunk: int):
    """K2's control flow over its stage callables, `chunk` queries at a time:

        t0, cap = prescan(luts, Bt, extra, k)         # [q, 1] f32, int
        cand, count = filt(luts, Bt, extra, t0, cap)  # keys [q, cap], [q]
        d, i, ok = select(cand, count, k, cap)        # [q, k] sorted, [q] bool

    then one host sync reads `ok` over all queries, and the failing ones
    rerun through dense(luts[bad], Bt, extra, k), at most 256 at a time. The
    card passes the kernels; the CPU tests pass the plain versions. Returns
    (dists, ids, number of queries rerun dense).
    """
    nq = luts.shape[0]
    parts = []
    for q0 in range(0, nq, chunk):
        lq = luts[q0:q0 + chunk]
        t0, cap = prescan(lq, Bt, extra, k)
        cand, count = filt(lq, Bt, extra, t0, cap)
        parts.append(select(cand, count, k, cap))
    d, i, ok = (torch.cat(p) for p in zip(*parts))
    with span("k2.certify"):
        launch_counts.sync(ok)
        bad = torch.nonzero(~ok)[:, 0]
        for b0 in range(0, bad.numel(), _DENSE_QUERIES):
            sel = bad[b0:b0 + _DENSE_QUERIES]
            d[sel], i[sel] = dense(luts[sel], Bt, extra, k)
    return d, i, bad.numel()


def _k2_prescan(luts, Bt, extra, k):
    return warm_bound(luts, Bt, extra, k=k, variant="sorted")


def scan_topk_dense(luts: torch.Tensor, Bt: torch.Tensor, extra: torch.Tensor | None,
                    k: int):
    """K2's dense path on the card: adc_scan into a [q, n] f32 scratch, then
    a radix select on the (dist, id) key over `dense_segments`' row
    segments, at most 256 queries a launch (fewer where the scratch would
    pass 1 GiB). Same contract as `scan_topk`; the plain version is
    `scan_topk_reference`. Counts launches as "scan_topk_dense"."""
    dev = _cuda_device("scan_topk_dense", luts)
    if dev is None:
        return scan_topk_reference(luts, Bt, extra, k)
    extra, code_bytes = _scan_inputs("scan_topk_dense", luts, Bt, extra)
    nq, m, h = luts.shape
    n = Bt.shape[1]
    k = min(k, n)
    if not scan_topk_fits(m, h):
        raise ValueError(f"scan_topk_dense: m*h={m * h} LUTs exceed one block's "
                         "shared memory")
    out_d = torch.empty((nq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=dev)
    if nq == 0 or k == 0:
        return out_d, out_i
    lib = _build.load("scan_topk")
    qb = max(1, min(nq, _DENSE_QUERIES, _SCRATCH_ELEMS // n))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    chunks = [(q0, min(nq, q0 + qb)) for q0 in range(0, nq, qb)]
    grids = {q1 - q0: dense_segments(n, q1 - q0, sms) for q0, q1 in chunks}
    dist = torch.empty((qb, n), dtype=torch.float32, device=dev)
    work = torch.empty((max(dense_work_bytes(c, *g) for c, g in grids.items()) // 4,),
                       dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for q0, q1 in chunks:
        lib.lsq_scan_topk(
            luts[q0:q1].data_ptr(), Bt.data_ptr(), code_bytes, extra.data_ptr(), q1 - q0,
            m, h, n, k, grids[q1 - q0][1], dist.data_ptr(), work.data_ptr(),
            out_d[q0:q1].data_ptr(), out_i[q0:q1].data_ptr(), stream,
            what="scan_topk dense kernel launch")
        launch_counts.COUNTS["scan_topk_dense"] += 1
    return lex_topk(out_d, out_i, k)


def dense_segments(n: int, nq: int, sms: int) -> tuple[int, int]:
    """(segments, rows a segment) of the dense select's grid over n rows and
    nq queries on a card of `sms` SMs: each segment a whole number of
    `_DENSE_TILE`-row tiles, and at least ceil(2 * sms / nq) segments where
    n holds that many tiles, so that the grid has >= 2 blocks an SM at any
    nq; one segment a query at nq >= 2 * sms. `lsq_scan_topk` takes the
    rows a segment and launches ceil(n / rows) segments, as counted here."""
    tiles = -(-n // _DENSE_TILE)
    per = max(1, tiles // -(-2 * sms // nq))
    return -(-tiles // per), per * _DENSE_TILE


def dense_work_bytes(nq: int, segments: int, rows: int) -> int:
    """Bytes of the dense select's workspace over segments of `rows` rows: a
    32-byte state and a 2048-bin histogram a query, a 1024-bin one a
    (query, segment) and a tie count a (query, tile of a segment). Mirrors
    `lsq_dense_work_bytes` of csrc/scan_topk.cu."""
    return nq * (32 + 4 * 2048 + 4 * 1024 * segments + 4 * (rows // _DENSE_TILE))


def k2_group(m: int, h: int, code_bytes: int) -> int:
    """Queries a `k2_filter` block holds: the largest of 16, 8, 4 whose f32
    LUTs fit in shared memory beside one staged tile of codes and extra, or
    0. Mirrors `lsq_k2_group` of csrc/scan_topk.cu."""
    for g in (16, 8, 4):
        if g * m * h * 4 + _K2_TILE * (4 + m * code_bytes) <= _SMEM_LIMIT:
            return g
    return 0


def _mono(x: torch.Tensor) -> torch.Tensor:
    """The unsigned monotone image of f32 bits (`mono` of the CUDA sources),
    as int64 in [0, 2^32); -0.0 maps with +0.0."""
    b = x.contiguous().view(torch.int32).long() & 0xFFFFFFFF
    b = torch.where(b == 0x80000000, 0, b)
    return torch.where(b >= 0x80000000, b ^ 0xFFFFFFFF, b | 0x80000000)


def _unmono(u: torch.Tensor) -> torch.Tensor:
    """Inverse of `_mono`: int64 in [0, 2^32) -> f32."""
    b = torch.where(u >= 0x80000000, u & 0x7FFFFFFF, u ^ 0xFFFFFFFF)
    return torch.where(b >= 1 << 31, b - (1 << 32), b).to(torch.int32).view(torch.float32)


def _k2_keys(d: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The 64-bit keys mono(d) << 32 | id as int64 bit patterns."""
    hi = _mono(d)
    return torch.where(hi >= 1 << 31, hi - (1 << 32), hi) * (1 << 32) + ids


def k2_filter_reference(luts: torch.Tensor, Bt: torch.Tensor,
                        extra: torch.Tensor | None, t0: torch.Tensor, cap: int, *,
                        block: int = 1 << 16):
    """Plain version of `k2_filter`. Returns (cand [nq, cap] int64: the keys
    mono(dist) << 32 | id, as int64 bit patterns, of the first `cap` rows
    with dist < t0[q] in ascending id order, -1 (all ones) where unfilled;
    count [nq] int32: every such row)."""
    nq = luts.shape[0]
    n = Bt.shape[1]
    dev = luts.device
    cand = torch.full((nq, cap + 1), -1, dtype=torch.int64, device=dev)
    count = torch.zeros((nq, 1), dtype=torch.int64, device=dev)
    for s in range(0, n, block):
        e = None if extra is None else extra[s:s + block]
        d = lut_scan_block(luts, Bt[:, s:s + block], e)
        hit = d < t0
        pos = count + torch.cumsum(hit, dim=1) - 1
        pos = torch.where(hit & (pos < cap), pos, cap)  # column cap: discarded
        keys = _k2_keys(d, torch.arange(s, s + d.shape[1], device=dev)[None, :])
        cand.scatter_(1, pos, torch.where(pos < cap, keys, -1))
        count = count + hit.sum(dim=1, keepdim=True)
    return cand[:, :cap], count[:, 0].to(torch.int32)


def k2_filter(luts: torch.Tensor, Bt: torch.Tensor, extra: torch.Tensor | None,
              t0: torch.Tensor, cap: int):
    """K2's filter: append every row with dist < t0 ([nq, 1] f32) as a key,
    see `k2_filter_reference`. The kernel appends in no fixed order and
    leaves unfilled slots unwritten: compare the first min(count, cap)
    keys, sorted. Counts launches as "k2_filter"."""
    dev = _cuda_device("k2_filter", luts)
    if dev is None:
        return k2_filter_reference(luts, Bt, extra, t0, cap)
    extra, code_bytes = _scan_inputs("k2_filter", luts, Bt, extra, t0)
    nq, m, h = luts.shape
    n = Bt.shape[1]
    g = k2_group(m, h, code_bytes)
    if g == 0 or cap < 1:
        raise ValueError(f"k2_filter: needs cap >= 1 and LUTs (m={m}, h={h}) "
                         "that fit k2_group")
    cand = torch.empty((nq, cap), dtype=torch.int64, device=dev)
    count = torch.zeros((nq,), dtype=torch.int32, device=dev)
    if nq == 0 or n == 0:
        return cand, count
    # Row segments so that the grid has >= 2 blocks an SM at any nq; each
    # segment a whole number of tiles.
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    segments = -(-2 * sms // -(-nq // g))
    tiles = -(-n // _K2_TILE)
    rows_per_block = -(-tiles // segments) * _K2_TILE
    vec = int(n * code_bytes % 16 == 0 and Bt.data_ptr() % 16 == 0
              and extra.data_ptr() % 16 == 0)
    _build.load("scan_topk").lsq_k2_filter(
        luts.data_ptr(), Bt.data_ptr(), code_bytes, extra.data_ptr(), t0.data_ptr(),
        nq, m, h, n, rows_per_block, cap, vec, cand.data_ptr(), count.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream, what="k2_filter kernel launch")
    launch_counts.COUNTS["k2_filter"] += 1
    return cand, count


def k2_select_reference(cand: torch.Tensor, count: torch.Tensor, k: int, cap: int):
    """Plain version of `k2_select`: sort each query's first min(count, cap)
    keys (cand [nq, cap] int64 bit patterns of uint64 keys) and return
    (dists [nq, k] f32, ids [nq, k] int32), (+inf, -1) past them, and the
    certificate ok [nq] bool = k <= count <= cap."""
    nq = cand.shape[0]
    dev = cand.device
    filled = count.long().clamp(max=cap)[:, None]
    keys = torch.where(torch.arange(cap, device=dev)[None, :] < filled, cand, -1)
    keys = torch.sort(keys ^ _SIGN64, dim=1).values ^ _SIGN64  # unsigned order
    if cap < k:
        keys = torch.nn.functional.pad(keys, (0, k - cap), value=-1)
    keys = keys[:, :k]
    valid = torch.arange(k, device=dev)[None, :] < filled
    d = torch.where(valid, _unmono((keys >> 32) & 0xFFFFFFFF), float("inf"))
    i = torch.where(valid, keys & 0xFFFFFFFF, -1).to(torch.int32)
    ok = (count >= k) & (count <= cap)
    return d, i, ok


def k2_select(cand: torch.Tensor, count: torch.Tensor, k: int, cap: int):
    """K2's select: one block a query sorts its keys, see
    `k2_select_reference`; cap <= 16384. Counts launches as "k2_select"."""
    dev = _cuda_device("k2_select", cand)
    if dev is None:
        return k2_select_reference(cand, count, k, cap)
    nq = cand.shape[0]
    _check("k2_select", dev, [
        (cand, cand.dtype == torch.int64 and tuple(cand.shape) == (nq, cap),
         "cand must be int64 [nq, cap]"),
        (count, count.dtype == torch.int32 and tuple(count.shape) == (nq,),
         "count must be int32 [nq]")])
    if not 1 <= cap <= _K2_SELECT_MAX or k < 1:
        raise ValueError(f"k2_select: needs 1 <= cap <= {_K2_SELECT_MAX} and k >= 1, "
                         f"got cap={cap}, k={k}")
    out_d = torch.empty((nq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=dev)
    ok = torch.empty((nq,), dtype=torch.bool, device=dev)
    if nq == 0:
        return out_d, out_i, ok
    _build.load("scan_topk").lsq_k2_select(
        cand.data_ptr(), count.data_ptr(), nq, cap, k, out_d.data_ptr(), out_i.data_ptr(),
        ok.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        what="k2_select kernel launch")
    launch_counts.COUNTS["k2_select"] += 1
    return out_d, out_i, ok


def scan_topk_fits(m: int, h: int) -> bool:
    """Whether K2's shared-memory LUT block (4 queries, f32) holds (m, h):
    `lsq_scan_smem_bytes` of csrc/scan_topk.cu, in Python."""
    return 16 * m * h <= _SMEM_LIMIT


def select_cap(k: int) -> int:
    """The buffer width of the TPU select kernels: max(128, ceil(k/128)*128)
    (select_pallas.py:818). K3's "unsorted" buffer keeps this many rows."""
    return max(128, -(-k // 128) * 128)


def k3_step(g: int) -> int:
    """Rows a K3 block of g queries scores between two checks of its
    buffers: g/2 lanes a row, 4, 4, 2, 1 consecutive rows a lane at g = 16,
    8, 4, 2 (`step_rows` of csrc/scan_select.cu): 512 at g=16, 1024 below."""
    return _K3_THREADS // (g // 2) * {16: 4, 8: 4, 4: 2, 2: 1}[g]


def k3_cap_keys(m: int, h: int, code_bytes: int, g: int) -> int:
    """Keys each of a K3 block's g queries can buffer in shared memory
    beside the g interleaved f32 LUTs (16-byte aligned), the staged tiles of
    extra and codes (one step's rows each; two of them, one at g=2), and a
    histogram, count and threshold a query; 0 where those alone do not fit.
    Mirrors `lsq_select_cap_keys`."""
    stages = 1 if g == 2 else 2
    fixed = ((4 * g * m * h + 15) // 16 * 16 + stages * k3_step(g) * (4 + m * code_bytes)
             + g * (_K3_HIST_BYTES + 8) + _K3_STATIC_SMEM)
    return max(0, (_SMEM_LIMIT - fixed) // (8 * g))


@functools.lru_cache(maxsize=None)
def k3_geometry(m: int, h: int, code_bytes: int, keep: int) -> tuple[int, int]:
    """(g, cap): the queries a K3 block serves and the keys each buffers, or
    (0, 0) where K3 does not hold the shape. A buffer must hold `keep` keys,
    one step's appends (`k3_step`) and some room, since a query trims its
    buffer each time its appends pass that room: the largest g of 16, 8, 4,
    2 with room for keep/8 more keys, else the largest with room for 64.
    At m=7, h=256, uint8
    codes: 16 queries at the pre-scan's keep of 111, 8 at keep 1000, 2 at
    keep 10112. A pure function: it needs no build."""
    for slack in (max(_K3_MIN_SLACK, keep // 8), _K3_MIN_SLACK):
        for g in (16, 8, 4, 2):
            cap = k3_cap_keys(m, h, code_bytes, g)
            if cap >= keep + k3_step(g) + slack:
                return g, cap
    return 0, 0


# What `k3_segments` weighs, in units of 1024 rows of one block's scan (about
# 3 us on an H100): the merge sorts segments x keep candidates a query, and
# torch.sort leaves its fast path for rows above 4096 elements.
_K3_MERGE_WIDTH = 4096
_K3_MERGE_FAST = 20_000   # candidates a unit, rows up to _K3_MERGE_WIDTH
_K3_MERGE_SLOW = 10_000   # candidates a unit above it, after
_K3_MERGE_SLOW_FIXED = 50  # units of fixed cost


@functools.lru_cache(maxsize=None)
def k3_segments(n: int, nq: int, g: int, sms: int, keep: int) -> tuple[int, int]:
    """(segments, rows a segment): K3's split of the n rows across blocks. A
    block (one an SM, by its shared memory) serves g queries on one segment,
    so segments x ceil(nq/g) blocks run in waves of `sms`; every segment
    starts cold and pays for it about what 2048 + 8 keep rows of scan cost,
    and `merge_segments` sorts segments x keep candidates a query. Of 1 ..
    ceil(2 sms / groups) segments (two blocks an SM at most), each a whole
    number of 1024 rows, the count with the least waves x (rows a segment +
    cold start) + merge: a few queries are spread over the card, and a batch
    whose groups fill the card is not split. A pure function."""
    units = -(-n // _K3_ROWS_UNIT)
    groups = -(-nq // g)
    cold = 2 + keep // 128

    def cost(s: int) -> float:
        scan = -(-groups * s // sms) * (-(-units // s) + cold)
        if s == 1:
            return scan
        if s * keep <= _K3_MERGE_WIDTH:
            return scan + nq * s * keep / _K3_MERGE_FAST
        return scan + _K3_MERGE_SLOW_FIXED + nq * s * keep / _K3_MERGE_SLOW

    best = min(range(1, max(1, min(units, -(-2 * sms // groups))) + 1), key=cost)
    rows = -(-units // best) * _K3_ROWS_UNIT
    return -(-n // rows), rows


def select_kernel_fits(k: int, m: int, h: int) -> bool:
    """Whether K3 holds top-k at LUT shape (m, h), in both variants and both
    code layouts: its larger ("unsorted", `select_cap(k)` rows) buffer fits
    a block of two queries with int32 codes staged. A pure function: it
    needs no build."""
    return k3_geometry(m, h, 4, select_cap(k))[0] > 0


def scan_select_segments_reference(luts: torch.Tensor, Bt: torch.Tensor,
                                   extra: torch.Tensor | None, keep: int,
                                   t0: torch.Tensor | None, rows: int):
    """Plain version of K3's kernel: each segment of `rows` rows yields its
    own `keep` smallest rows below t0 in (dist, id) order, with base-wide
    ids: ([nq, segments, keep] f32, int32), (+inf, -1) past a segment's
    survivors. (The kernel leaves each segment's survivors unsorted.)"""
    nq, n = luts.shape[0], Bt.shape[1]
    out_d, out_i = [], []
    for s0 in range(0, n, rows):
        e = None if extra is None else extra[s0:s0 + rows]
        d, i = scan_select_reference(luts, Bt[:, s0:s0 + rows], e, keep, t0)
        d, i = _pad_cols(d, torch.where(i >= 0, i + s0, i), keep)
        out_d.append(d)
        out_i.append(i)
    if not out_d:
        return (torch.full((nq, 0, keep), float("inf"), device=luts.device),
                torch.full((nq, 0, keep), -1, dtype=torch.int32, device=luts.device))
    return torch.stack(out_d, dim=1), torch.stack(out_i, dim=1)


def merge_segments(seg_d: torch.Tensor, seg_i: torch.Tensor, k: int):
    """The k smallest in (dist, id) order of every segment's survivors
    ([nq, segments, keep]): the top-k of the union of the segments' top-keeps
    is the top-k of all rows, for any k <= keep. Returns [nq, k], (+inf, -1)
    past the survivors."""
    nq = seg_d.shape[0]
    return lex_topk(seg_d.reshape(nq, -1), seg_i.reshape(nq, -1), k)


def scan_select(luts: torch.Tensor, Bt: torch.Tensor, extra: torch.Tensor | None,
                k: int, t0: torch.Tensor | None = None, *, unsorted: bool = False):
    """K3: the top-k ADC scan of the rows with distance < t0 ([nq, 1] f32;
    None keeps every finite row), without a distance scratch.

    "sorted" (unsorted=False) returns the exact (dist, id)-lexicographic
    top-k, identical to K2's cut at t0. "unsorted" keeps `select_cap(k)`
    rows by value: its k smallest distances are exact, but which ids survive
    a tie block across the k-th value is free. Both come back sorted by
    (dist, id), [nq, k] with k = min(k, n). On the card the rows are split
    into segments (`k3_segments`), a block serves `k3_geometry`'s g queries
    on one segment, and `merge_segments` merges the segments' survivors.
    Counts launches as "scan_select".
    """
    dev = _cuda_device("scan_select", luts)
    if dev is None:
        return scan_select_reference(luts, Bt, extra, k, t0)
    extra, code_bytes = _scan_inputs("scan_select", luts, Bt, extra, t0)
    nq, m, h = luts.shape
    n = Bt.shape[1]
    k = min(k, n)
    if not select_kernel_fits(k, m, h):
        raise ValueError(f"scan_select: k={k} at m={m}, h={h} exceeds one "
                         "block's shared memory (select_kernel_fits)")
    keep = select_cap(k) if unsorted else k
    if nq == 0 or k == 0:
        return (torch.empty((nq, k), dtype=torch.float32, device=dev),
                torch.empty((nq, k), dtype=torch.int32, device=dev))
    g, cap = k3_geometry(m, h, code_bytes, keep)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    segments, rows = k3_segments(n, nq, g, sms, keep)
    out_d = torch.empty((nq, segments, keep), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, segments, keep), dtype=torch.int32, device=dev)
    vec = int(n * code_bytes % 16 == 0 and Bt.data_ptr() % 16 == 0
              and extra.data_ptr() % 16 == 0)
    _build.load("scan_select").lsq_select_topk(
        luts.data_ptr(), Bt.data_ptr(), code_bytes, extra.data_ptr(),
        None if t0 is None else t0.data_ptr(), nq, m, h, n, rows, keep,
        0 if unsorted else 1, g, cap, vec, out_d.data_ptr(), out_i.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream, what="scan_select kernel launch")
    launch_counts.COUNTS["scan_select"] += 1
    return merge_segments(out_d, out_i, k)


# ---------------------------------------------------------------------------
# K4: append below t0 on truncated monotone keys of the bf16-LUT distances.


def _f32_to_key(x: torch.Tensor) -> torch.Tensor:
    """The signed-int32-monotone map of f32 bit patterns (select_pallas.py:475),
    as int64: x < y (as floats) iff key(x) < key(y); -0.0 maps to 0."""
    b = x.contiguous().view(torch.int32).long()
    return torch.where(b >= 0, b, _MININT - b)


def _key_to_f32(key: torch.Tensor) -> torch.Tensor:
    """Inverse of `_f32_to_key` (select_pallas.py:483): int64 keys -> f32."""
    b = torch.where(key >= 0, key, _MININT - key)
    return b.to(torch.int32).view(torch.float32)


def scan_key_reference(luts: torch.Tensor, Bt: torch.Tensor,
                       extra: torch.Tensor | None, t0: torch.Tensor, cap: int, *,
                       block: int = 1 << 16):
    """Plain version of K4. hi[q, i] sums the bf16-rounded LUT entries in j
    order, then extra; row i is a hit when
    (key(hi) & -(1 << 13)) < (key(t0) & -(1 << 13)). Returns (ids [nq, cap]
    int32: the first `cap` hits in ascending id order, -1 where unfilled;
    count [nq] int32: every hit, so count >= cap flags overflow)."""
    nq = luts.shape[0]
    n = Bt.shape[1]
    dev = luts.device
    hi_luts = luts.to(torch.bfloat16).float()
    t0k = _f32_to_key(t0) & _KEY_MASK  # [nq, 1]
    ids = torch.full((nq, cap + 1), -1, dtype=torch.int64, device=dev)
    count = torch.zeros((nq, 1), dtype=torch.int64, device=dev)
    for s in range(0, n, block):
        e = None if extra is None else extra[s:s + block]
        hi = lut_scan_block(hi_luts, Bt[:, s:s + block], e)
        hit = (_f32_to_key(hi) & _KEY_MASK) < t0k
        pos = count + torch.cumsum(hit, dim=1) - 1
        pos = torch.where(hit & (pos < cap), pos, cap)  # column cap: discarded
        rows = torch.arange(s, s + hi.shape[1], device=dev)[None, :].expand(nq, -1)
        ids.scatter_(1, pos, torch.where(pos < cap, rows, -1))
        count = count + hit.sum(dim=1, keepdim=True)
    return ids[:, :cap].to(torch.int32), count[:, 0].to(torch.int32)


def k4_threads(g: int) -> int:
    """Threads of a K4 block of g queries (`block_threads` of
    csrc/scan_key.cu): 32 warps where one block's tables fill the SM's
    shared memory, 16 where several blocks share an SM."""
    return 1024 if g == 32 else 512


def k4_step(g: int, kq: int, kr: int) -> int:
    """Rows a K4 block scores a step: g/kq lanes a row, kr consecutive rows a
    lane (`step_rows` of csrc/scan_key.cu)."""
    return k4_threads(g) // (g // kq) * kr


def k4_group_elems(m: int, h: int, g: int) -> int:
    """bf16 entries of one group's interleaved tables [m*h][g], rounded up to
    a whole number of 16-byte loads."""
    return -(-m * h * g // 8) * 8


def k4_smem_bytes(m: int, h: int, code_bytes: int, g: int, kq: int, kr: int,
                  steps: int) -> int:
    """Dynamic shared memory of a K4 block: one group's bf16 tables and two
    tiles, of `steps` steps each, of extra and codes. Mirrors
    `lsq_key_smem_bytes`."""
    return (2 * k4_group_elems(m, h, g)
            + 2 * steps * k4_step(g, kq, kr) * (4 + m * code_bytes))


def k4_tile_steps(m: int, h: int, code_bytes: int, g: int, kq: int, kr: int) -> int:
    """Steps a K4 block stages at once and scores between two barriers: as
    many as fit in shared memory beside the tables, 4 at most; 0 where not
    even one does."""
    room = _SMEM_LIMIT - _K4_BLOCK_RESERVE - 2 * k4_group_elems(m, h, g)
    return max(0, min(_K4_MAX_TILE_STEPS,
                      room // (2 * k4_step(g, kq, kr) * (4 + m * code_bytes))))


@functools.lru_cache(maxsize=None)
def k4_geometry(m: int, h: int, code_bytes: int, nq: int) -> tuple[int, int, int]:
    """(g, kq, kr): the queries a K4 block serves, the queries a lane serves
    by one shared-memory load (4: 8 bytes, 8: 16 bytes) and the consecutive
    rows a lane scores, or (0, 0, 0) where not even 4 queries' tables fit.
    The largest g of 32, 16, 8, 4 whose tables fit in shared memory beside
    two tiles of one step (`k4_tile_steps` then widens the tiles), then the
    smallest of those that still holds the whole batch (a lone query does
    not pay for 31 padding ones). At m=7, h=256: 32 queries a block (112 KB
    of tables) for a batch above 16. A pure function: it needs no build."""
    fits = {}
    for g in (32, 16, 8, 4):
        # The geometry that runs at this width first, then the other built
        # ones (shorter steps, for wide int32 codes).
        for geo in [(g, *_K4_LANE[g])] + [b for b in _K4_BUILT if b[0] == g]:
            if k4_tile_steps(m, h, code_bytes, *geo) >= 1:
                fits[g] = geo
                break
    if not fits:
        return 0, 0, 0
    return fits[min((g for g in fits if g >= nq), default=max(fits))]


@functools.lru_cache(maxsize=None)
def k4_segments(n: int, nq: int, g: int, tile: int, slots: int) -> tuple[int, int]:
    """(segments, rows a segment): K4's split of the n rows across blocks.
    segments x ceil(nq/g) blocks run in waves of `slots` (SMs x the blocks an
    SM holds); every block copies its group's tables in first, which costs
    about 2 tiles of scan. Of 1 .. ceil(2 slots / groups) segments, each a
    whole number of tiles, the fewest with the least waves x (tiles a segment
    + 2). A segment needs no merge: every block appends to its query's one
    list. A pure function."""
    units = -(-n // tile)
    groups = -(-nq // g)

    def cost(s: int) -> int:
        return -(-groups * s // slots) * (-(-units // s) + _K4_COLD_TILES)

    best = min(range(1, max(1, min(units, -(-2 * slots // groups))) + 1), key=cost)
    rows = -(-units // best) * tile
    return -(-n // rows), rows


def k4_interleave(luts: torch.Tensor, g: int) -> torch.Tensor:
    """K4's tables: luts [nq, m, h] f32 -> bf16 [ceil(nq/g), group_elems],
    rounded to nearest even (as `.to(torch.bfloat16)`), group b holding
    queries b*g .. b*g + g - 1 interleaved as [m*h][g] (entry (j, c) of query
    q at (j*h + c)*g + q % g), zeros for the queries past nq and in the tail
    that rounds a group up to 16 bytes. One strided copy rounds and
    transposes the whole groups, a second the last, partial one."""
    nq, m, h = luts.shape
    mh, full = m * h, nq // g
    groups = -(-nq // g)
    out = torch.zeros((groups, k4_group_elems(m, h, g)), dtype=torch.bfloat16,
                      device=luts.device)
    body = out[:, :mh * g].view(groups, mh, g)
    flat = luts.reshape(nq, mh)
    if full:
        body[:full].copy_(flat[:full * g].reshape(full, g, mh).transpose(1, 2))
    if nq > full * g:
        body[full, :, :nq - full * g].copy_(flat[full * g:].t())
    return out


def scan_key(luts: torch.Tensor, Bt: torch.Tensor, extra: torch.Tensor | None,
             t0: torch.Tensor, cap: int):
    """K4: append the ids whose bf16-LUT distance key lies below t0's, see
    `scan_key_reference` for the contract. The kernel appends in no fixed
    order; compare sorted ids. luts [nq, m, h] f32 (rounded to bf16 and
    interleaved per group of queries here, `k4_interleave`), t0 [nq, 1] f32.
    Counts launches as "scan_key"."""
    dev = _cuda_device("scan_key", luts)
    if dev is None:
        return scan_key_reference(luts, Bt, extra, t0, cap)
    extra, code_bytes = _scan_inputs("scan_key", luts, Bt, extra, t0)
    nq, m, h = luts.shape
    n = Bt.shape[1]
    if cap < 1:
        raise ValueError("scan_key: needs cap >= 1")
    g, kq, kr = k4_geometry(m, h, code_bytes, nq)
    if g == 0:
        raise ValueError(f"scan_key: m*h={m * h} bf16 LUTs of 4 queries exceed one "
                         "block's shared memory")
    steps = k4_tile_steps(m, h, code_bytes, g, kq, kr)
    smem = k4_smem_bytes(m, h, code_bytes, g, kq, kr, steps)
    ids = torch.full((nq, cap), -1, dtype=torch.int32, device=dev)
    count = torch.zeros((nq,), dtype=torch.int32, device=dev)
    if nq == 0 or n == 0:
        return ids, count
    hi = k4_interleave(luts, g)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    per_sm = max(1, min(2048 // k4_threads(g),
                        (_SMEM_LIMIT + 1024) // (smem + _K4_BLOCK_RESERVE)))
    _, rows = k4_segments(n, nq, g, steps * k4_step(g, kq, kr), sms * per_sm)
    vec = int(n * code_bytes % 16 == 0 and Bt.data_ptr() % 16 == 0
              and extra.data_ptr() % 16 == 0)
    _build.load("scan_key").lsq_scan_key(
        hi.data_ptr(), Bt.data_ptr(), code_bytes, extra.data_ptr(), t0.data_ptr(),
        nq, m, h, n, hi.shape[1], g, kq, kr, steps, rows, cap, vec, ids.data_ptr(),
        count.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        what="scan_key kernel launch")
    launch_counts.COUNTS["scan_key"] += 1
    return ids, count


def _rerank_ids(luts: torch.Tensor, Bt: torch.Tensor, extra: torch.Tensor,
                ids: torch.Tensor) -> torch.Tensor:
    """Exact f32 distances of candidate ids [nq, c] straight from the LUTs,
    the same sum as `lut_scan_block` (select_pallas.py:589); -1 ids come
    back +inf."""
    ids_c = ids.clamp(min=0).long()
    codes = Bt[:, ids_c].long()  # [m, nq, c]
    acc = torch.gather(luts[:, 0, :], 1, codes[0])
    for j in range(1, luts.shape[1]):
        acc = acc + torch.gather(luts[:, j, :], 1, codes[j])
    acc = acc + extra[ids_c]
    return torch.where(ids < 0, float("inf"), acc)


# ---------------------------------------------------------------------------
# The select API of select_pallas.py.


def select_variant(k: int) -> str:
    """The variant rule of `select_geometry` (select_pallas.py:671-676):
    "grouped" up to k=2048, "grouped_unsorted" above; the environment
    variable LSQ_TPU_SELECT_VARIANT overrides it, as in the JAX package."""
    variant = os.environ.get("LSQ_TPU_SELECT_VARIANT",
                             "grouped" if k <= 2048 else "grouped_unsorted")
    if variant not in VARIANTS:
        raise ValueError(f"LSQ_TPU_SELECT_VARIANT={variant!r} is not one of "
                         f"{VARIANTS}")
    return variant


def kernel_holds(variant: str, k: int, m: int, h: int) -> bool:
    """Whether the kernels of `variant` hold top-k at LUT shape (m, h): K2
    for the grouped variants, K3 for "sorted"/"unsorted", and K3 (the
    pre-scan and the exact fallback) for "key"."""
    if variant in ("grouped", "grouped_unsorted"):
        return scan_topk_fits(m, h)
    return select_kernel_fits(k, m, h)


def _pad_cols(d: torch.Tensor, i: torch.Tensor, k: int):
    """Pad [nq, c] results with (+inf, -1) to k columns (k > n)."""
    if d.shape[1] >= k:
        return d[:, :k], i[:, :k]
    pad = k - d.shape[1]
    return (torch.nn.functional.pad(d, (0, pad), value=float("inf")),
            torch.nn.functional.pad(i, (0, pad), value=-1))


def fused_scan_topk(luts: torch.Tensor, Bt: torch.Tensor, extra: torch.Tensor | None,
                    *, k: int, t0: torch.Tensor | None = None,
                    variant: str = "sorted", append_cap: int | None = None,
                    precision: str = "f32"):
    """Exact k-NN over the whole base: port of `select_pallas.fused_scan_topk`.

    luts [nq, m, h] f32; Bt [m, n] uint8/int32; extra [n] f32 or None. Only
    rows with distance < t0 ([nq, 1], optional) are collected.

    variant: "grouped"/"grouped_unsorted" -> K2 (cut at t0 afterwards: the
    top-k of everything, cut at t0, is the top-k of the rows below t0);
    "sorted"/"unsorted" -> K3; "key" -> K4, which needs t0, then the f32
    re-rank, the (dist, id) sort and the certificate (select_pallas.py:
    906-941), returning (dists, ids, bad) with `bad` a 0-d bool tensor.

    precision="bf16" rounds the LUTs once to bf16 (round to nearest even)
    and scans the rounded tables; it does not combine with "key", which is
    hi-only by construction.

    Returns (dists [nq, k] f32 ascending, ids [nq, k] int32), (+inf, -1)
    past the collected rows.
    """
    if precision not in ("f32", "bf16"):
        raise ValueError(f"precision must be 'f32' or 'bf16', got {precision!r}")
    if variant not in VARIANTS:
        raise ValueError(f"unknown select variant {variant!r}")
    if variant == "key":
        if t0 is None:
            raise ValueError("variant='key' requires a warm threshold t0")
        if precision == "bf16":
            raise ValueError("variant='key' is hi-only by construction; "
                             "precision='bf16' applies to the buffer variants")
    if precision == "bf16":
        luts = luts.to(torch.bfloat16).float()
    n = Bt.shape[1]
    if extra is None:
        extra = torch.zeros((n,), dtype=torch.float32, device=luts.device)
    if variant in ("grouped", "grouped_unsorted"):
        d, i = scan_topk(luts, Bt, extra, k)
        if t0 is not None:
            cut = d >= t0
            d = torch.where(cut, float("inf"), d)
            i = torch.where(cut, -1, i)
        return _pad_cols(d, i, k)
    if variant in ("sorted", "unsorted"):
        d, i = scan_select(luts, Bt, extra, k, t0, unsorted=variant == "unsorted")
        return _pad_cols(d, i, k)
    sd, si, bad = _key_scan_topk(luts, Bt, extra, k, t0, append_cap)
    return sd, si, bad.any()


def _key_scan_topk(luts: torch.Tensor, Bt: torch.Tensor, extra: torch.Tensor, k: int,
                   t0: torch.Tensor, append_cap: int | None):
    """The key variant with its certificate per query: K4's appended ids
    re-ranked in f32 and sorted by (dist, id), and bad [nq] bool, set where a
    query's k returned rows are not proven to be its exact top-k."""
    n = Bt.shape[1]
    cap = append_cap if append_cap is not None else -(-(k * 5 // 2) // 128) * 128
    ids, count = scan_key(luts, Bt, extra, t0, cap)
    exact = _rerank_ids(luts, Bt, extra, ids)
    sd, si = lex_topk(exact, ids, k)
    # Certificate: every skipped row x has key(hi(x)) & M >= key(t0) & M, so
    # hi(x) >= T_hi and exact(x) >= T_hi - err, with err bounding |hi - exact|
    # (bf16 LUT rounding, half an ulp of 2^-9 per entry over m entries, and
    # the f32 add of extra). d[k-1] < T_hi - err proves no skipped row can
    # displace the k returned; an overflowed append buffer voids it.
    t0k = (_f32_to_key(t0) & _KEY_MASK) - ((1 << _LANE_BITS) - 1)
    T_hi = _key_to_f32(t0k)
    fin = torch.isfinite(extra)
    e_max = torch.where(fin, extra.abs(), 0.0).max() if n else extra.new_zeros(())
    err = ((2.0 ** -9 + 2.0 ** -16) * luts.abs().amax(dim=2).sum(dim=1, keepdim=True)
           + 2.0 ** -23 * e_max)
    bad = (sd[:, k - 1:k] >= T_hi - err)[:, 0] | (count >= cap)
    return sd, si, bad


def warm_bound(luts: torch.Tensor, Bt: torch.Tensor, extra: torch.Tensor | None, *,
               k: int, sample_stride: int = 16, sample_rank: int | None = None,
               variant: str = "sorted", precision: str = "f32"):
    """The warm pre-scan of `scan_topk_warm`: each query's `sample_rank`-th
    distance over every `sample_stride`-th row, as t0 [nq, 1], and the key
    variant's append capacity for it (mean + 5 sd of the below-t0 count,
    select_pallas.py:1087), a multiple of 128. Returns (t0, cap)."""
    sample_rank, cap = warm_rank_cap(k, sample_stride, sample_rank)
    Bs = Bt[:, ::sample_stride].contiguous()
    es = None if extra is None else extra[::sample_stride].contiguous()
    ds, _ = fused_scan_topk(luts, Bs, es, k=sample_rank, variant=variant,
                            precision=precision)
    return ds[:, sample_rank - 1:sample_rank].contiguous(), cap


def warm_rank_cap(k: int, sample_stride: int = 16, sample_rank: int | None = None):
    """`warm_bound`'s sample rank (default k/stride + 6 sqrt(k/stride) + 1,
    rounded up) and its append capacity (rank*stride + 5 stride sqrt(rank)
    + 64, rounded up to 128): (111, 2688) at k=1000."""
    if sample_rank is None:
        kk = k / sample_stride
        sample_rank = int(math.ceil(kk + 6.0 * math.sqrt(kk) + 1.0))
    cap = int(sample_rank * sample_stride
              + 5 * sample_stride * math.sqrt(sample_rank) + 64)
    return sample_rank, -(-cap // 128) * 128


def scan_topk_warm(luts: torch.Tensor, Bt: torch.Tensor, extra: torch.Tensor | None,
                   *, k: int, sample_stride: int = 16, min_n: int = 1 << 16,
                   sample_rank: int | None = None, deferred: bool = False,
                   min_k: int = 512, variant: str = "sorted",
                   precision: str = "f32"):
    """`fused_scan_topk` with a sampled warm bound t0; always exact. Port of
    `select_pallas.scan_topk_warm`.

    Pre-scans every `sample_stride`-th row and takes each query's
    `sample_rank`-th sample distance (default k/stride + 6 sqrt(k/stride) + 1)
    as t0, a >= 6-sigma upper bound on the k-th distance. The main scan then
    keeps only rows below t0; a query whose k-th slot is >= t0 (the bound
    under-captured) is not certified and, unless `deferred`, reruns cold
    (only the queries that failed: each query's answer is its own). "key"
    carries its own certificate and falls back to "sorted".
    "grouped"/"grouped_unsorted" (K2) take their own sampled threshold and
    certify each query inside `scan_topk`, so they run here without t0 and
    return bad=None.

    deferred=True returns (dists, ids, bad), bad a 0-d bool tensor (any query
    not certified) or None; `scan_topk_warm_masked` returns the mask itself.
    """
    d, i, bad = scan_topk_warm_masked(
        luts, Bt, extra, k=k, sample_stride=sample_stride, min_n=min_n,
        sample_rank=sample_rank, min_k=min_k, variant=variant, precision=precision)
    if deferred:
        return d, i, None if bad is None else bad.any()
    if bad is not None:
        d, i, _ = rerun_uncertified(luts, Bt, extra, d, i, bad, k=k,
                                    variant="sorted" if variant == "key" else variant,
                                    precision=precision)
    return d, i


def scan_topk_warm_masked(luts: torch.Tensor, Bt: torch.Tensor,
                          extra: torch.Tensor | None, *, k: int, sample_stride: int = 16,
                          min_n: int = 1 << 16, sample_rank: int | None = None,
                          min_k: int = 512, variant: str = "sorted",
                          precision: str = "f32"):
    """`scan_topk_warm(deferred=True)` with the certificate per query:
    (dists, ids, bad), bad [nq] bool set where the query is not certified, or
    None where the call ran cold (and is exact)."""
    if precision == "bf16" and variant == "key":
        raise ValueError("variant='key' is hi-only by construction; "
                         "precision='bf16' applies to the buffer variants")
    if variant not in VARIANTS:
        raise ValueError(f"unknown select variant {variant!r}")
    n = Bt.shape[1]
    key_mode = variant == "key"
    exact_variant = "sorted" if key_mode else variant
    if (variant in ("grouped", "grouped_unsorted") or k < min_k
            or k * sample_stride * 2 > n or n < min_n):
        d, i = fused_scan_topk(luts, Bt, extra, k=k, variant=exact_variant,
                               precision=precision)
        return d, i, None
    t0, cap_hint = warm_bound(luts, Bt, extra, k=k, sample_stride=sample_stride,
                              sample_rank=sample_rank, variant=exact_variant,
                              precision=precision)
    if key_mode:
        if extra is None:
            extra = torch.zeros((n,), dtype=torch.float32, device=luts.device)
        return _key_scan_topk(luts, Bt, extra, k, t0, cap_hint)
    d, i = fused_scan_topk(luts, Bt, extra, k=k, t0=t0, variant=variant,
                           precision=precision)
    return d, i, (d[:, k - 1:] >= t0).any(dim=1)


def rerun_uncertified(luts: torch.Tensor, Bt: torch.Tensor, extra: torch.Tensor | None,
                      d: torch.Tensor, i: torch.Tensor, bad: torch.Tensor, *, k: int,
                      variant: str, precision: str = "f32"):
    """Rerun cold, through `fused_scan_topk(variant=...)`, the queries that
    `bad` [nq] marks, and put their rows into copies of (d, i). One host sync
    reads the mask. Returns (dists, ids, number of queries rerun)."""
    with span("k2.certify"):
        launch_counts.sync(bad)
        rows = torch.nonzero(bad)[:, 0]
        if rows.numel() == 0:
            return d, i, 0
        d2, i2 = fused_scan_topk(luts[rows].contiguous(), Bt, extra, k=k, variant=variant,
                                 precision=precision)
        d, i = d.clone(), i.clone()
        d[rows], i[rows] = d2, i2
    return d, i, rows.numel()
