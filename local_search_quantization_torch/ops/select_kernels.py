"""The ADC scan with a top-k select: kernels K2, K3, K4 and the select API.

Port of `local_search_quantization_tpu.ops.select_pallas`. Every version
here computes, for query q and base row i,

    dist[q, i] = sum_j luts[q, j, Bt[j, i]] + extra[i]    (j order, then extra)

in f32, the same values as `lut_scan_block`. Ids are 0-based int32; +inf
rows are never returned and empty slots are (+inf, -1).

- K2 `scan_topk` (`csrc/scan_topk.cu`; TPU `_select_kernel_grouped`): the
  exact (dist, id)-lexicographic top-k, by radix select over a distance
  scratch. Variants "grouped" and "grouped_unsorted".
- K3 `scan_select` (`csrc/scan_select.cu`; TPU `_select_kernel`): the same
  top-k cut at a warm bound t0, streamed through a per-query shared-memory
  buffer with no distance scratch. Variants "sorted" (lexicographic) and
  "unsorted" (value-exact: which ids survive a tie block across the k-th
  value is free).
- K4 `scan_key` (`csrc/scan_key.cu`; TPU `_select_kernel_key`): a scan over
  bf16-rounded LUTs that appends every id whose truncated monotone key lies
  below t0's; `fused_scan_topk(variant="key")` re-ranks them in f32 and
  certifies the result.

A wrapper runs its kernel's plain version (`*_reference`) only for tensors
on the CPU; a CUDA tensor goes to the kernel, or the call raises. Each
wrapper counts its launches in `<wrapper>.launches`.
"""

from __future__ import annotations

import ctypes
import math
import os

import torch

from local_search_quantization_torch import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
# Distance scratch per launch: at most this many f32 elements (1 GiB).
_SCRATCH_ELEMS = 1 << 28
# Shared memory one block may use on Hopper (227 KB).
_SMEM_LIMIT = 227 * 1024
# K3: rows a block scores per tile, and the static shared memory it keeps
# beside the dynamic (histogram, counters, warp offsets); csrc/scan_select.cu.
_K3_TILE = 2048
_K3_STATIC_SMEM = 2048
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


def _sort_lex(d: torch.Tensor, i: torch.Tensor):
    """Sort [nq, c] candidates by (dist, id): by id, then stably by dist."""
    i, pos = torch.sort(i, dim=1)
    d = torch.gather(d, 1, pos)
    d, pos = torch.sort(d, dim=1, stable=True)
    return d, torch.gather(i, 1, pos)


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


def scan_topk(luts: torch.Tensor, Bt: torch.Tensor, extra: torch.Tensor | None,
              k: int):
    """K2: exact lexicographic top-k ADC scan of all queries.

    luts [nq, m, h] f32; Bt [m, n] uint8 or int32 codes (each < h); extra
    [n] f32 or None. Returns (dists [nq, k] f32, ids [nq, k] int32) with
    k = min(k, n). Launches once per block of queries whose [block, n]
    distance scratch fits 1 GiB; counts launches in `scan_topk.launches`.
    """
    dev = _cuda_device("scan_topk", luts)
    if dev is None:
        return scan_topk_reference(luts, Bt, extra, k)
    nq, m, h = luts.shape
    n = Bt.shape[1]
    k = min(k, n)
    if extra is None:
        extra = torch.zeros((n,), dtype=torch.float32, device=dev)
    code_bytes = _code_bytes(Bt)
    _check("scan_topk", dev, [
        (luts, luts.dtype == torch.float32, "luts must be f32 [nq, m, h]"),
        (Bt, code_bytes is not None and Bt.shape[0] == m,
         "Bt must be uint8 or int32 [m, n]"),
        (extra, extra.dtype == torch.float32 and tuple(extra.shape) == (n,),
         "extra must be f32 [n]"),
    ])
    if n >= 1 << 31:
        raise ValueError("scan_topk: n must be < 2^31")
    if not scan_topk_fits(m, h):
        raise ValueError(f"scan_topk: m*h={m * h} LUTs exceed one block's "
                         "shared memory")
    lib = _build.load("scan_topk")
    out_d = torch.empty((nq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=dev)
    if nq == 0 or k == 0:
        return out_d, out_i
    qb = max(1, min(nq, _SCRATCH_ELEMS // n))
    dist = torch.empty((qb, n), dtype=torch.float32, device=dev)
    lib.lsq_scan_topk.argtypes = [_P, _P, _I, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P]
    lib.lsq_scan_topk.restype = _I
    stream = torch.cuda.current_stream(dev).cuda_stream
    for q0 in range(0, nq, qb):
        q1 = min(nq, q0 + qb)
        lq = luts[q0:q1]
        err = lib.lsq_scan_topk(
            lq.data_ptr(), Bt.data_ptr(), code_bytes, extra.data_ptr(), q1 - q0,
            m, h, n, k, dist.data_ptr(), out_d[q0:q1].data_ptr(),
            out_i[q0:q1].data_ptr(), stream)
        _build.check(lib, err, "scan_topk kernel launch")
        scan_topk.launches += 1
    return _sort_lex(out_d, out_i)


scan_topk.launches = 0


def scan_topk_fits(m: int, h: int) -> bool:
    """Whether K2's shared-memory LUT block (4 queries, f32) holds (m, h):
    `lsq_scan_smem_bytes` of csrc/scan_topk.cu, in Python."""
    return 16 * m * h <= _SMEM_LIMIT


def select_cap(k: int) -> int:
    """The buffer width of the TPU select kernels: max(128, ceil(k/128)*128)
    (select_pallas.py:818). K3's "unsorted" buffer keeps this many rows."""
    return max(128, -(-k // 128) * 128)


def _k3_smem_bytes(m: int, h: int, keep: int) -> int:
    """K3's dynamic shared memory: the f32 LUT (8-byte aligned) and a buffer
    of 2*keep + one tile of 64-bit (dist, id) keys. Mirrors
    `lsq_select_smem_bytes` of csrc/scan_select.cu."""
    return (4 * m * h + 7) // 8 * 8 + 8 * (2 * keep + _K3_TILE)


def select_kernel_fits(k: int, m: int, h: int) -> bool:
    """Whether K3 holds top-k at LUT shape (m, h), in both variants: the
    shared memory of its larger ("unsorted", `select_cap(k)` rows) buffer
    fits one block. A pure function: it needs no build."""
    return _k3_smem_bytes(m, h, select_cap(k)) <= _SMEM_LIMIT - _K3_STATIC_SMEM


def scan_select(luts: torch.Tensor, Bt: torch.Tensor, extra: torch.Tensor | None,
                k: int, t0: torch.Tensor | None = None, *, unsorted: bool = False):
    """K3: the top-k ADC scan of the rows with distance < t0 ([nq, 1] f32;
    None keeps every finite row), without a distance scratch.

    "sorted" (unsorted=False) returns the exact (dist, id)-lexicographic
    top-k, identical to K2's cut at t0. "unsorted" keeps `select_cap(k)`
    rows by value: its k smallest distances are exact, but which ids survive
    a tie block across the k-th value is free. Both come back sorted by
    (dist, id), [nq, k] with k = min(k, n). Counts launches in
    `scan_select.launches`.
    """
    dev = _cuda_device("scan_select", luts)
    if dev is None:
        return scan_select_reference(luts, Bt, extra, k, t0)
    nq, m, h = luts.shape
    n = Bt.shape[1]
    k = min(k, n)
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
    _check("scan_select", dev, checks)
    if n >= 1 << 31:
        raise ValueError("scan_select: n must be < 2^31")
    if not select_kernel_fits(k, m, h):
        raise ValueError(f"scan_select: k={k} at m={m}, h={h} exceeds one "
                         "block's shared memory (select_kernel_fits)")
    keep = select_cap(k) if unsorted else k
    out_d = torch.empty((nq, keep), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, keep), dtype=torch.int32, device=dev)
    if nq == 0 or k == 0:
        return out_d[:, :k], out_i[:, :k]
    lib = _build.load("scan_select")
    lib.lsq_select_topk.argtypes = [_P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I,
                                    _P, _P, _P]
    lib.lsq_select_topk.restype = _I
    err = lib.lsq_select_topk(
        luts.data_ptr(), Bt.data_ptr(), code_bytes, extra.data_ptr(),
        None if t0 is None else t0.data_ptr(), nq, m, h, n, keep,
        0 if unsorted else 1, out_d.data_ptr(), out_i.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "scan_select kernel launch")
    scan_select.launches += 1
    d, i = _sort_lex(out_d, out_i)
    return d[:, :k], i[:, :k]


scan_select.launches = 0


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


def scan_key(luts: torch.Tensor, Bt: torch.Tensor, extra: torch.Tensor | None,
             t0: torch.Tensor, cap: int):
    """K4: append the ids whose bf16-LUT distance key lies below t0's, see
    `scan_key_reference` for the contract. The kernel appends in no fixed
    order; compare sorted ids. luts [nq, m, h] f32 (rounded to bf16 here),
    t0 [nq, 1] f32. Counts launches in `scan_key.launches`."""
    dev = _cuda_device("scan_key", luts)
    if dev is None:
        return scan_key_reference(luts, Bt, extra, t0, cap)
    nq, m, h = luts.shape
    n = Bt.shape[1]
    if extra is None:
        extra = torch.zeros((n,), dtype=torch.float32, device=dev)
    code_bytes = _code_bytes(Bt)
    _check("scan_key", dev, [
        (luts, luts.dtype == torch.float32, "luts must be f32 [nq, m, h]"),
        (Bt, code_bytes is not None and Bt.shape[0] == m,
         "Bt must be uint8 or int32 [m, n]"),
        (extra, extra.dtype == torch.float32 and tuple(extra.shape) == (n,),
         "extra must be f32 [n]"),
        (t0, t0.dtype == torch.float32 and tuple(t0.shape) == (nq, 1),
         "t0 must be f32 [nq, 1]"),
    ])
    if n >= 1 << 31 or cap < 1:
        raise ValueError("scan_key: needs n < 2^31 and cap >= 1")
    if 8 * m * h > _SMEM_LIMIT:
        raise ValueError(f"scan_key: m*h={m * h} bf16 LUTs exceed one block's "
                         "shared memory")
    hi = luts.to(torch.bfloat16).contiguous()
    ids = torch.full((nq, cap), -1, dtype=torch.int32, device=dev)
    count = torch.zeros((nq,), dtype=torch.int32, device=dev)
    if nq == 0 or n == 0:
        return ids, count
    lib = _build.load("scan_key")
    lib.lsq_scan_key.argtypes = [_P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P]
    lib.lsq_scan_key.restype = _I
    err = lib.lsq_scan_key(
        hi.data_ptr(), Bt.data_ptr(), code_bytes, extra.data_ptr(), t0.data_ptr(),
        nq, m, h, n, cap, ids.data_ptr(), count.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "scan_key kernel launch")
    scan_key.launches += 1
    return ids, count


scan_key.launches = 0


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
    cap = append_cap if append_cap is not None else -(-(k * 5 // 2) // 128) * 128
    ids, count = scan_key(luts, Bt, extra, t0, cap)
    exact = _rerank_ids(luts, Bt, extra, ids)
    sd, si = _pad_cols(*_sort_lex(exact, ids), k)
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
    bad = (sd[:, k - 1:k] >= T_hi - err).any() | (count >= cap).any()
    return sd, si, bad


def warm_bound(luts: torch.Tensor, Bt: torch.Tensor, extra: torch.Tensor | None, *,
               k: int, sample_stride: int = 16, sample_rank: int | None = None,
               variant: str = "sorted", precision: str = "f32"):
    """The warm pre-scan of `scan_topk_warm`: each query's `sample_rank`-th
    distance over every `sample_stride`-th row, as t0 [nq, 1], and the key
    variant's append capacity for it (mean + 5 sd of the below-t0 count,
    select_pallas.py:1087), a multiple of 128. Returns (t0, cap)."""
    if sample_rank is None:
        kk = k / sample_stride
        sample_rank = int(math.ceil(kk + 6.0 * math.sqrt(kk) + 1.0))
    Bs = Bt[:, ::sample_stride].contiguous()
    es = None if extra is None else extra[::sample_stride].contiguous()
    ds, _ = fused_scan_topk(luts, Bs, es, k=sample_rank, variant=variant,
                            precision=precision)
    cap = int(sample_rank * sample_stride
              + 5 * sample_stride * math.sqrt(sample_rank) + 64)
    return ds[:, sample_rank - 1:sample_rank].contiguous(), -(-cap // 128) * 128


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
    keeps only rows below t0; if any query's k-th slot is >= t0 (the bound
    under-captured), the result is not certified (`bad`) and, unless
    `deferred`, reruns cold. "key" carries its own certificate and falls
    back to "sorted". "grouped"/"grouped_unsorted" (K2) need no warm bound:
    their radix select costs the same either way, so they run cold and
    return bad=None.

    deferred=True returns (dists, ids, bad), bad a 0-d bool tensor or None.
    """
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
        return (d, i, None) if deferred else (d, i)
    t0, cap_hint = warm_bound(luts, Bt, extra, k=k, sample_stride=sample_stride,
                              sample_rank=sample_rank, variant=exact_variant,
                              precision=precision)
    if key_mode:
        d, i, bad = fused_scan_topk(luts, Bt, extra, k=k, t0=t0, variant="key",
                                    append_cap=cap_hint)
    else:
        d, i = fused_scan_topk(luts, Bt, extra, k=k, t0=t0, variant=variant,
                               precision=precision)
        bad = (d[:, k - 1:] >= t0).any()
    if deferred:
        return d, i, bad
    if bool(bad):
        return fused_scan_topk(luts, Bt, extra, k=k, variant=exact_variant,
                               precision=precision)
    return d, i
