"""Asymmetric-distance (ADC) k-NN query for additive codes (port of `ops/adc.py`).

The per-query LUT build is one einsum; `_run_scan` lays the codes out as
[m, n] on the device and routes the scan and its top-k:

- "kernel": the select kernels of `select_kernels` (K2, K3, K4), chosen by
  `select_variant(k)`, with the warm start, its certificate and the deep-k
  widen of the JAX package;
- "tournament"/"twopass": the group-minima tournament with its tie
  certificate; tied queries rerun through "exact";
- "exact": the streaming merge (K2's plain version);
- "native": the host C++ scanner (`utils/native.py`), for CPU tensors;
- "approx"/"approx:r": torch has no approx_max_k, so these take the exact
  merge, which meets any recall target.

Every route returns the exact (dist, id)-lexicographic top-k: dists [nq, k]
f32 ascending, ids [nq, k] int32, 0-based; a +inf slot carries id -1.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from local_search_quantization_torch.ops import launch_counts
from local_search_quantization_torch.ops.select_kernels import (
    fused_scan_topk,
    kernel_holds,
    lex_topk,
    lut_scan_block,
    rerun_uncertified,
    scan_topk_reference,
    scan_topk_warm_masked,
    select_variant,
)
from local_search_quantization_torch.utils.profiling import span

__all__ = ["KNNResult", "TIE_SLACK", "linscan_lsq", "linscan_opq",
           "linscan_pq", "lsq_query_luts", "lut_scan_block", "pq_query_luts",
           "prepare_device_codes", "scan_topk_routed"]

# Relative slack of the tournament's recompute-mode certificate, scaled by
# the summand magnitudes (m LUT maxima + the largest finite extra). The JAX
# package writes 3e-5 in its certificate (adc.py:382) but gates its chip
# check at 5e-5 (scripts/tpu_smoke.py:157); here both read this one value.
TIE_SLACK = 3e-5

_METHODS = ("auto", "kernel", "native", "exact", "tournament", "twopass")


class KNNResult(NamedTuple):
    dists: torch.Tensor  # [nq, k] ascending estimated (squared) distances
    ids: torch.Tensor  # [nq, k] int32, 0-based base indices


def pq_query_luts(Q: torch.Tensor, C_sub: torch.Tensor) -> torch.Tensor:
    """Per-query subspace distance tables for PQ/OPQ codes:
    luts[q, i, c] = ||q_sub_i - C_sub[i, c]||^2, Q [nq, d] -> [nq, m, h].

    C_sub uses the zero-padded subspace layout, so padded dims add 0.
    """
    from local_search_quantization_torch.ops.subspaces import split_subspaces

    Qs = split_subspaces(Q, C_sub.shape[0]).transpose(0, 1)  # [nq, m, ds]
    cross = torch.einsum("qis,ihs->qih", Qs, C_sub)
    qsq = torch.sum(Qs * Qs, dim=-1)  # [nq, m]
    csq = torch.sum(C_sub * C_sub, dim=-1)  # [m, h]
    return qsq[:, :, None] - 2.0 * cross + csq[None, :, :]


def lsq_query_luts(Q: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """luts[q, i, c] = -2 * q . C[i, c]: Q [nq, d], C [m, h, d] -> [nq, m, h]."""
    return -2.0 * torch.einsum("qd,ihd->qih", Q, C)


def _check_mode(mode: str) -> None:
    # "matmul" and "gather" give the same f32 sums in j order: the one-hot
    # matmul of the JAX package is a TPU idiom.
    if mode not in ("matmul", "gather"):
        raise ValueError(f"mode must be 'matmul' or 'gather', got {mode!r}")


def _scan_topk(luts: torch.Tensor, Bt: torch.Tensor, extra: torch.Tensor | None,
               k: int, block: int, mode: str = "matmul",
               topk_method: str = "exact") -> KNNResult:
    """Streaming exact top-k of one query chunk over [m, n] codes: K2's plain
    version, exactly (dist, id)-lexicographic. "approx"/"approx:r" are exact
    here (torch has no approx_max_k)."""
    _check_mode(mode)
    if Bt.shape[1] % block:
        raise ValueError(f"n={Bt.shape[1]} must be a multiple of block={block}")
    return KNNResult(*scan_topk_reference(luts, Bt, extra, k, block=block))


def _pick_group(n: int, k: int) -> int:
    """Tournament group width ~= sqrt(n/k): balances the two selections
    (n/group minima vs k*group candidates). Power of two in [8, 256]."""
    g = 8
    while g < 256 and g * g * k < n:
        g *= 2
    return g


def _scan_topk_tournament(luts: torch.Tensor, Bt: torch.Tensor,
                          extra: torch.Tensor | None, k: int, block: int,
                          mode: str = "matmul", group: int | None = None,
                          store_dists: bool = True, certify: bool = False):
    """Value-exact top-k by a group-minima tournament (adc.py:204-385).

    Pass 1 streams the distance tiles and keeps each group's minimum; the
    kg = min(k, n/group) groups with the smallest minima hold every top-k
    row (ties only swap equal values). Pass 2 selects within their
    kg*group candidates: gathered from the stored [nq, n] distances
    (store_dists) or recomputed from the codes (O(1) extra memory).

    certify=True returns (KNNResult, tied [nq] bool). A query is untied
    when d[k-1] is below the best losing group's minimum T' (nothing
    skipped can displace or tie it) and below d[k] (the cut inside the
    candidates is unambiguous); its result is then the exact lexicographic
    top-k. In recompute mode T' gets a slack of TIE_SLACK times the summand
    magnitudes; the port sums candidates in the same order as the tiles, so
    the slack only over-flags.
    """
    _check_mode(mode)
    nq = luts.shape[0]
    n = Bt.shape[1]
    dev = luts.device
    if n % block:
        raise ValueError(f"n={n} must be a multiple of block={block}")
    if group is None:
        group = _pick_group(n, k)
    group = min(group, block)
    ngroups = n // group
    gmins = torch.empty((nq, ngroups), dtype=torch.float32, device=dev)
    dists = (torch.empty((nq, n), dtype=torch.float32, device=dev)
             if store_dists else None)
    for s in range(0, n, block):
        e = None if extra is None else extra[s:s + block]
        tile = lut_scan_block(luts, Bt[:, s:s + block], e)
        gmins[:, s // group:(s + block) // group] = (
            tile.view(nq, block // group, group).amin(dim=-1))
        if store_dists:
            dists[:, s:s + block] = tile
    kg = min(k, ngroups)
    if certify and kg < ngroups:
        gv, gidx = torch.topk(gmins, kg + 1, dim=1, largest=False)
        tprime = gv[:, kg]  # the best losing group's minimum
        gidx = gidx[:, :kg]
    else:
        _, gidx = torch.topk(gmins, kg, dim=1, largest=False)
        tprime = torch.full((nq,), float("inf"), device=dev)
    cand_idx = (gidx[:, :, None] * group
                + torch.arange(group, device=dev)[None, None, :]).reshape(nq, -1)
    if store_dists:
        cand = torch.gather(dists, 1, cand_idx)
    else:
        codes = Bt[:, cand_idx].long()  # [m, nq, C]
        cand = torch.gather(luts[:, 0, :], 1, codes[0])
        for j in range(1, luts.shape[1]):
            cand = cand + torch.gather(luts[:, j, :], 1, codes[j])
        if extra is not None:
            cand = cand + extra[cand_idx]
    k_req = k + 1 if certify else k
    d, pos = torch.topk(cand, k_req, dim=1, largest=False)
    # Retained equal distances ascend by id; which tie-mates survive the
    # k-th value is what the certificate checks.
    d, ids = lex_topk(d, torch.gather(cand_idx, 1, pos).to(torch.int32), k_req)
    if not certify:
        return KNNResult(d, ids)
    if store_dists:
        at_bound = d[:, k - 1] >= tprime
    else:
        qscale = luts.abs().amax(dim=2).sum(dim=1)
        if extra is not None:
            qscale = qscale + torch.where(torch.isfinite(extra), extra.abs(), 0.0).max()
        at_bound = d[:, k - 1] >= tprime - TIE_SLACK * qscale
    tied = torch.isfinite(d[:, k - 1]) & ((d[:, k - 1] == d[:, k]) | at_bound)
    return KNNResult(d[:, :k], ids[:, :k]), tied


def _code_dtype(B: torch.Tensor, h: int | None) -> torch.dtype:
    if h is None:
        byte = B.dtype == torch.uint8 or B.numel() == 0 or int(B.max()) < 256
    else:
        byte = h <= 256
    return torch.uint8 if byte else torch.int32


def prepare_device_codes(B, extra=None, *, base_block: int = 1 << 16,
                         device="cpu", h: int | None = None):
    """Upload codes once for repeated scans over an unchanged base.

    Returns the `device_state` that `_run_scan`/`linscan_*` take: the
    transposed [m, n_padded] codes on `device` (uint8 when h <= 256, int32
    above; h defaults to the codes' range) and the extra term padded with
    +inf (None when there is neither extra nor padding), n padded to a
    multiple of `base_block`. Padded rows can never win a scan. Build it
    with the `base_block` the scan call uses.
    """
    B = torch.as_tensor(B)
    n, m = B.shape
    dtype = _code_dtype(B, h)
    pad = (-n) % base_block
    Bt = torch.zeros((m, n + pad), dtype=dtype, device=device)
    launch_counts.copy(B, device)
    Bt[:, :n] = B.to(dtype).to(device).t()
    if extra is None and not pad:
        return Bt, None
    ex = torch.full((n + pad,), float("inf"), dtype=torch.float32, device=device)
    if extra is None:
        ex[:n] = 0.0
    else:
        extra = torch.as_tensor(extra)
        launch_counts.copy(extra, device)
        ex[:n] = extra.to(device, torch.float32)
    return Bt, ex


def cuda_route(k: int, n: int, m: int, h: int) -> str:
    """The route "auto" takes on a CUDA device: "kernel" when 4k < n and the
    kernels of `select_variant(k)` hold k (+1 for the widen of the unsorted
    flavours) at LUT shape (m, h); else "tournament" when 4k < n; else
    "exact". (The JAX package's 10240 bound is the v5e's VMEM envelope.)"""
    if 4 * k >= n:
        return "exact"
    variant = select_variant(k)
    widen = variant in ("unsorted", "grouped_unsorted")
    return "kernel" if kernel_holds(variant, k + widen, m, h) else "tournament"


def _run_scan(luts_fn, Q, B, *, k: int, extra=None, query_chunk: int = 256,
              base_block: int = 1 << 16, mode: str = "matmul",
              topk_method: str = "auto", base_segment: int = 1 << 26,
              precision: str = "f32", device_state=None) -> KNNResult:
    """Build the LUTs, lay the codes out as [m, n] on Q's device, scan, select.

    B [n, m] codes (host array or tensor); extra [n] or None. topk_method:

    - "auto": on a CUDA device "kernel" when 4k < n and the kernels of
      `select_variant(k)` hold k (`kernel_holds`), else "tournament" when
      4k < n, else "exact"; on the CPU "native" when the host scanner is
      built and takes the codes (byte range, m <= 32), else "exact";
    - "kernel", "tournament"/"twopass", "exact", "native", "approx[:r]":
      see the module docstring.

    precision="bf16" rounds the LUTs once to bf16 (round to nearest even)
    here, so every route scans the same rounded tables; the result is the
    exact top-k of those distances. mode "matmul"/"gather" are accepted and
    compute the same sums. Bases above `base_segment` rows are scanned a
    segment at a time and merged by `lex_topk`; a (+inf, -1) sentinel is
    never offset into a real id. device_state
    (`prepare_device_codes`) skips the per-call upload; it must match the
    base and `base_block`, and does not apply to the segmented path.
    """
    if precision not in ("f32", "bf16"):
        raise ValueError(f"precision must be 'f32' or 'bf16', got {precision!r}")
    _check_mode(mode)
    if topk_method not in _METHODS and not topk_method.startswith("approx"):
        raise ValueError(f"unknown topk_method {topk_method!r}")
    if precision == "bf16":
        inner_luts_fn = luts_fn

        def luts_fn(q):
            return inner_luts_fn(q).to(torch.bfloat16).float()

    Q = torch.as_tensor(Q)
    if Q.is_floating_point() and Q.dtype != torch.float32:
        Q = Q.float()
    dev = Q.device
    n = B.shape[0]
    k = min(k, n)
    if device_state is not None:
        exp = n + (-n) % base_block
        if device_state[0].shape[1] != exp:
            raise ValueError(
                f"device_state was prepared for a different base/base_block "
                f"(codes dim {device_state[0].shape[1]}, expected {exp}): "
                f"rebuild it with prepare_device_codes after any mutation")
        if n > base_segment:
            raise ValueError("device_state does not apply to the segmented "
                             ">base_segment streaming path")
    if n > base_segment:
        dists, ids = [], []
        for s0 in range(0, n, base_segment):
            s1 = min(s0 + base_segment, n)
            seg = _run_scan(luts_fn, Q, B[s0:s1], k=min(k, s1 - s0),
                            extra=None if extra is None else extra[s0:s1],
                            query_chunk=query_chunk, base_block=base_block,
                            mode=mode, topk_method=topk_method,
                            base_segment=base_segment, precision=precision)
            dists.append(seg.dists)
            ids.append(torch.where(seg.ids >= 0, seg.ids + s0, -1).to(torch.int32))
        return KNNResult(*lex_topk(torch.cat(dists, dim=1), torch.cat(ids, dim=1), k))
    if topk_method == "native" or (topk_method == "auto" and dev.type == "cpu"):
        from local_search_quantization_torch.utils import native as _nat

        Bn = B.cpu().numpy() if isinstance(B, torch.Tensor) else np.asarray(B)
        native_ok = (_nat.available() and Bn.shape[1] <= 32
                     and (Bn.dtype == np.uint8 or Bn.size == 0
                          or (Bn.min() >= 0 and Bn.max() < 256)))
        if topk_method == "native" and not native_ok:
            raise ValueError("topk_method='native' needs the native library "
                             "(make -C native) and codes in [0, 256)")
        if native_ok:
            with span("index.search.luts"):
                luts = luts_fn(Q).cpu().numpy().astype(np.float32)
            ex = None if extra is None else np.asarray(
                extra.cpu() if isinstance(extra, torch.Tensor) else extra, np.float32)
            d, i = _nat.linscan(luts, Bn.astype(np.uint8, copy=False), ex, k)
            return KNNResult(torch.as_tensor(d).to(dev),
                             torch.as_tensor(i.astype(np.int32)).to(dev))
    with span("index.search.luts"):
        luts = luts_fn(Q).contiguous()
    if device_state is not None:
        Bj, extraj = device_state
    else:
        Bj, extraj = prepare_device_codes(B, extra, base_block=base_block,
                                          device=dev, h=luts.shape[2])
    return scan_topk_routed(luts, Bj, extraj, k, topk_method=topk_method, n=n,
                            query_chunk=query_chunk, base_block=base_block,
                            mode=mode, precision=precision)


def scan_topk_routed(luts: torch.Tensor, Bt: torch.Tensor, extra: torch.Tensor | None,
                     k: int, *, topk_method: str = "auto", n: int | None = None,
                     query_chunk: int = 256, base_block: int = 1 << 16,
                     mode: str = "matmul", precision: str = "f32") -> KNNResult:
    """The exact (dist, id)-lexicographic top-k of LUTs [nq, m, h] over codes
    Bt [m, n_padded] (+inf `extra` on pad rows) on the LUTs' device, by the
    kernel, tournament or exact route: `_run_scan`'s scan, and each shard's
    in `parallel.query.sharded_scan_topk`.

    n is the number of real rows (default: all of Bt's columns); "auto" takes
    `cuda_route(k, n, m, h)` on a CUDA device and "exact" on the CPU. The
    kernel route's warm start, certificate and deep-k widen, and the
    tournament's tie certificate, rerun their tied queries here, so every
    route's result is exact. k <= n.
    """
    nq, m, h = luts.shape
    dev = luts.device
    if n is None:
        n = Bt.shape[1]
    if topk_method == "auto":
        topk_method = cuda_route(k, n, m, h) if dev.type == "cuda" else "exact"
    if topk_method == "kernel":
        extra_arr = extra if extra is not None else torch.zeros(
            Bt.shape[1], dtype=torch.float32, device=dev)
        variant = select_variant(k)
        # The replace-worst flavours keep a value-strict threshold: one extra
        # column and d[k-1] < d[k] prove no boundary tie-mate was skipped;
        # tied queries rerun through the lexicographic "grouped" (K2).
        widen = variant in ("unsorted", "grouped_unsorted") and k < n
        k_req = k + 1 if widen else k
        d, i, bad = scan_topk_warm_masked(luts, Bt, extra_arr, k=k_req,
                                          variant=variant, precision=precision)
        if bad is not None:
            # Only the queries that fail their certificate rerun cold.
            d, i, rerun = rerun_uncertified(
                luts, Bt, extra_arr, d, i, bad, k=k_req,
                variant="sorted" if variant == "key" else variant, precision=precision)
            launch_counts.COUNTS["rerun_warm"] += rerun
        if widen:
            tied = (d[:, k - 1] == d[:, k]) & torch.isfinite(d[:, k - 1])
            d, i = d[:, :k].clone(), i[:, :k].clone()
            with span("k2.certify"):
                launch_counts.sync(tied)
                tq = torch.nonzero(tied)[:, 0]
                if tq.numel():
                    launch_counts.COUNTS["rerun_widen"] += tq.numel()
                    d2, i2 = fused_scan_topk(luts[tq], Bt, extra_arr, k=k,
                                             variant="grouped", precision=precision)
                    d[tq], i[tq] = d2, i2
        return KNNResult(d, i)

    tournament = topk_method in ("tournament", "twopass") and 4 * k < Bt.shape[1]
    store = (query_chunk * Bt.shape[1] <= (1 << 28)
             and os.environ.get("LSQ_TPU_TOPK_STORE", "1") == "1")
    out_d, out_i = [], []
    for s in range(0, nq, query_chunk):
        lc = luts[s:s + query_chunk]
        if tournament:
            (d, i), tied = _scan_topk_tournament(lc, Bt, extra, k, base_block,
                                                 mode=mode, store_dists=store,
                                                 certify=True)
            with span("k2.certify"):
                launch_counts.sync(tied)
                tq = torch.nonzero(tied)[:, 0]
                if tq.numel():
                    launch_counts.COUNTS["rerun_tournament"] += tq.numel()
                    fix = _scan_topk(lc[tq], Bt, extra, k, base_block, mode=mode)
                    d, i = d.clone(), i.clone()
                    d[tq], i[tq] = fix.dists, fix.ids
        else:
            d, i = _scan_topk(lc, Bt, extra, k, base_block, mode=mode)
        out_d.append(d)
        out_i.append(i)
    return KNNResult(torch.cat(out_d), torch.cat(out_i))


def linscan_pq(B, Q: torch.Tensor, C_sub: torch.Tensor, k: int = 10000,
               **kw) -> KNNResult:
    """ADC k-NN for PQ codes: B [n, m], Q [nq, d], C_sub [m, h, ds]."""
    return _run_scan(lambda q: pq_query_luts(q, C_sub), Q, B, k=k, **kw)


def linscan_opq(B, Q: torch.Tensor, C_sub: torch.Tensor, R: torch.Tensor,
                k: int = 10000, **kw) -> KNNResult:
    """ADC k-NN for OPQ codes: rotate the queries into code space (Q @ R),
    then scan as PQ."""
    return linscan_pq(B, Q @ R, C_sub, k, **kw)


def linscan_lsq(B, Q: torch.Tensor, C: torch.Tensor, db_norms, k: int = 10000,
                R: torch.Tensor | None = None, **kw) -> KNNResult:
    """ADC k-NN for additive codes with separately quantized norms.

    dist[q, n] = -2 sum_i q.C[i, B[n, i]] + ||recon_n||^2, a rank-preserving
    surrogate of the squared distance. db_norms: [n] float32.
    """
    Qr = Q @ R if R is not None else Q
    return _run_scan(lambda q: lsq_query_luts(q, C), Qr, B, k=k,
                     extra=db_norms, **kw)
