#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: build, check, drive, report.

    python3 chip_smoke.py

Run from the root of a checkout. Needs a CUDA device and nvcc; imports
nothing of JAX. Phases:

1. the card (nvidia-smi name and power limit), torch and CUDA versions, and
   the build of every kernel in `local_search_quantization_torch/csrc/`,
   one nvcc per source, all started together;
2. K1 (the whole-ILS encode kernel) against its plain PyTorch version on the
   same streamed randomness: an integer fixture and the SIFT width
   (n=131072, d=128, m=7, h=256, ilsiter=4, icmiter=4, npert=4). Codes,
   costs, milestones and counts must be identical: both sum in one fixed
   order and break ties to the lowest index;
2b. K5 and K6 (the per-round ICM sweeps kernels, variants "v2" and "v1")
   against their plain versions on the same codes: an integer fixture
   (n=8192), three other lane maps (m=5 at h=40, no multiple of 32; h=300,
   16 candidates a lane loaded element by element with a masked tail; h=512,
   two 16-byte loads a lane a row) and the SIFT width (n=131072, icmiter=4,
   trained codebooks). Codes must be identical;
2c. K7 (K5's visit dissected: variants "full", "predwrite", "nowrite",
   "noargmin", "mmonly") against its plain version, at the integer fixture
   and at the SIFT width of phase 2b: codes identical, the per-row sink
   identical for "nowrite" and within 1e-5 for the score sums, "full"
   identical to K5; each variant's time on a table stacked once, beside
   K5's and K6's wrappers in the same phase; K5 at each stage of its
   redesign (`icm_sweeps_step`: the first port's visit, the same with its
   loads hoisted, the packed kernel that runs), codes identical, timed in
   turns; and for every one of these builds its registers (ptxas), the
   table loads in its SASS and how many of them the schedule serializes
   (cuobjdump): the builds that run must show a visit's 8 row loads with
   none serialized;
2d. the L2 gather probe (`csrc/l2_probe.cu`): its sums against its plain
   version, then the rate at which L2 serves random 512 B bf16 rows of a
   6.4 MB table (K5, K6) and 1 KB f32 rows of a 12.8 MB table (K1), one
   element and 16 bytes a lane, and the practical bound in ms it gives K1,
   K5 and K6 (their gathered bytes over the better of the two rates);
3. K2 (the ADC scan + exact top-k) against its plain version over a
   1M-row base, 1000 queries at k=1000 (the main path's query shape): ids
   and dists identical, for uint8 and int32 code layouts. Then, at nq = 1,
   32 and 1000 and k = 1000 and 10001, both layouts: K2 identical to its
   plain version and to K3 "sorted", with no query failing its certificate
   (the dense path idle); at nq=1000 `k2_filter` (counts, key sets) and
   `k2_select` (dists, ids, certificate) against their plain versions; its
   time beside the dense path's (PR 1's K2) in the same run, the split into
   pre-scan, `k2_filter` and `k2_select`, peak memory, the bounds, and
   `torch.topk` over the materialised distances (the select half only, as
   a yardstick). Then the staged and the dense path at n = 16k, 32k and
   64k rows, identical and timed side by side (the staged path's floor);
3b. K3 (the streamed select) on K2's inputs: "sorted" cold, "unsorted" cold
   and "sorted" with the warm bound t0 of `scan_topk_warm`, against its
   plain version (dists on every row; ids on every row for "sorted", on the
   rows whose k-th value is not tied for "unsorted") and against K2, at nq
   1, 32 and 1000 on uint8 and int32 codes and on a base of 300,007 rows
   (no multiple of 16: element-wise staging, a ragged last tile); its times
   at each nq, the pre-scan's, the bytes its design reads from L2, and peak
   device memory beside K2's;
3c. K4 (the key append) on the same inputs with the warm t0: appended id
   sets and counts identical to the plain version at nq 1, 32 and 1000 on
   uint8 and int32 codes, on a base of 300,007 rows, at m=5, h=40, and with
   a cap that overflows (counts identical, the ids `cap` distinct hits);
   the key variant's per-query certificate, its certified queries identical
   to K2's and `scan_topk_warm` (which reruns the others on K3) identical
   on all; its times at each nq beside the first port's and beside the
   shared-memory bytes its lookups must read; and the width of the
   shared-memory loads in its SASS (cuobjdump): the table lookups must be
   8- or 16-byte loads;
4. main path A through `demos/demo_lsq_torch.py`'s functions on the
   synthetic SIFT-statistics corpus (100k train, 1M base, 1000 queries):
   OPQ -> ChainQ -> LSQ training (m=7, h=256, niter=10, ilsiter=8) with
   condition_mode "auto" (K1), an LSQ-16 base encode, norm quantization, the
   k=1000 ADC query (K2) and recall;
4b. main path B: LSQ trained again from path A's OPQ/ChainQ result with
   condition_mode "fused" (K5 in every ILS round), the base encoded with
   "fused", then norms, query and recall as in path A.
4c. main path C, the serving path: `Index.build("lsq", refine="sq8")` on
   the same corpus, `build_ivf(nlist=1024)`, `save` and `Index.load` (codes,
   model and partition identical), then `search` at k=1000 on every route:
   the default (K2), the select variants "sorted" and "unsorted" (K3, warm;
   "unsorted" with the widen) and "key" (K4, its pre-scan on K3, the
   queries that fail its certificate rerun on K3), the tournament in store
   and in recompute mode, and "exact"; precision "bf16" on the default,
   sorted and exact routes; k=10000 on K2, the tournament and K3; refine;
   `search(nprobe=p)` for p = 1, 8, 32 and 1024 (each p's ms, qps, recall
   and peak memory; at p = 1024 the default route's distances and ids;
   recall@10 never falling as p grows; no pad row returned); then delete
   (no probed search returns a deleted id), add (the new rows found through
   the tail) and compact (the full probe still the exhaustive search).
   The counters over `Index.build` plus one 1000-query search at k=1000
   are printed as the main path's launches.
   In each path the kernels' launch counters are zeroed just before it and
   the path's kernels must be > 0 after it; the accept invariant, the
   recall curve and a plain-version check of the query results must hold.
   Path C's f32 routes must return identical ids, and its bf16 routes too.
4d. path D, the encoder benchmark path: the bench twins' functions at full
   size (`benchmarks.bench_kernel_variants`, `benchmarks.bench` and
   `benchmarks.bench_icm_phases` of `local_search_quantization_torch`);
   K7 must launch in every variant, and K1 and K5 must launch.
4e. path E, the serving command line as a user runs it, in subprocesses:
   the build twin (`scripts/build_index.py` of the port: LSQ m=7 + norm
   byte, h=256, niter=10, ilsiter=16, IVF nlist=1024, sq8 refine, over the
   same synthetic corpus: 100k train, 1M base); the eval twin (recall@1/10/
   100/1000 within 0.01 of path C's default route); the serve twin (its
   stderr must name the card and the kernels its warm-up built): 200 JSON
   requests of 1 query and 50 of 16 at k=100 (client p50/p99 ms), the four
   protocol modes of the `bench_serve` twin at nq=2048, batch 256, k=100
   (qps against the direct search), binary requests of 1000 queries at
   k=1000, bf16 k=100, refine=10, nprobe=32 and of 100 queries at k=10000
   (each sent twice); a second server under LSQ_TPU_SELECT_VARIANT=key
   (ids identical); add of 10,000 rows in one frame, delete of the 10
   nearest ids of query 0, a query, compact and save. Each server counts
   its requests' kernel launches (from 0 after its warm-up) and writes them
   to stderr at EOF: the first must launch K1 (add), K2 and K3, the key
   server K4, and these counts are path E's launches. Then every served
   request again through `Index.search` on the index as built, in this
   process, its ids and distances identical to the served ones bit for bit
   (parity only), and the saved directory reloaded (n = 1,009,990, its
   codes the replay's, the added rows found).
4f. path F, the rest of the quantizer family, on path A's corpus and
   results (counters zeroed first; K1, K2 and K3 must each launch):
   F1 `update_codebooks(method="lsqr")` on path A's final training codes
   against "cholesky" (qerror within x (1 + 1e-3), two LSQR solves bit for
   bit, each timed), SLSQ's prox solve from the Cholesky codebooks into
   0.7 of their L1 norm (inside the ball, two solves bit for bit, timed),
   then LSQ trained with LSQR (niter=10, ilsiter=8,
   "auto" = K1) from path A's ChainQ, an LSQ-16 base encode and the k=1000
   query (K2), recall@10 within 0.03 of path A's; F2 `Index.build("rvq")`
   (m=7 + norm byte, h=256, niter=10): `quantize_rvq` of the training set
   gives the training codes, a k=1000 search identical to
   `scan_topk_reference` on the same LUTs, save -> load searches alike, add
   of 10,000 rows found by their own vectors (>= 99% in their top-1000);
   F3 the `repro_paper` twin in process on path A's corpus (written as its
   corpus cache): PQ, OPQ, ChainQ, LSQ-16, LSQ-32, RVQ, SLSQ1, SLSQ2 at
   niter=10 with the twin's own ordering check, SLSQ l0 within S and
   SLSQ1's below dense; then the `diag_normbyte` twin on its stage cache
   (two 1M-row scans on K2); F4 the demo twins (`demo_pq_torch`,
   `demo_opq_torch`, `demo_chainq_torch`, `demo_lsq_sparse_torch`) and
   the `calibrate_corpus` and `diag_flip` twins at 2000 train, 20,000
   base, 200 queries, each recall curve never decreasing (a run-only
   check: LSQ over-fits 2000 training vectors, so these curves do not
   hold the twins' numbers to anything). Prints each
   part's wall time, path F's and the whole script's.

Prints the kernels' JSON line and then, last, the device line. Any failed
check exits non-zero before those lines are printed. Every time is printed
beside the card's name and power limit. Each kernel's bound is the larger
of its operations at the card's f32 peak and its bytes (inputs read once,
outputs written once) at its memory rate, from the run's shapes.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# SIFT width of the K1 check and the main path.
D, M, H = 128, 7, 256
K1_N, K1_ROUNDS, ICMITER, NPERT = 131072, 4, 4, 4
# The kernels' source files, and the TPU kernel bodies they replace.
KERNELS = {
    "ils_encode": ("local_search_quantization_torch/csrc/ils_encode.cu",
                   "local_search_quantization_tpu/ops/icm_pallas.py:336"),
    "scan_topk": ("local_search_quantization_torch/csrc/scan_topk.cu",
                  "local_search_quantization_tpu/ops/select_pallas.py:226"),
    "icm_sweeps_v2": ("local_search_quantization_torch/csrc/icm_sweeps.cu",
                      "local_search_quantization_tpu/ops/icm_pallas.py:81"),
    "icm_sweeps_v1": ("local_search_quantization_torch/csrc/icm_sweeps.cu",
                      "local_search_quantization_tpu/ops/icm_pallas.py:37"),
    "scan_select": ("local_search_quantization_torch/csrc/scan_select.cu",
                    "local_search_quantization_tpu/ops/select_pallas.py:123"),
    "scan_key": ("local_search_quantization_torch/csrc/scan_key.cu",
                 "local_search_quantization_tpu/ops/select_pallas.py:488"),
    "icm_sweeps_dissect": ("local_search_quantization_torch/csrc/icm_sweeps.cu",
                           "benchmarks/bench_kernel_variants.py:50"),
}
K2_N, K2_QUERIES, K = 1_000_000, 1000, 1000
# The card's name and power limit (nvidia-smi), printed beside every time.
CARD = "not read"
MAIN = dict(ntrain=100_000, nbase=1_000_000, nquery=1000, niter=10, ilsiter_base=16)
# One H100 SXM's published peaks (NVIDIA's data sheet, dense, at 700 W): f32
# outside the tensor cores, and device memory. The f32 rate counts an FMA as
# two operations; the scans' adds and compares are one each and issue at
# half of it, so their "operations" bounds are half what the card can reach.
# Shared memory issues one 32-lane lookup an SM a clock, 128 bytes: 132 SMs
# at the 1.98 GHz boost clock.
PEAK_F32, HBM = 67e12, 3.35e12
SMEM_LOOKUPS = 132 * 32 * 1.98e9
SMEM_BYTES = 132 * 128 * 1.98e9


def roofline_ms(ops: float, nbytes: float):
    """(bound ms, "operations" or "bytes"): the larger of the operations at
    the f32 peak and the bytes at the memory rate."""
    t_ops, t_bytes = ops / PEAK_F32 * 1e3, nbytes / HBM * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def scan_bound(nq, n, k, code_bytes, lut_bytes=4, out_bytes=8):
    """K2's and K3's (and, with bf16 LUTs and id outputs, K4's) roofline: m
    adds (the j sum and extra) and one compare a (query, row); LUTs, codes
    and extra read once; the [nq, k] output written once."""
    return roofline_ms(nq * n * (M + 1), nq * M * H * lut_bytes + M * n * code_bytes
                       + 4 * n + nq * k * out_bytes)


def icm_bound(n, visits_per_row, table_bytes, extra_bytes):
    """K1's and K5/K6's roofline: a visit scores h candidates with m - 1
    adds and one compare each; the [n, m, h] f32 unaries, the pair table and
    the codes read once, the codes written once, plus `extra_bytes`."""
    return roofline_ms(n * visits_per_row * H * M,
                       n * M * H * 4 + table_bytes + 2 * n * M * 4 + extra_bytes)


def fail(msg: str, code: int = 1) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean device milliseconds of fn() over reps runs, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def phase_environment(torch, _build):
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "not read"
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    _build.load_all()
    print(f"build: {len(_build.KERNELS)} kernels in {time.perf_counter() - t0:.2f} s")
    for name in _build.KERNELS:
        info = _build.BUILD_INFO[name]
        print(f"build {name}: {info['seconds']:.2f} s (cached={info['cached']})")
        func = "?"
        for line in info["log"].splitlines():
            if "Compiling entry function" in line or "Function properties for" in line:
                func = line.split("'")[1] if "'" in line else line.split()[-1]
            elif "registers" in line or "spill" in line or "smem" in line:
                print(f"  ptxas {func}: {line.strip()}")
    return card


def k1_args(torch, X, C, B0, rounds, npert, seed):
    from local_search_quantization_torch.ops.luts import get_binaries, get_unaries

    dev = X.device
    n, m, h = X.shape[0], C.shape[0], C.shape[1]
    gen = torch.Generator(device=dev).manual_seed(seed)
    orders = torch.stack([torch.randperm(m, generator=gen, device=dev)
                          for _ in range(rounds)]).to(torch.int32)
    return (get_unaries(X, C), get_binaries(C), (X * X).sum(-1), B0, orders,
            torch.rand((rounds, n, m), generator=gen, device=dev),
            torch.randint(0, h, (rounds, n, npert), generator=gen, device=dev,
                          dtype=torch.int32))


def compare_k1(torch, args, label, time_it):
    from local_search_quantization_torch.ops import icm_kernels as k1

    kw = dict(icmiter=ICMITER, milestones=(2, args[4].shape[0]), with_stats=True)
    got = k1.ils_encode_streamed(*args, **kw)
    want = k1.ils_encode_streamed_reference(*args, **kw)
    torch.cuda.synchronize()
    rows = int((got[0] != want[0]).any(1).sum())
    err = float((got[1] - want[1]).abs().max())
    same = all(torch.equal(g, w) for g, w in zip(got, want))
    print(f"K1 {label}: n={args[0].shape[0]}, rows with other codes {rows}, "
          f"max |cost diff| {err}, all outputs identical: {same}")
    check(same, f"K1 {label}: kernel and plain version disagree "
                f"({rows} rows, cost err {err})")
    if not time_it:
        return err, None, None
    ms = cuda_ms(torch, lambda: k1.ils_encode_streamed(*args, icmiter=ICMITER), 3)
    plain = cuda_ms(torch, lambda: k1.ils_encode_streamed_reference(
        *args, icmiter=ICMITER), 1)
    n, rounds = args[0].shape[0], args[4].shape[0]
    print(f"[{CARD}] K1 {label} time: kernel {ms:.3f} ms, plain {plain:.3f} ms "
          f"({n * rounds / ms / 1e3:.3f}M row-rounds/s kernel)")
    return err, ms, plain


def phase_k1(torch, data, dev):
    from local_search_quantization_torch.ops.solver import update_codebooks
    from local_search_quantization_torch.utils.synth import random_codes

    rng = np.random.default_rng(1)
    n = 8192
    Xi = torch.as_tensor(rng.integers(-3, 4, (n, D)).astype(np.float32), device=dev)
    Ci = torch.as_tensor(rng.integers(-1, 2, (M, H, D)).astype(np.float32), device=dev)
    Bi = torch.as_tensor(random_codes(2, n, M, H), device=dev)
    compare_k1(torch, k1_args(torch, Xi, Ci, Bi, 3, NPERT, 3), "integer fixture", False)

    x_train, x_base = data[0], data[1]
    Xt = torch.as_tensor(x_train[:20000], device=dev)
    C = update_codebooks(Xt, torch.as_tensor(random_codes(4, Xt.shape[0], M, H),
                                             device=dev), H)
    X = torch.as_tensor(x_base[:K1_N], device=dev)
    B0 = torch.as_tensor(random_codes(5, K1_N, M, H), device=dev)
    args = k1_args(torch, X, C, B0, K1_ROUNDS, NPERT, 6)
    return C, compare_k1(torch, args, "SIFT width", True)


def compare_sweeps(torch, args, label, time_it):
    """K5 and K6 against their plain versions on the same codes; returns
    {variant: (max abs code diff, kernel ms, plain ms)}."""
    from local_search_quantization_torch.ops import icm_kernels as ik

    out = {}
    for variant in ("v2", "v1"):
        kw = dict(icmiter=ICMITER, variant=variant)
        got = ik.fused_icm_sweeps(*args, **kw)
        want = ik.fused_icm_sweeps_reference(*args, **kw)
        torch.cuda.synchronize()
        rows = int((got != want).any(1).sum())
        err = float((got - want).abs().max())
        moved = int((got != args[0]).any(1).sum())
        print(f"K{5 if variant == 'v2' else 6} ({variant}) {label}: "
              f"n={args[0].shape[0]}, rows with other codes {rows}, rows the "
              f"sweeps changed {moved}, identical: {rows == 0}")
        check(rows == 0 and got.dtype == torch.int32,
              f"icm_sweeps_{variant} {label}: kernel and plain version disagree "
              f"on {rows} rows")
        check(moved > 0, f"icm_sweeps_{variant} {label}: the sweeps changed no code")
        ms = plain = None
        if time_it:
            ms = cuda_ms(torch, lambda: ik.fused_icm_sweeps(*args, **kw), 5)
            plain = cuda_ms(torch, lambda: ik.fused_icm_sweeps_reference(*args, **kw), 1)
            n = args[0].shape[0]
            print(f"[{CARD}] K{5 if variant == 'v2' else 6} ({variant}) {label} time: kernel "
                  f"{ms:.3f} ms, plain {plain:.3f} ms ({n / ms / 1e3:.3f}M rows/s "
                  f"kernel, {ICMITER} sweeps)")
        out[variant] = (err, ms, plain)
    return out


def sweeps_args(torch, X, C, B0, seed):
    from local_search_quantization_torch.ops.luts import get_binaries, get_unaries

    gen = torch.Generator(device=X.device).manual_seed(seed)
    order = torch.randperm(C.shape[0], generator=gen, device=X.device).to(torch.int32)
    return (B0, get_unaries(X, C), get_binaries(C).to(torch.bfloat16), order)


def phase_sweeps(torch, C, data, dev):
    from local_search_quantization_torch.utils.synth import random_codes

    rng = np.random.default_rng(11)
    n = 8192
    Xi = torch.as_tensor(rng.integers(-3, 4, (n, D)).astype(np.float32), device=dev)
    Ci = torch.as_tensor(rng.integers(-1, 2, (M, H, D)).astype(np.float32), device=dev)
    Bi = torch.as_tensor(random_codes(12, n, M, H), device=dev)
    compare_sweeps(torch, sweeps_args(torch, Xi, Ci, Bi, 13), "integer fixture", False)
    # Other lane maps: h=40 (two candidates a lane, no multiple of 32: idle
    # lanes), h=300 (16 a lane, no multiple of 16: the element-wise loads with
    # a masked tail) and h=512 (16 a lane, two 16-byte loads a row).
    for h, seed in ((40, 21), (300, 22), (512, 23)):
        Xh = torch.as_tensor(rng.normal(size=(4096, 32)).astype(np.float32) * 10, device=dev)
        Ch = torch.as_tensor(rng.normal(size=(5, h, 32)).astype(np.float32) * 3, device=dev)
        Bh = torch.as_tensor(random_codes(seed, 4096, 5, h), device=dev)
        compare_sweeps(torch, sweeps_args(torch, Xh, Ch, Bh, seed), f"m=5, h={h}", False)
    X = torch.as_tensor(data[1][:K1_N], device=dev)
    B0 = torch.as_tensor(random_codes(14, K1_N, M, H), device=dev)
    return compare_sweeps(torch, sweeps_args(torch, X, C, B0, 15), "SIFT width", True)


# K7's score sums (the "mmonly" and "noargmin" sinks): within 1e-5 of the
# plain version, relative, plus 1e-5 of its mean magnitude (both add in the
# same lane order, so they are expected to agree bit for bit).
SINK_RTOL = 1e-5


def compare_k7(torch, args, label, time_it):
    """K7's variants against the plain version, and "full" against K5, on
    the same codes; with time_it, each variant's time on a table stacked
    once, K5's and K6's wrappers and K5's earlier stages (`icm_sweeps_step`,
    codes identical to K5's) beside them. Returns (max error, full ms, plain
    full ms, {name: ms})."""
    from local_search_quantization_torch.ops import icm_kernels as ik

    B, u, b16, order = args
    stacked = ik.binaries_to_j_stacked(b16).contiguous()
    k5 = ik.fused_icm_sweeps(*args, icmiter=ICMITER, variant="v2")
    err = 0.0
    for variant in ik.DISSECT_VARIANTS:
        kw = dict(icmiter=ICMITER, variant=variant)
        codes, sink = ik.icm_sweeps_dissect(B, u, stacked, order, **kw)
        want_codes, want_sink = ik.icm_sweeps_dissect_reference(B, u, b16, order, **kw)
        torch.cuda.synchronize()
        rows = int((codes != want_codes).any(1).sum())
        serr = float((sink - want_sink).abs().max())
        tol = SINK_RTOL * (want_sink.abs() + float(want_sink.abs().mean()))
        sums = variant in ("noargmin", "mmonly")
        sink_ok = bool(((sink - want_sink).abs() <= tol).all()) if sums \
            else torch.equal(sink, want_sink)
        same_k5 = variant != "full" or torch.equal(codes, k5)
        err = max(err, serr, float((codes - want_codes).abs().max()))
        print(f"K7 {variant} {label}: n={B.shape[0]}, rows with other codes {rows}, "
              f"max |sink diff| {serr} ({'within 1e-5' if sums else 'identical'}: "
              f"{sink_ok}){', identical to K5: ' + str(same_k5) if variant == 'full' else ''}")
        check(rows == 0 and sink_ok and same_k5,
              f"K7 {variant} {label}: kernel and plain version (or K5) disagree")
    for step in ik.SWEEP_STEPS:
        codes = ik.icm_sweeps_step(B, u, stacked, order, icmiter=ICMITER, step=step)
        torch.cuda.synchronize()
        rows = int((codes != k5).any(1).sum())
        print(f"K5 stage {step!r} {label}: rows with other codes than K5 {rows}")
        check(rows == 0, f"K5 stage {step} {label}: codes differ from K5's")
    if not time_it:
        return err, None, None, {}
    ms = {v: cuda_ms(torch, lambda v=v: ik.icm_sweeps_dissect(
        B, u, stacked, order, icmiter=ICMITER, variant=v), 5) for v in ik.DISSECT_VARIANTS}
    # The stages in turns, twice: interleaved, hoisted, packed, and back.
    turns = {step: [] for step in ik.SWEEP_STEPS}
    for step in ik.SWEEP_STEPS + ik.SWEEP_STEPS[::-1]:
        turns[step].append(cuda_ms(torch, lambda step=step: ik.icm_sweeps_step(
            B, u, stacked, order, icmiter=ICMITER, step=step), 5))
    ms.update({step: min(t) for step, t in turns.items()})
    ms["K5 wrapper"] = cuda_ms(torch, lambda: ik.fused_icm_sweeps(
        *args, icmiter=ICMITER, variant="v2"), 5)
    ms["K6 wrapper"] = cuda_ms(torch, lambda: ik.fused_icm_sweeps(
        *args, icmiter=ICMITER, variant="v1"), 5)
    ms["stack"] = cuda_ms(torch, lambda: ik.binaries_to_j_stacked(b16).contiguous(), 5)
    plain = cuda_ms(torch, lambda: ik.icm_sweeps_dissect_reference(
        B, u, b16, order, icmiter=ICMITER, variant="full"), 1)
    n = B.shape[0]
    print(f"[{CARD}] K7 {label} time, {ICMITER} sweeps, table stacked once: " + ", ".join(
        f"{v} {ms[v]:.3f} ms ({ms[v] * 1e6 / (n * ICMITER * M):.4f} ns per row-visit)"
        for v in ik.DISSECT_VARIANTS))
    print(f"[{CARD}] K7 {label} beside: K5 wrapper (stacks the table each call) "
          f"{ms['K5 wrapper']:.3f} ms, K6 wrapper {ms['K6 wrapper']:.3f} ms, the stacking "
          f"alone {ms['stack']:.3f} ms; plain full {plain:.3f} ms")
    print(f"[{CARD}] K5's redesign stage by stage {label}, table stacked once, each timed "
          "twice in turns (ms): " + ", ".join(
              f"{step} {turns[step][0]:.3f} / {turns[step][1]:.3f}" for step in ik.SWEEP_STEPS))
    ms["K5"], ms["K6"] = ms["K5 wrapper"], ms["K6 wrapper"]
    return err, ms["full"], plain, ms


# An instantiation of csrc/icm_sweeps.cu's kernel template in a mangled name:
# <VARIANT, CPL, DISSECT, STEP, VEC>.
SWEEPS_KERNEL = r"icm_sweeps_kernelILi(\d)ELi(\d+)ELi(\d)ELi(\d)ELb([01])EE"
# The 8-candidates-a-lane builds that phase 2c reads: (layout, switch, step,
# vector loads), layout 2 for K5's table and 1 for K6's, switch 0 for K5/K6
# and 1-5 for K7's variants, step 2 the kernel that runs.
SWEEPS_BUILDS = {"K5": (2, 0, 2, 1), "K6": (1, 0, 2, 1), "full": (2, 1, 2, 1),
                 "predwrite": (2, 2, 2, 1), "nowrite": (2, 3, 2, 1),
                 "noargmin": (2, 4, 2, 1), "mmonly": (2, 5, 2, 1),
                 "interleaved": (2, 0, 0, 0), "hoisted": (2, 0, 1, 0)}


def sweeps_registers() -> dict:
    """{(layout, switch, step, vec): registers} of the 8-candidates-a-lane
    instantiations, from ptxas's lines in the build log."""
    import re

    from local_search_quantization_torch import _build

    out, cur = {}, None
    for line in _build.BUILD_INFO["icm_sweeps"]["log"].splitlines():
        head = re.search(SWEEPS_KERNEL, line)
        if head and ("Compiling entry function" in line or "Function properties" in line):
            v, cpl, d, step, vec = (int(g) for g in head.groups())
            cur = (v, d, step, vec) if cpl == 8 else None
        used = re.search(r"Used (\d+) registers", line)
        if used and cur is not None:
            out[cur] = int(used.group(1))
    return out


def k7_sass() -> dict:
    """What the SASS of the 8-candidates-a-lane instantiations issues for the
    bf16 table, read with cuobjdump from the built library: {(layout, switch,
    step, vec): (table loads, serialized loads)}. A vector build loads a
    lane's share of a row in one 16-byte load (LDG.E.128.CONSTANT; the
    unaries' staging loads are streaming, not CONSTANT), the others in eight
    2-byte loads (U16), so the first count is rows for the one and values
    for the other. A load is serialized when a register it writes is read
    before the next table load issues, so the next one waits a whole L2
    round trip. Fails where cuobjdump is missing: it ships with nvcc, which
    the build needs."""
    import re
    import shutil

    from local_search_quantization_torch import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        tool = shutil.which("cuobjdump")
    check(tool is not None, "cuobjdump not found beside nvcc or on PATH: K7's SASS "
          "table loads cannot be read")
    sass = subprocess.run([tool, "-sass", _build._paths("icm_sweeps")[1]],
                          capture_output=True, text=True, timeout=120).stdout
    funcs, cur = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            head = re.search(SWEEPS_KERNEL, line)
            cur = None
            if head and head.group(2) == "8":
                v, _, d, step, vec = (int(g) for g in head.groups())
                cur = (v, d, step, vec)
                funcs[cur] = []
        elif cur is not None and re.search(r"/\*[0-9a-f]{4}\*/", line):
            funcs[cur].append(line.split("*/", 1)[1].split(";")[0].strip())
    out = {}
    for key, ins in funcs.items():
        wide = bool(key[3])
        loads = [i for i, x in enumerate(ins) if "LDG" in x and (
            (".128" in x and "CONSTANT" in x) if wide else "U16" in x)]
        serial = 0
        for a, b in zip(loads, loads[1:]):
            first = int(re.search(r"LDG\S*\s+R(\d+)", ins[a]).group(1))
            regs = "|".join(f"R{first + i}" for i in range(4 if wide else 1))
            sources = [x.split(",", 1)[1] for x in ins[a + 1:b] if "," in x]
            serial += any(re.search(rf"\b({regs})\b", x) for x in sources)
        out[key] = (len(loads), serial)
    return out


def phase_k7(torch, C, data, dev):
    """Phase 2c: K7 at the integer fixture and the SIFT width of phase 2b."""
    from local_search_quantization_torch.utils.synth import random_codes

    rng = np.random.default_rng(11)
    n = 8192
    Xi = torch.as_tensor(rng.integers(-3, 4, (n, D)).astype(np.float32), device=dev)
    Ci = torch.as_tensor(rng.integers(-1, 2, (M, H, D)).astype(np.float32), device=dev)
    Bi = torch.as_tensor(random_codes(12, n, M, H), device=dev)
    err = compare_k7(torch, sweeps_args(torch, Xi, Ci, Bi, 13), "integer fixture",
                     False)[0]
    X = torch.as_tensor(data[1][:K1_N], device=dev)
    B0 = torch.as_tensor(random_codes(14, K1_N, M, H), device=dev)
    serr, ms, plain, times = compare_k7(torch, sweeps_args(torch, X, C, B0, 15),
                                        "SIFT width", True)
    sass, regs = k7_sass(), sweeps_registers()
    print(f"[{CARD}] K5, K6, K7 and K5's earlier stages at n={K1_N}, {ICMITER} sweeps "
          "(8 candidates a lane; table loads in the SASS, one 16-byte load a row for "
          "the vector builds and eight 2-byte loads a row for the two strided stages; "
          "serialized: a register of the load is read before the next table load "
          "issues): " + "; ".join(
              f"{name} {times[name]:.3f} ms, {regs.get(key, '?')} registers, "
              f"{sass[key][0]} loads ({sass[key][1]} serialized)"
              for name, key in SWEEPS_BUILDS.items() if key in sass))
    for name, key in SWEEPS_BUILDS.items():
        check(key in sass and sass[key][0] >= (8 if key[3] or name == "hoisted" else 1),
              f"{name}: its build or its table loads are missing from the SASS: {sass}")
    # The kernel that runs keeps all m - 1 rows of a visit in flight (one
    # chunk of 8 row slots at m=7): every variant, and K5 and K6, must show
    # its 8 row loads with none serialized.
    for name, key in SWEEPS_BUILDS.items():
        if key[2] == 2:
            check(sass[key] == (8, 0), f"{name}: expected 8 row loads, none serialized, "
                                       f"got {sass[key]}")
    return max(err, serr), ms, plain


def phase_l2(torch, dev):
    """Phase 2d: the probe against its plain version, then the L2 gather
    rates and the practical bounds of K1, K5 and K6. Returns {kernel:
    practical bound ms}, with the bf16 rate in GB/s under "l2_gbps"."""
    from local_search_quantization_torch.ops import l2_probe

    gen = torch.Generator(device=dev).manual_seed(1)
    for dtype in (torch.bfloat16, torch.float32):
        table = torch.randint(-2, 3, (M * M * H, 256), generator=gen, device=dev).to(dtype)
        want = l2_probe.l2_gather_reference(table, warps=4096, rows_per_warp=16, seed=3)
        for wide in (False, True):
            got = l2_probe.l2_gather(table, warps=4096, rows_per_warp=16, wide=wide, seed=3)
            torch.cuda.synchronize()
            check(torch.equal(got, want), f"L2 probe ({dtype}, wide={wide}) sums differ "
                                          "from its plain version")
    print("L2 probe: every warp's sum identical to the plain version (bf16 and f32 "
          "rows, one element and 16 bytes a lane)")
    rates = {}
    for label, row_bytes, dtype in (("512 B bf16 rows, 6.4 MB table", 2 * H, torch.bfloat16),
                                    ("1 KB f32 rows, 12.8 MB table", 4 * H, torch.float32)):
        for wide in (False, True):
            r = l2_probe.l2_gather_rate(row_bytes, M * M * H * row_bytes, dtype, wide=wide,
                                        device=dev)
            rates[(row_bytes, wide)] = r["gbps"]
            print(f"[{CARD}] L2 gather, {label}, {'16 B' if wide else 'one element'} a "
                  f"lane: {r['gbps']:.1f} GB/s ({r['bytes'] / 1e9:.3f} GB in "
                  f"{r['ms']:.4f} ms)")
    # Table bytes each kernel gathers at its phase-2 shape: m - 1 rows of h
    # values a visit, icmiter * m visits a round.
    k1_bytes = K1_N * K1_ROUNDS * ICMITER * M * (M - 1) * H * 4
    k5_bytes = K1_N * ICMITER * M * (M - 1) * H * 2
    bf16_rate = max(rates[(2 * H, False)], rates[(2 * H, True)])
    f32_rate = max(rates[(4 * H, False)], rates[(4 * H, True)])
    bounds = {"ils_encode": k1_bytes / f32_rate / 1e6,
              "icm_sweeps_v2": k5_bytes / bf16_rate / 1e6,
              "icm_sweeps_v1": k5_bytes / bf16_rate / 1e6}
    bounds["icm_sweeps_dissect"] = bounds["icm_sweeps_v2"]
    bounds["l2_gbps"] = bf16_rate
    print(f"[{CARD}] practical bounds from the L2 rate: K1 {k1_bytes / 1e9:.1f} GB / "
          f"{f32_rate:.1f} GB/s = {bounds['ils_encode']:.3f} ms; K5 and K6 "
          f"{k5_bytes / 1e9:.1f} GB / {bf16_rate:.1f} GB/s = "
          f"{bounds['icm_sweeps_v2']:.3f} ms")
    return bounds


def phase_bench_path(torch, dev):
    """Path D: the encoder bench twins at full size, the counters zeroed just
    before and read just after."""
    from local_search_quantization_torch.benchmarks import bench, bench_icm_phases
    from local_search_quantization_torch.benchmarks import bench_kernel_variants
    from local_search_quantization_torch.ops.icm_kernels import DISSECT_VARIANTS

    torch.cuda.synchronize()
    zero_counters()
    t0 = time.perf_counter()
    variants = bench_kernel_variants.run(device=dev)
    headline = bench.run(device=dev)
    phases = bench_icm_phases.run(device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters()
    for line in (bench_kernel_variants.lines(variants) + bench.lines(headline)
                 + bench_icm_phases.lines(phases)):
        print(f"[{CARD}] path D: {line}")
    print(f"path D: wall {wall:.3f} s; kernel launches {launches}")
    check(all(launches["dissect"][v] > 0 for v in DISSECT_VARIANTS)
          and launches["ils_encode"] > 0 and launches["icm_sweeps_v2"] > 0,
          f"path D: a kernel of the path never launched: {launches}")
    check(all(np.isfinite(ms) and ms > 0 for ms, _ in variants.values())
          and headline["vecs_per_sec"] > 0 and all(np.isfinite(v) for v in phases.values()),
          "path D: a bench twin returned a time that is not positive and finite")
    return launches


def phase_k2(torch, C, data, dev):
    from local_search_quantization_torch.ops.adc import lsq_query_luts
    from local_search_quantization_torch.ops.norms import reconstruction_sqnorms
    from local_search_quantization_torch.ops import select_kernels as k2

    gen = torch.Generator(device=dev).manual_seed(7)
    B = torch.randint(0, H, (K2_N, M), generator=gen, device=dev, dtype=torch.int32)
    extra = torch.cat([reconstruction_sqnorms(B[s:s + (1 << 17)], C)
                       for s in range(0, K2_N, 1 << 17)])
    luts = lsq_query_luts(torch.as_tensor(data[2][:K2_QUERIES], device=dev), C).contiguous()
    Bt8 = B.t().to(torch.uint8).contiguous()
    Bt32 = B.t().contiguous()
    want = k2.scan_topk_reference(luts, Bt8, extra, K)
    err = 0.0
    for name, Bt in (("uint8", Bt8), ("int32", Bt32)):
        got = k2.scan_topk(luts, Bt, extra, K)
        torch.cuda.synchronize()
        same = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        derr = float((got[0] - want[0]).abs().max())
        bad_ids = int((got[1] != want[1]).sum())
        err = max(err, derr)
        print(f"K2 {name} codes: nq={K2_QUERIES}, n={K2_N}, k={K}: ids differing "
              f"{bad_ids}, max |dist diff| {derr}, identical: {same}")
        check(same, f"K2 ({name} codes) disagrees with its plain version")
    times = {name: cuda_ms(torch, lambda Bt=Bt: k2.scan_topk(luts, Bt, extra, K), 5)
             for name, Bt in (("uint8", Bt8), ("int32", Bt32))}
    plain = cuda_ms(torch, lambda: k2.scan_topk_reference(luts, Bt8, extra, K), 2)
    print(f"[{CARD}] K2 time: kernel {times['uint8']:.3f} ms (uint8 codes), "
          f"{times['int32']:.3f} ms (int32 codes), plain {plain:.3f} ms, "
          f"for {K2_QUERIES} queries")
    phase_k2_grid(torch, luts, Bt8, Bt32, extra, want)
    phase_k2_small_n(torch, luts, Bt8, extra)
    return ((err, times["uint8"], plain, *scan_bound(K2_QUERIES, K2_N, K, 1)),
            (luts, Bt8, extra, want))


def phase_k2_grid(torch, luts, Bt8, Bt32, extra, want1000):
    """K2 at nq 1, 32, 1000 and k 1000, 10001: identical to its plain
    version and to K3 "sorted" on both code layouts; then, on uint8 codes,
    its time and stage split beside the dense path and K3, the queries that
    failed the certificate, peak memory, the bounds, and torch.topk over the
    materialised distances."""
    from local_search_quantization_torch.ops import select_kernels as sk

    rows = []
    for k in (K, 10_001):
        want = want1000 if k == K else sk.scan_topk_reference(luts, Bt8, extra, k)
        for nq in (1, 32, K2_QUERIES):
            lq = luts[:nq].contiguous()
            failed, dense = sk.scan_topk.failed, sk.scan_topk.dense_launches
            for name, Bt in (("uint8", Bt8), ("int32", Bt32)):
                d, i = sk.scan_topk(lq, Bt, extra, k)
                k3 = sk.scan_select(lq, Bt, extra, k)
                torch.cuda.synchronize()
                same = torch.equal(d, want[0][:nq]) and torch.equal(i, want[1][:nq])
                same_k3 = torch.equal(d, k3[0]) and torch.equal(i, k3[1])
                check(same and same_k3, f"K2 at nq={nq}, k={k}, {name} codes: "
                      f"plain version {same}, K3 sorted {same_k3}")
            # Every query certified: the answers above came from the staged
            # kernels, and the dense path (exact by construction) never ran.
            check(sk.scan_topk.failed == failed and sk.scan_topk.dense_launches == dense,
                  f"K2 at nq={nq}, k={k}: {sk.scan_topk.failed - failed} queries failed "
                  f"the certificate, {sk.scan_topk.dense_launches - dense} dense launches")
            t0, cap = sk.warm_bound(lq, Bt8, extra, k=k)
            cand, count = sk.k2_filter(lq, Bt8, extra, t0, cap)
            if nq == K2_QUERIES:
                check_k2_stages(torch, lq, Bt8, extra, t0, cap, k, cand, count)
            ms = {"k2": cuda_ms(torch, lambda: sk.scan_topk(lq, Bt8, extra, k), 5)}
            mem = peak_gib(torch, lambda: sk.scan_topk(lq, Bt8, extra, k))
            check(sk.scan_topk.failed == failed and sk.scan_topk.dense_launches == dense,
                  f"K2 at nq={nq}, k={k}: the timed K2 calls ran the dense path")
            ms.update(
                dense=cuda_ms(torch, lambda: sk.scan_topk_dense(lq, Bt8, extra, k), 3),
                k3=cuda_ms(torch, lambda: sk.scan_select(lq, Bt8, extra, k), 3),
                pre=cuda_ms(torch, lambda: sk.warm_bound(lq, Bt8, extra, k=k), 5),
                filter=cuda_ms(torch, lambda: sk.k2_filter(lq, Bt8, extra, t0, cap), 5),
                select=cuda_ms(torch, lambda: sk.k2_select(cand, count, k, cap), 5))
            mem_dense = peak_gib(torch, lambda: sk.scan_topk_dense(lq, Bt8, extra, k))
            bound, by = scan_bound(nq, K2_N, k, 1)
            smem = nq * K2_N * M / SMEM_LOOKUPS * 1e3
            print(f"[{CARD}] K2 nq={nq} k={k}: {ms['k2']:.3f} ms (pre-scan "
                  f"{ms['pre']:.3f}, filter {ms['filter']:.3f}, select "
                  f"{ms['select']:.3f}); dense path {ms['dense']:.3f} ms; K3 sorted "
                  f"{ms['k3']:.3f} ms; cap {cap}, appended min/mean/max "
                  f"{int(count.min())}/{float(count.float().mean()):.1f}/"
                  f"{int(count.max())}, failed the certificate 0; peak "
                  f"{mem:.3f} GiB (dense {mem_dense:.3f} GiB); bound {bound:.4f} ms "
                  f"({by}), shared-memory lookups {smem:.4f} ms; identical to the "
                  f"plain version and K3 on uint8 and int32 codes")
            rows.append((nq, k))
    # The select half alone, on distances computed outside the timing.
    dist = sk.lut_scan_block(luts, Bt8, extra)
    for nq, k in rows:
        dq = dist[:nq]
        print(f"[{CARD}] torch.topk(dist[{nq}, {K2_N}], {k}, largest=False), the "
              f"select half only: {cuda_ms(torch, lambda: torch.topk(dq, k, dim=1, largest=False), 3):.3f} ms")
    del dist


def check_k2_stages(torch, luts, Bt, extra, t0, cap, k, cand, count):
    """`k2_filter` and `k2_select` against their plain versions on the same
    inputs: the filter's counts identical and, for each query within cap,
    its appended keys identical as a set (the kernel appends in no fixed
    order); the select's (dists, ids, certificate) identical on the
    kernel's own cand and count."""
    from local_search_quantization_torch.ops import select_kernels as sk

    want_c, want_n = sk.k2_filter_reference(luts, Bt, extra, t0, cap)
    torch.cuda.synchronize()
    same_count = torch.equal(count, want_n)
    within = count <= cap
    filled = (torch.arange(cap, device=cand.device)[None, :]
              < count.clamp(max=cap).long()[:, None])

    def key_sets(c):
        return torch.sort(torch.where(filled, c, -1) ^ sk._SIGN64, dim=1).values[within]

    same_keys = same_count and torch.equal(key_sets(cand), key_sets(want_c))
    got = sk.k2_select(cand, count, k, cap)
    want = sk.k2_select_reference(cand, count, k, cap)
    torch.cuda.synchronize()
    same_sel = all(torch.equal(g, w) for g, w in zip(got, want))
    print(f"K2 stages at nq={luts.shape[0]}, k={k}, cap {cap}: k2_filter counts "
          f"identical {same_count}, key sets identical on {int(within.sum())} "
          f"queries within cap {same_keys}; k2_select (dists, ids, certificate) "
          f"identical {same_sel}, certified {int(got[2].sum())}")
    check(same_keys and same_sel, f"K2 stages at k={k} disagree with their plain versions")


def phase_k2_small_n(torch, luts, Bt8, extra):
    """The staged path against the dense path at n below K2's staged floor
    (`select_kernels._K2_MIN_N`, 65,536 rows) and at it: identical answers,
    and both times, at nq 32 and 1000, k=1000."""
    from local_search_quantization_torch.ops import select_kernels as sk

    for n in (16_384, 32_768, 65_536):
        Bt, e = Bt8[:, :n].contiguous(), extra[:n].contiguous()
        for nq in (32, K2_QUERIES):
            lq = luts[:nq].contiguous()

            def staged():
                return sk.k2_staged(lq, Bt, e, K, prescan=sk._k2_prescan,
                                    filt=sk.k2_filter, select=sk.k2_select,
                                    dense=sk.scan_topk_dense, chunk=nq)

            want = sk.scan_topk_reference(lq, Bt, e, K)
            d, i, failed = staged()
            dd, di = sk.scan_topk_dense(lq, Bt, e, K)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip((d, i, dd, di), want * 2)),
                  f"K2 staged or dense path at n={n}, nq={nq} disagrees")
            ms = cuda_ms(torch, staged, 5)
            ms_dense = cuda_ms(torch, lambda: sk.scan_topk_dense(lq, Bt, e, K), 5)
            print(f"[{CARD}] K2 at n={n}, nq={nq}, k={K}: staged {ms:.3f} ms "
                  f"({failed} queries failed the certificate), dense {ms_dense:.3f} ms; "
                  "both identical to the plain version")


def peak_gib(torch, fn) -> float:
    """Peak device memory allocated during fn(), GiB."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 2**30


def check_k3(torch, label, luts, Bt, extra, t0, wants, k2):
    """K3 "sorted" cold, "unsorted" cold and "sorted" warm on one set of
    inputs against the plain version's answers `wants` = {warm: (d, i) at
    K + 1} and against K2's cold answer `k2`. Returns the largest distance
    error (0.0 unless a check is about to fail)."""
    from local_search_quantization_torch.ops import select_kernels as sk

    nq, err = luts.shape[0], 0.0
    for name, t, unsorted in (("sorted cold", None, False), ("unsorted cold", None, True),
                              ("sorted warm", t0, False)):
        got_d, got_i = sk.scan_select(luts, Bt, extra, K, t, unsorted=unsorted)
        want_d, want_i = wants[t is not None]
        torch.cuda.synchronize()
        err = max(err, float(torch.nan_to_num((got_d - want_d[:, :K]).abs(), posinf=0.0).max()))
        same_d = torch.equal(got_d, want_d[:, :K])
        rows = want_d[:, K - 1] < want_d[:, K] if unsorted else torch.ones(
            nq, dtype=torch.bool, device=luts.device)
        same_i = torch.equal(got_i[rows], want_i[rows, :K])
        # K2's cold answer cut at t0 is the top-k of the rows below t0.
        k2_d = k2[0] if t is None else torch.where(k2[0] >= t, float("inf"), k2[0])
        k2_i = k2[1] if t is None else torch.where(k2[0] >= t, -1, k2[1])
        same_k2 = torch.equal(k2_d, got_d) and (unsorted or torch.equal(k2_i, got_i))
        print(f"K3 {name}, {label}: dists identical {same_d}, ids identical on "
              f"{int(rows.sum())} rows {same_i}, identical to K2 {same_k2}")
        check(same_d and same_i and same_k2, f"K3 {name}, {label} disagrees")
    return err


def phase_k3(torch, inputs, l2_rate):
    """K3 against its plain version and against K2 on K2's inputs: nq 1, 32
    and 1000, uint8 and int32 codes, and a base whose length is no multiple
    of 16 (the element-wise staging and a ragged last tile); then its times,
    the pre-scan's, and the bytes its design reads from L2."""
    from local_search_quantization_torch.ops import select_kernels as sk

    luts, Bt, extra, _ = inputs
    k2 = sk.scan_topk(luts, Bt, extra, K)
    Bt32 = Bt.to(torch.int32)
    t0, cap = sk.warm_bound(luts, Bt, extra, k=K)
    wants = {warm: sk.scan_select_reference(luts, Bt, extra, K + 1, t0 if warm else None)
             for warm in (False, True)}
    err = 0.0
    for nq in (K2_QUERIES, 32, 1):
        cut = {w: (d[:nq], i[:nq]) for w, (d, i) in wants.items()}
        for name, codes in (("uint8", Bt), ("int32", Bt32)):
            err = max(err, check_k3(torch, f"nq={nq}, {name} codes", luts[:nq].contiguous(),
                                    codes, extra, t0[:nq].contiguous(), cut,
                                    (k2[0][:nq], k2[1][:nq])))
    del Bt32
    n2 = 300_007
    Br, er, lr = Bt[:, :n2].contiguous(), extra[:n2].contiguous(), luts[:32].contiguous()
    tr = sk.warm_bound(lr, Br, er, k=K)[0]
    err = max(err, check_k3(
        torch, f"nq=32, n={n2} (no multiple of 16)", lr, Br, er, tr,
        {warm: sk.scan_select_reference(lr, Br, er, K + 1, tr if warm else None)
         for warm in (False, True)}, sk.scan_topk(lr, Br, er, K)))
    times = {}
    for nq in (1, 32, K2_QUERIES):
        lq, tq = luts[:nq].contiguous(), t0[:nq].contiguous()
        times[nq] = {name: cuda_ms(torch, lambda t=t, u=u: sk.scan_select(
            lq, Bt, extra, K, t, unsorted=u), 5)
            for name, t, u in (("sorted", None, False), ("unsorted", None, True),
                               ("warm", tq, False))}
        times[nq]["pre-scan"] = cuda_ms(torch, lambda: sk.warm_bound(lq, Bt, extra, k=K), 5)
        g = sk.k3_geometry(M, H, 1, K)[0]
        seg = sk.k3_segments(K2_N, nq, g, torch.cuda.get_device_properties(0)
                             .multi_processor_count, K)[0]
        print(f"[{CARD}] K3 time at nq={nq} x {K2_N}, k={K} ({g} queries a block, {seg} "
              f"segments): sorted {times[nq]['sorted']:.3f} ms, unsorted "
              f"{times[nq]['unsorted']:.3f} ms, sorted warm {times[nq]['warm']:.3f} ms; the "
              f"pre-scan (warm_bound: every 16th row, rank {sk.warm_rank_cap(K)[0]}, "
              f"{sk.k3_geometry(M, H, 1, sk.warm_rank_cap(K)[0])[0]} queries a block) "
              f"{times[nq]['pre-scan']:.3f} ms")
    plain = cuda_ms(torch, lambda: sk.scan_select_reference(luts, Bt, extra, K, t0), 2)
    mem_k3 = peak_gib(torch, lambda: sk.scan_select(luts, Bt, extra, K))
    mem_k2 = peak_gib(torch, lambda: sk.scan_topk(luts, Bt, extra, K))
    # Codes and extra are read once a group of g queries, from L2 after the
    # first group: the first port read them once a query.
    g = sk.k3_geometry(M, H, 1, K)[0]
    l2_bytes = -(-K2_QUERIES // g) * K2_N * (M + 4)
    print(f"[{CARD}] K3 for {K2_QUERIES} queries: plain version {plain:.3f} ms; codes and "
          f"extra read {-(-K2_QUERIES // g)} times ({g} queries a block): "
          f"{l2_bytes / 1e9:.3f} GB, {l2_bytes / l2_rate / 1e6:.3f} ms at the L2 probe's "
          f"{l2_rate:.1f} GB/s (one block a query: {K2_QUERIES * K2_N * (M + 4) / 1e9:.3f} GB, "
          f"{K2_QUERIES * K2_N * (M + 4) / l2_rate / 1e6:.3f} ms); shared-memory lookups "
          f"{K2_QUERIES * K2_N * M / SMEM_LOOKUPS * 1e3:.4f} ms")
    print(f"K3 peak device memory {mem_k3:.3f} GiB against K2's {mem_k2:.3f} GiB "
          "(inputs included)")
    return ((err, times[K2_QUERIES]["sorted"], plain, *scan_bound(K2_QUERIES, K2_N, K, 1)),
            t0, cap)


def check_k4_appends(torch, label, luts, Bt, extra, t0, cap):
    """K4's appended ids and counts against its plain version: counts
    identical; per query the sorted ids identical where the list did not
    overflow, else `cap` distinct ids out of the plain version's full list.
    Returns the number of queries that overflowed."""
    from local_search_quantization_torch.ops import select_kernels as sk

    ids, count = sk.scan_key(luts, Bt, extra, t0, cap)
    want_ids, want_count = sk.scan_key_reference(luts, Bt, extra, t0, cap)
    torch.cuda.synchronize()
    same_count = torch.equal(count, want_count)
    over = count > cap
    filled = torch.arange(cap, device=ids.device)[None, :] < count.clamp(max=cap)[:, None]
    tail_empty = bool((ids[~filled] == -1).all())
    got = torch.sort(torch.where(filled, ids, -1), dim=1)[0]
    same_ids = torch.equal(got[~over], torch.sort(want_ids, dim=1)[0][~over])
    subset = True
    if bool(over.any()):
        # Every hit of the overflowed queries (a cap no list can fill), sorted.
        rows = torch.nonzero(over)[:, 0]
        every, _ = sk.scan_key_reference(luts[rows], Bt, extra, t0[rows],
                                         int(count.max()))
        every = torch.where(every < 0, 2 ** 31 - 1, every)  # ascending throughout
        g = got[rows]
        at = torch.searchsorted(every.long().contiguous(), g.long().contiguous())
        found = torch.gather(every, 1, at.clamp(max=every.shape[1] - 1)) == g
        distinct = (g[:, 1:] != g[:, :-1]).all()
        subset = bool(found.all() and distinct)
    print(f"K4 {label}: cap {cap}, appended per query min/mean/max "
          f"{int(count.min())}/{float(count.float().mean()):.1f}/{int(count.max())}, "
          f"counts identical {same_count}, id sets identical on {int((~over).sum())} "
          f"queries {same_ids}; {int(over.sum())} overflowed, their ids {cap} distinct "
          f"hits: {subset}")
    check(same_count and same_ids and subset and tail_empty,
          f"K4 {label}: disagrees with its plain version")
    return int(over.sum())


def check_key(torch, label, luts, Bt, extra, t0, cap, k2_out):
    """K4's appended ids and counts against its plain version, then the key
    variant (re-rank, sort, per-query certificate) against K2: every
    certified query identical; `scan_topk_warm` (which reruns the others on
    K3) identical on all. Returns (queries certified, max |d - K2's d|)."""
    from local_search_quantization_torch.ops import select_kernels as sk

    check(check_k4_appends(torch, label, luts, Bt, extra, t0, cap) == 0,
          f"K4 {label}: the warm bound's list overflowed")
    d, i, bad = sk._key_scan_topk(luts, Bt, extra, K, t0, cap)
    _, _, any_bad = sk.fused_scan_topk(luts, Bt, extra, k=K, t0=t0, variant="key",
                                       append_cap=cap)
    ok = ~bad
    same_ok = torch.equal(d[ok], k2_out[0][ok]) and torch.equal(i[ok], k2_out[1][ok])
    launches = sk.scan_select.launches
    fd, fi = sk.scan_topk_warm(luts, Bt, extra, k=K, variant="key")
    same_all = torch.equal(fd, k2_out[0]) and torch.equal(fi, k2_out[1])
    print(f"K4 {label} key variant: {int(ok.sum())} of {ok.numel()} queries certified, "
          f"identical to K2 {same_ok}; scan_topk_warm (the other {int(bad.sum())} rerun "
          f"on K3, {sk.scan_select.launches - launches} K3 launches with the pre-scan) "
          f"identical to K2 on all {same_all}")
    check(same_ok and same_all and bool(any_bad) == bool(bad.any()),
          f"K4 {label}: the key variant's answer is not K2's")
    return int(ok.sum()), float(torch.nan_to_num((fd - k2_out[0]).abs(), posinf=0.0).max())


# K4's kernel template in a mangled name: <code type, G, kQ, kR>, the code
# type h (unsigned char) or i (int).
K4_KERNEL = r"scan_keyI([hi])Li(\d+)ELi(\d+)ELi(\d+)EE"
# K4 before its redesign, cited beside the new time (it is not built any
# more): this script's run at the commit before the redesign, on one H100
# 80GB HBM3 at 700.00 W.
K4_FIRST_PORT_MS = 2.791


def k4_sass(geometry) -> dict:
    """The shared-memory loads in the SASS of K4's kernels of `geometry`
    (g, kq, kr), read with cuobjdump from the built library: {code type:
    {load width in bits: count}}. The placeholders that ptxas puts before a
    cp.async (`@!PT LDS RZ, [RZ]`) load nothing and are not counted."""
    import re
    import shutil

    from local_search_quantization_torch import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        tool = shutil.which("cuobjdump")
    check(tool is not None, "cuobjdump not found beside nvcc or on PATH: K4's SASS "
          "cannot be read")
    sass = subprocess.run([tool, "-sass", _build._paths("scan_key")[1]],
                          capture_output=True, text=True, timeout=120).stdout
    out, cur = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            head = re.search(K4_KERNEL, line)
            cur = None
            if head and tuple(int(x) for x in head.groups()[1:]) == tuple(geometry):
                cur = out.setdefault(head.group(1), {})
        elif cur is not None and "@!PT" not in line:
            load = re.search(r"\bLDS(?:\.U?(\d+))?\b", line)
            if load:
                width = int(load.group(1) or 32)
                cur[width] = cur.get(width, 0) + 1
    return out


def phase_k4(torch, inputs, t0, cap):
    """K4 against its plain version, and the key variant against K2: on K2's
    inputs (the LSQ tables) at nq 1, 32 and 1000 with uint8 and int32 codes,
    on a base of 300,007 rows (ragged tiles, element-wise staging), at m=5,
    h=40 and with a cap small enough to overflow; on tables with unit-normal
    entries over the same codes, where the certificate's bf16 bound is small
    beside the distances' spread; then its times, and the width of the
    shared-memory loads of the kernels that ran."""
    from local_search_quantization_torch.ops import select_kernels as sk

    luts, Bt, extra, k2_out = inputs
    dev = luts.device
    Bt32 = Bt.to(torch.int32)
    _, err = check_key(torch, "LSQ tables", luts, Bt, extra, t0, cap, k2_out)
    for nq in (K2_QUERIES, 32, 1):
        for name, codes in (("uint8", Bt), ("int32", Bt32)):
            check_k4_appends(torch, f"nq={nq}, {name} codes", luts[:nq].contiguous(), codes,
                             extra, t0[:nq].contiguous(), cap)
    n2 = 300_007
    Br, er, lr = Bt[:, :n2].contiguous(), extra[:n2].contiguous(), luts[:32].contiguous()
    tr, capr = sk.warm_bound(lr, Br, er, k=K)
    for name, codes in (("uint8", Br), ("int32", Br.to(torch.int32))):
        check_k4_appends(torch, f"nq=32, n={n2} (no multiple of 16), {name} codes", lr,
                         codes, er, tr, capr)
    over = check_k4_appends(torch, "nq=1000, cap 1024 (overflow)", luts, Bt, extra, t0, 1024)
    check(over > 0, "K4: a cap of 1024 did not overflow at the warm bound")
    gen = torch.Generator(device=dev).manual_seed(17)
    l40 = torch.randn((33, 5, 40), generator=gen, device=dev)
    B40 = torch.randint(0, 40, (5, 200_001), generator=gen, device=dev, dtype=torch.int32)
    t40, cap40 = sk.warm_bound(l40, B40, None, k=K)
    for name, codes in (("uint8", B40.to(torch.uint8)), ("int32", B40)):
        check_k4_appends(torch, f"m=5, h=40, nq=33, n=200001, {name} codes", l40, codes,
                         torch.zeros(200_001, device=dev), t40, cap40)
    normal = torch.randn(luts.shape, generator=gen, device=dev)
    zero = torch.zeros_like(extra)
    normal_k2 = sk.scan_topk(normal, Bt, zero, K)
    nt0, ncap = sk.warm_bound(normal, Bt, zero, k=K)
    certified, nerr = check_key(torch, "unit-normal tables", normal, Bt, zero, nt0,
                                ncap, normal_k2)
    check(certified == K2_QUERIES,
          "K4: the key variant's certificate failed on unit-normal tables")
    err = max(err, nerr)
    times = {}
    for nq in (1, 32, K2_QUERIES):
        lq, tq = luts[:nq].contiguous(), t0[:nq].contiguous()
        times[nq] = {name: cuda_ms(torch, lambda c=codes: sk.scan_key(lq, c, extra, tq, cap), 5)
                     for name, codes in (("uint8", Bt), ("int32", Bt32))}
        geo = sk.k4_geometry(M, H, 1, nq)
        print(f"[{CARD}] K4 time at nq={nq} x {K2_N}, cap {cap} ({geo[0]} queries a block, "
              f"{geo[1]} a lane, {geo[2]} rows a lane, tiles of "
              f"{sk.k4_tile_steps(M, H, 1, *geo)} steps with uint8 and "
              f"{sk.k4_tile_steps(M, H, 4, *geo)} with int32 codes): uint8 codes "
              f"{times[nq]['uint8']:.3f} ms, int32 codes {times[nq]['int32']:.3f} ms")
    ms = times[K2_QUERIES]["uint8"]
    # What the choices measure, on uint8 codes at nq=1000: the tile length
    # (the cap on `k4_tile_steps` set for the call), and a bound that no row
    # passes (the scan alone, without an append).
    geo = sk.k4_geometry(M, H, 1, K2_QUERIES)
    by_steps, most = {}, sk._K4_MAX_TILE_STEPS
    try:
        for st in (1, 2, 4):
            sk._K4_MAX_TILE_STEPS = st
            by_steps[st] = cuda_ms(torch, lambda: sk.scan_key(luts, Bt, extra, t0, cap), 5)
    finally:
        sk._K4_MAX_TILE_STEPS = most
    never = torch.full_like(t0, -1e30)
    no_hit = cuda_ms(torch, lambda: sk.scan_key(luts, Bt, extra, never, cap), 5)
    prep = cuda_ms(torch, lambda: sk.k4_interleave(luts, geo[0]), 5)
    print(f"[{CARD}] K4 at nq={K2_QUERIES} x {K2_N}, {geo} (queries a block, queries a "
          "lane, rows a lane), ms with tiles of 1 / 2 / 4 steps: "
          + " / ".join(f"{by_steps[st]:.3f}" for st in (1, 2, 4))
          + f"; with a bound no row passes {no_hit:.3f}; rounding and interleaving the "
          f"tables alone {prep:.3f}")
    full = cuda_ms(torch, lambda: sk.fused_scan_topk(
        luts, Bt, extra, k=K, t0=t0, variant="key", append_cap=cap), 5)
    plain = cuda_ms(torch, lambda: sk.scan_key_reference(luts, Bt, extra, t0, cap), 2)
    # The shared-memory bytes K4 must read: m entries of 2 bytes a (query, row).
    smem_ms = K2_QUERIES * K2_N * M * 2 / SMEM_BYTES * 1e3
    print(f"[{CARD}] K4 time for {K2_QUERIES} queries x {K2_N}: kernel {ms:.3f} ms (before "
          f"its redesign {K4_FIRST_PORT_MS} ms, one H100 80GB HBM3 at 700.00 W, this "
          f"script's run at the commit before), kernel + re-rank + sort + certificate "
          f"{full:.3f} ms, "
          f"plain {plain:.3f} ms; practical bound {smem_ms:.4f} ms (the table entries' "
          f"{K2_QUERIES * K2_N * M * 2 / 1e9:.1f} GB of shared memory at 128 bytes an SM a "
          f"clock): {smem_ms / ms:.0%} of it")
    sass = k4_sass(geo)
    wide = 16 * geo[1]  # kQ bf16 entries a load
    print(f"K4 {geo}: shared-memory loads in the SASS, by width in bits: uint8 codes "
          f"{sass.get('h')}, int32 codes {sass.get('i')}; the lookups are {wide}-bit loads")
    # A lane loads the codes of its kR rows at once (16 bits for 2 byte codes)
    # and then makes kR lookups: lookups that fell back to 2-byte loads would
    # show kQ narrow loads for every wide one.
    for code in ("h", "i"):
        loads = sass.get(code, {})
        narrow = loads.get(8, 0) + loads.get(16, 0)
        check(loads.get(wide, 0) >= 4 and narrow * geo[2] <= loads.get(wide, 0),
              f"K4 {geo} ({code}): expected its table lookups as {wide}-bit shared loads "
              f"and 8- or 16-bit loads only for the codes, got {loads}")
    # bf16 LUTs in; [nq, cap] int32 ids and [nq] counts out.
    return (err, ms, plain, *scan_bound(K2_QUERIES, K2_N, cap + 1, 1, lut_bytes=2,
                                        out_bytes=4))


def mrf_cost_chunked(torch, X, B, C):
    """Per-row MRF cost, the metric ILS accepts in, in 131072-row chunks."""
    from local_search_quantization_torch.ops.icm import cost_from_luts
    from local_search_quantization_torch.ops.luts import get_binaries, get_unaries

    b = get_binaries(C)
    out = []
    for s in range(0, X.shape[0], 1 << 17):
        x = X[s:s + (1 << 17)]
        out.append(cost_from_luts((x * x).sum(-1), get_unaries(x, C), b,
                                  B[s:s + (1 << 17)]))
    return torch.cat(out)


def drive_path(torch, demo, data, dev, label, mode, init):
    """One main path: train (reusing `init`'s OPQ/ChainQ when given), encode
    the base, quantize norms, query, recall; the launch counters are zeroed
    just before and read just after. Returns (launches, train info, recall)."""
    from local_search_quantization_torch.ops import select_kernels
    from local_search_quantization_torch.ops.adc import lsq_query_luts
    from local_search_quantization_torch.utils.config import LSQConfig
    from local_search_quantization_torch.utils.synth import random_codes

    args = demo.parse_args([
        "--dataset", "synthetic", "--ntrain", str(MAIN["ntrain"]),
        "--nbase", str(MAIN["nbase"]), "--nquery", str(MAIN["nquery"]),
        "--m", str(M), "--h", str(H), "--niter", str(MAIN["niter"]),
        "--ilsiter-base", str(MAIN["ilsiter_base"]), "--knn", str(K),
        "--synth-d", str(D), "--device", "cuda", "--condition-mode", mode])
    cfg = LSQConfig(m=M, h=H, niter=args.niter, seed=args.seed,
                    condition_mode=args.condition_mode)
    x_train, x_base, x_query, gt = data
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counters()
    t0 = time.perf_counter()
    lsq, info = demo.train(args, cfg, x_train, dev, init=init)
    out = demo.run_pipeline_tail(args, lsq, cfg, x_base, x_query, gt, dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters()
    peak = torch.cuda.max_memory_allocated()
    ms = out["milestones"][MAIN["ilsiter_base"]]
    rec = ms["recall"]
    reused = " (reused from path A)" if init is not None else ""
    print(f"[{CARD}] path {label} ({mode}): OPQ {info['opq_s']:.3f} s, error "
          f"{float(info['opq'].obj[-1]):.6e}{reused}; ChainQ {info['chainq_s']:.3f} s, "
          f"error {float(info['chain'].obj[-1]):.6e}{reused}; LSQ {info['lsq_s']:.3f} s, "
          f"error {float(lsq.obj[-1]):.6e}")
    print(f"[{CARD}] path {label} ({mode}): base encode {out['encode_s']:.3f} s "
          f"({out['encode_vec_per_s']:.0f} vec/s, LSQ-{MAIN['ilsiter_base']}), "
          f"norms {ms['norms_s']:.3f} s, query {ms['query_s']:.3f} s "
          f"({ms['qps']:.1f} qps at k={K}), wall {wall:.3f} s")
    print(f"path {label} ({mode}): recall " + ", ".join(
        f"r@{n}={rec[n - 1]:.4f}" for n in (1, 10, 100, 1000) if n <= K))
    print(f"path {label} ({mode}): LSQ train obj {lsq.obj[0]:.6e} -> {lsq.obj[-1]:.6e}, "
          f"base error {ms['base_error']:.6e}, peak device memory {peak / 2**30:.3f} GiB")
    print(f"path {label} ({mode}): kernel launches {launches}")

    check(bool(lsq.obj[-1] < lsq.obj[0]), f"path {label}: LSQ objective did not fall")
    check(bool(info["chain"].obj[-1] < info["opq"].obj[-1]),
          f"path {label}: ChainQ did not improve on OPQ")
    check(bool(lsq.obj[-1] < info["chain"].obj[-1]),
          f"path {label}: LSQ did not improve on ChainQ")
    Xb = torch.as_tensor(x_base, device=dev)
    B0 = torch.as_tensor(random_codes(args.seed, x_base.shape[0], M, H), device=dev)
    cost0 = mrf_cost_chunked(torch, Xb, B0, lsq.C)
    check(bool((ms["cost"] <= cost0).all()), f"path {label}: base encode raised some row's cost")
    check(bool(torch.isfinite(ms["cost"]).all()), f"path {label}: non-finite base cost")
    ids, dists = ms["ids"], ms["dists"]
    check(tuple(ids.shape) == (MAIN["nquery"], K) and ids.dtype == torch.int32,
          f"path {label}: query ids have shape {tuple(ids.shape)} {ids.dtype}")
    check(bool(((ids >= 0) & (ids < x_base.shape[0])).all()), f"path {label}: ids out of range")
    check(bool(torch.isfinite(dists).all() and (dists.diff(dim=1) >= 0).all()),
          f"path {label}: dists not finite and ascending")
    check(bool((rec[1:] >= rec[:-1]).all()), f"path {label}: recall curve decreases")
    check(rec[K - 1] >= 0.5 and rec[K - 1] > rec[0],
          f"path {label}: recall@{K} {rec[K - 1]} too low")
    # The kernel's answers on the real encoded base against the plain version.
    Bt = ms["B"].t().to(torch.uint8).contiguous()
    luts = lsq_query_luts(torch.as_tensor(x_query[:32], device=dev), lsq.C).contiguous()
    rd, ri = select_kernels.scan_topk_reference(luts, Bt, ms["db_norms"], K)
    check(torch.equal(ri, ids[:32]) and torch.equal(rd, dists[:32]),
          f"path {label}: query results differ from the plain version")
    print(f"path {label}: checks passed (objectives fall OPQ > ChainQ > LSQ, accept "
          "invariant, recall curve, plain-version agreement on 32 queries)")
    info["lsq"] = lsq
    return launches, info, rec


COUNTED = ("ils_encode", "scan_topk", "icm_sweeps_v2", "icm_sweeps_v1", "scan_select",
           "scan_key", "icm_sweeps_dissect")


def zero_counters():
    from local_search_quantization_torch.ops import launch_counts

    launch_counts.zero()


def read_counters() -> dict:
    from local_search_quantization_torch.ops import launch_counts

    return launch_counts.read()


class Env:
    """Set environment variables for a block, then restore them."""

    def __init__(self, **values):
        self.values = values

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in self.values}
        os.environ.update(self.values)

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def search_route(torch, idx, Q, k, env, method, precision="f32", refine=None):
    """One route over all queries, run twice; returns the second run's
    (result, seconds, reruns by certificate). method None is
    `Index.search`; otherwise `adc.linscan_lsq` on the index's uploaded
    codes with that topk_method."""
    from local_search_quantization_torch.ops import adc

    def run():
        if method is None:
            return idx.search(Q, k=k, precision=precision, refine=refine)
        return adc.linscan_lsq(idx.B, Q, idx.model.C, idx._dbn, k=k,
                               precision=precision, topk_method=method,
                               device_state=idx._device_scan_state())

    with Env(**env):
        run()
        for key in adc.RERUNS:
            adc.RERUNS[key] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0, dict(adc.RERUNS)


IVF_NLIST = 1024


def phase_ivf_routes(torch, idx, Q, gt, base):
    """Path C's IVF steps: search(k, nprobe=p) for p = 1, 8, 32 and nlist, on
    the partition that was built, saved and loaded. At p = nlist the
    distances must be the default route's (`base`) on every query, and the
    ids on every query whose k-th distance is not tied; recall@10 must not
    fall as p grows; no pad row is returned."""
    from local_search_quantization_torch.utils.eval import eval_recall

    nq = Q.shape[0]
    wide = idx.search(Q, k=K + 1).dists
    untied = wide[:, K - 1] < wide[:, K]
    recalls = []
    for p in (1, 8, 32, IVF_NLIST):
        if p < IVF_NLIST:
            idx.search(Q, k=K, nprobe=p)  # the first run uploads the grouped store
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        res = idx.search(Q, k=K, nprobe=p)
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        rec = eval_recall(gt, res.ids.cpu().numpy(), K, verbose=False)
        recalls.append(rec)
        live = res.ids >= 0
        print(f"[{CARD}] path C IVF nprobe={p:<5} k={K}: {s * 1e3:9.3f} ms, {nq / s:10.1f} "
              f"qps, recall " + ", ".join(f"@{n} {rec[n - 1]:.4f}" for n in (1, 10, 100))
              + f"; peak device memory {peak / 2**30:.3f} GiB, {(peak - held) / 2**30:.3f} "
              f"GiB above what was held (the padded gather); slots filled "
              f"{float(live.float().mean()):.4f}")
        check(res.ids.dtype == torch.int64 and tuple(res.ids.shape) == (nq, K)
              and bool((res.ids[live] < idx.n).all())
              and bool(torch.isfinite(res.dists[live]).all())
              and bool(torch.isinf(res.dists[~live]).all())
              and bool((res.dists[:, 1:] >= res.dists[:, :-1]).all()),
              f"path C IVF nprobe={p}: ids or dists malformed (a pad row, or not ascending)")
    check(all(b[9] >= a[9] for a, b in zip(recalls, recalls[1:])),
          f"path C IVF: recall@10 falls as nprobe grows: {[r[9] for r in recalls]}")
    same_d = torch.equal(res.dists, base.dists)
    same_i = torch.equal(res.ids[untied], base.ids[untied].long())
    print(f"path C IVF nprobe={IVF_NLIST}: dists identical to the default route on all "
          f"{nq} queries {same_d}; ids identical on the {int(untied.sum())} whose k-th "
          f"distance is not tied {same_i}, on all {torch.equal(res.ids, base.ids.long())}")
    check(same_d and same_i, "path C IVF: the full probe is not the exhaustive search")


def check_ivf_mutations(torch, idx, Q, probe, gone, added):
    """After delete and add: no probed search returns a tombstoned id, and a
    row added after build_ivf is found through the tail at nprobe = 8."""
    for p in (8, IVF_NLIST):
        after = idx.search(Q[:1], k=K, nprobe=p)
        check(not np.isin(after.ids.cpu().numpy(), gone).any(),
              f"path C IVF nprobe={p}: a deleted id came back")
    found = idx.search(probe, k=100, nprobe=8).ids.cpu().numpy()
    hit = float(np.mean([i in row for i, row in zip(added[:1000], found)]))
    print(f"path C IVF: after delete no probed search returns a deleted id; of 1000 rows "
          f"added after build_ivf {hit:.4f} are found in their own top-100 at nprobe=8 "
          f"(the tail of {idx.n - idx.ivf.n_grouped} rows, scanned through K2)")
    check(hit >= 0.9, "path C IVF: rows added after build_ivf are not found through the tail")


def phase_serving(torch, data, dev):
    """Path C: Index.build -> save -> load -> search on every route ->
    refine -> delete, add, compact. Returns its kernel launch counts and the
    default route's recall curve at k=1000."""
    from local_search_quantization_torch.index import Index
    from local_search_quantization_torch.ops import adc
    from local_search_quantization_torch.utils.eval import eval_recall

    x_train, x_base, x_query, gt = data
    torch.cuda.synchronize()
    zero_counters()
    t0 = time.perf_counter()
    built = Index.build(x_train, x_base, "lsq", m=M, h=H, niter=MAIN["niter"],
                        ilsiter=MAIN["ilsiter_base"], seed=0, refine="sq8", device=dev)
    torch.cuda.synchronize()
    print(f"[{CARD}] path C: Index.build('lsq', m={M}, h={H}, niter={MAIN['niter']}, "
          f"ilsiter={MAIN['ilsiter_base']}, refine='sq8') of {x_base.shape[0]} rows in "
          f"{time.perf_counter() - t0:.3f} s, LSQ obj {float(built.model.obj[0]):.6e} -> "
          f"{float(built.model.obj[-1]):.6e}")
    t0 = time.perf_counter()
    built.build_ivf(nlist=IVF_NLIST)
    torch.cuda.synchronize()
    lives = built.ivf.lives
    print(f"[{CARD}] path C: build_ivf(nlist={IVF_NLIST}) over {built.n} rows in "
          f"{time.perf_counter() - t0:.3f} s (reconstructions, k-means on a sample of "
          f"{min(1 << 18, built.n)}, assignment, grouping); lists of {int(lives.min())} to "
          f"{int(lives.max())} rows, {built.ivf.order.shape[0] - built.n} pad rows")
    with tempfile.TemporaryDirectory() as path:
        t0 = time.perf_counter()
        built.save(path)
        idx = Index.load(path, device=dev)
        print(f"path C: save + load {time.perf_counter() - t0:.3f} s")
    same = (np.array_equal(idx.B, built.B) and np.array_equal(idx._dbn, built._dbn)
            and all(torch.equal(a, b) for a, b in zip(idx.model, built.model)
                    if isinstance(a, torch.Tensor))
            and torch.equal(idx.refine.data, built.refine.data))
    same_ivf = idx.ivf is not None and all(
        np.array_equal(v, idx.ivf.to_arrays()[name])
        for name, v in built.ivf.to_arrays().items())
    print(f"path C: loaded codes, norms, model and refine store identical: {same}; IVF "
          f"partition identical: {same_ivf}")
    check(same and same_ivf, "path C: the loaded index differs from the saved one")
    Q = torch.as_tensor(x_query, device=dev)
    idx.search(Q, k=K)
    torch.cuda.synchronize()
    print(f"main path launches (Index.build + one {Q.shape[0]}-query search at "
          f"k={K}): {read_counters()}")
    luts = idx._query_luts(Q)
    dbn = torch.as_tensor(idx._dbn, device=dev)
    qscale = luts.abs().amax(dim=2).sum(dim=1) + dbn[torch.isfinite(dbn)].abs().max()

    def report(label, res, s, reruns, k):
        rec = eval_recall(gt, res.ids.cpu().numpy(), k, verbose=False)
        print(f"[{CARD}] path C {label:<34} k={k}: {s * 1e3:9.3f} ms, "
              f"{Q.shape[0] / s:10.1f} qps, recall " + ", ".join(
                  f"@{n} {rec[n - 1]:.4f}" for n in (1, 10, 100, 1000, 10000) if n <= k)
              + f"; reruns warm {reruns['warm']}, widen {reruns['widen']}, "
              f"tournament {reruns['tournament']}")
        return rec

    routes = [("default (K2)", {}, None),
              ("sorted (K3 warm)", {"LSQ_TPU_SELECT_VARIANT": "sorted"}, None),
              ("unsorted (K3 warm + widen)", {"LSQ_TPU_SELECT_VARIANT": "unsorted"}, None),
              ("key (K4, pre-scan on K3)", {"LSQ_TPU_SELECT_VARIANT": "key"}, None),
              ("tournament, store", {"LSQ_TPU_TOPK_STORE": "1"}, "tournament"),
              ("tournament, recompute", {"LSQ_TPU_TOPK_STORE": "0"}, "tournament"),
              ("exact", {}, "exact")]
    results, recalls = {}, {}
    for label, env, method in routes:
        res, s, reruns = search_route(torch, idx, Q, K, env, method)
        recalls[label] = report(label, res, s, reruns, K)
        results[label] = res
    base = results["default (K2)"]
    for label, res in results.items():
        check(torch.equal(res.ids, base.ids),
              f"path C: route {label} returns other ids than the default route")
    # The recompute-mode certificate's slack, the one constant the gate reads.
    rec_d = results["tournament, recompute"].dists
    check(bool(((rec_d - base.dists).abs() <= adc.TIE_SLACK * qscale[:, None]).all()),
          "path C: recompute-mode distances beyond TIE_SLACK")
    print(f"path C: all {len(routes)} f32 routes return identical ids at k={K}; "
          f"recompute-mode dists within TIE_SLACK={adc.TIE_SLACK} x summand scale")

    bf16 = {}
    for label, env, method in (("default (K2)", {}, None),
                               ("sorted (K3 warm)", {"LSQ_TPU_SELECT_VARIANT": "sorted"}, None),
                               ("exact", {}, "exact")):
        res, s, reruns = search_route(torch, idx, Q, K, env, method, precision="bf16")
        report("bf16 " + label, res, s, reruns, K)
        bf16[label] = res
    check(all(torch.equal(r.ids, bf16["default (K2)"].ids) for r in bf16.values()),
          "path C: bf16 routes disagree")
    try:
        with Env(LSQ_TPU_SELECT_VARIANT="key"):
            idx.search(Q, k=K, precision="bf16")
        fail("path C: key + bf16 did not raise")
    except ValueError as e:
        print(f"path C: bf16 routes identical; key + bf16 raises ValueError ({e})")

    deep = {}
    for label, env, method in (("default (K2 grouped_unsorted + widen)", {}, None),
                               ("tournament, store", {}, "tournament"),
                               ("sorted (K3 warm)", {"LSQ_TPU_SELECT_VARIANT": "sorted"},
                                None)):
        res, s, reruns = search_route(torch, idx, Q, 10_000, env, method)
        report(label, res, s, reruns, 10_000)
        deep[label] = res
    first = next(iter(deep.values()))
    check(all(torch.equal(r.ids, first.ids) for r in deep.values()),
          "path C: k=10000 routes disagree")

    res, s, reruns = search_route(torch, idx, Q, 100, {}, None, precision="bf16",
                                  refine=10)
    rec = report("refine=10 over bf16 (sq8 store)", res, s, reruns, 100)
    check(rec[0] > 0.9, f"path C: refined recall@1 {rec[0]} too low")

    phase_ivf_routes(torch, idx, Q, gt, base)

    q0 = Q[:1]
    gone = idx.search(q0, k=K).ids[0].cpu().numpy()
    idx.delete(gone)
    after = idx.search(q0, k=K)
    back = int(np.isin(after.ids.cpu().numpy(), gone).sum())
    added = idx.add(x_train[:10_000])
    probe = torch.as_tensor(x_train[:1000], device=dev)
    found = idx.search(probe, k=100).ids.cpu().numpy()
    hit = float(np.mean([i in row for i, row in zip(added[:1000], found)]))
    check_ivf_mutations(torch, idx, Q, probe, gone, added)
    ref = idx.search(Q[:100], k=100)
    old_of_new = idx.compact()
    comp = idx.search(Q[:100], k=100)
    remap = torch.as_tensor(old_of_new, device=dev)[comp.ids.long()].int()
    full = idx.search(Q[:100], k=100, nprobe=IVF_NLIST)
    check(torch.equal(full.ids, comp.ids.long()) and torch.equal(full.dists, comp.dists)
          and idx.ivf.n_grouped == x_base.shape[0] - gone.size,
          "path C: after compact the full-probe IVF search is not the exhaustive one")
    print(f"path C: deleted {gone.size} ids nearest query 0, {back} came back; added "
          f"{len(added)} rows (ids {added[0]}..{added[-1]}), {hit:.4f} of 1000 found in "
          f"their own top-100; compact -> n={idx.n}; search after compact maps back: "
          f"{torch.equal(remap, ref.ids) and torch.equal(comp.dists, ref.dists)}")
    check(back == 0 and bool(torch.isfinite(after.dists).all()),
          "path C: a deleted id came back")
    check(added == list(range(x_base.shape[0], x_base.shape[0] + 10_000)) and hit >= 0.9,
          "path C: added rows not found")
    check(idx.n == x_base.shape[0] + 10_000 - gone.size and torch.equal(remap, ref.ids)
          and torch.equal(comp.dists, ref.dists), "path C: compact renumbered wrongly")
    torch.cuda.synchronize()
    launches = read_counters()
    print(f"path C: kernel launches {launches}")
    check(all(launches[n] > 0 for n in ("ils_encode", "scan_topk", "k2_filter",
                                        "k2_select", "scan_select", "scan_key")),
          f"path C: a kernel of the path never launched: {launches}")
    return launches, recalls["default (K2)"]


# Path E: the serving command line (the twins of scripts/build_index.py,
# serve.py and eval_index.py, and of benchmarks/bench_serve.py) run as a user
# runs them, in subprocesses on the card, at SIFT1M's shape.
CLI_SCRIPTS = os.path.join(ROOT, "local_search_quantization_torch", "scripts")
CLI_NBASE = 1_000_000
CLI_BUILD = ["--method", "lsq", "--dataset", "synthetic", "--ntrain", "100000",
             "--nbase", str(CLI_NBASE), "--m", str(M), "--h", str(H), "--niter", "10",
             "--ilsiter", "16", "--ivf-nlist", str(IVF_NLIST), "--refine", "sq8",
             "--seed", "0"]
CLI_ADD = 10_000
# A server is killed this long after it started, so a stuck pipe cannot hang
# the run (its next read then fails the path).
SERVER_DEADLINE_S = 600


def run_twin(script: str, *args: str) -> str:
    """Run a CLI twin to its end; its stdout. Fails the path on a nonzero exit."""
    out = subprocess.run([sys.executable, os.path.join(CLI_SCRIPTS, script), *args],
                         capture_output=True, text=True, timeout=SERVER_DEADLINE_S)
    check(out.returncode == 0, f"path E: {script} exited {out.returncode}: "
                               f"{out.stderr[-3000:]}")
    return out.stdout


class Server:
    """The serve twin in a subprocess on the card, one request at a time: a
    request is written whole, then its response read whole (the header line
    and the binary blocks), so neither pipe can fill."""

    def __init__(self, index: str, log: str, env=None):
        self.log = log
        with open(log, "wb") as err:
            self.proc = subprocess.Popen(
                [sys.executable, os.path.join(CLI_SCRIPTS, "serve.py"), "--index", index,
                 "--k", "100"], stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                stderr=err, env=env)
        self.timer = threading.Timer(SERVER_DEADLINE_S, self.proc.kill)
        self.timer.daemon = True
        self.timer.start()
        t0 = time.perf_counter()
        line = self.proc.stdout.readline()
        self.ready_s = time.perf_counter() - t0
        check(bool(line), f"path E: a server exited before 'ready': {self.stderr()[-3000:]}")
        self.ready = json.loads(line)

    def stderr(self) -> str:
        with open(self.log, errors="replace") as f:
            return f.read()

    def ask(self, req: dict, frame: bytes = b""):
        """(response, client ms): a binary response's blocks are arrays in it."""
        from local_search_quantization_torch.benchmarks.bench_serve import read_response

        t0 = time.perf_counter()
        self.proc.stdin.write(json.dumps(req).encode() + b"\n" + frame)
        self.proc.stdin.flush()
        try:
            resp = read_response(self.proc.stdout)
        except EOFError as e:
            fail(f"path E: the server died on request {req.get('id')} ({e}): "
                 f"{self.stderr()[-3000:]}")
        check("error" not in resp, f"path E: request {req.get('id')} answered {resp}")
        return resp, (time.perf_counter() - t0) * 1e3

    def close(self) -> dict:
        """EOF; fails the path unless the server exits 0. Returns the kernel
        launches its requests made (its last stderr note)."""
        from local_search_quantization_torch.scripts.serve import served_launches

        self.proc.stdin.write(b"EOF\n")
        self.proc.stdin.close()
        code = self.proc.wait(timeout=120)
        check(code == 0, f"path E: a server exited {code}: {self.stderr()[-3000:]}")
        return served_launches(self.stderr())

    def kill(self) -> None:
        self.timer.cancel()
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def framed(rid: int, Q: np.ndarray, **kw):
    """A binary request both ways (both blocks) of the rows Q."""
    return ({"id": rid, "binary_vectors": int(Q.shape[0]), "binary": True, **kw},
            np.ascontiguousarray(Q, "<f4").tobytes())


def latency_batches(x_query):
    """The latency traffic: 200 requests of 1 query, then 50 of 16 (k=100)."""
    return [x_query[(i * nq) % 1000:(i * nq) % 1000 + nq]
            for nq, count in ((1, 200), (16, 50)) for i in range(count)]


def print_latency(where: str, batches, ms) -> None:
    for nq in (1, 16):
        sel = [t for q, t in zip(batches, ms) if q.shape[0] == nq]
        print(f"[{CARD}] path E latency {where}, {len(sel)} requests of {nq} "
              f"quer{'y' if nq == 1 else 'ies'} at k=100, ms: p50 "
              f"{np.percentile(sel, 50):.3f}, p99 {np.percentile(sel, 99):.3f}, min "
              f"{min(sel):.3f}, max {max(sel):.3f}")


def cli_latency(server, batches):
    """The latency traffic as JSON requests; (responses, client ms)."""
    out, ms = [], []
    for i, rows in enumerate(batches):
        resp, t = server.ask({"id": i, "vectors": rows.tolist(), "k": 100})
        check(np.shape(resp["ids"]) == (rows.shape[0], 100),
              "path E: a latency response is malformed")
        out.append(resp)
        ms.append(t)
    print_latency("on the client (JSON)", batches, ms)
    return out


def timed_search(torch, idx, Q, **kw):
    """(result on the host, ms): Index.search and the fetch of both outputs,
    as the server runs them, on the host clock."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = idx.search(Q, **kw)
    out = res.ids.cpu().numpy(), res.dists.cpu().numpy()
    return out, (time.perf_counter() - t0) * 1e3


def cli_replay(torch, idx, batches, served_lat, big, served_key, mutation):
    """The served requests again through `Index.search` on the index as built,
    in this process: every response's ids and distances must be the served
    ones bit for bit (same code, same card). A check of parity only: the
    path's launches are the servers' own counts."""
    from local_search_quantization_torch.ops import adc
    from local_search_quantization_torch.ops.select_kernels import scan_topk

    rows, added, gone, q0, served_after = mutation
    torch.cuda.synchronize()
    failed = scan_topk.failed
    for key in adc.RERUNS:
        adc.RERUNS[key] = 0
    ms, same = [], True
    for Q, resp in zip(batches, served_lat):
        (ids, dists), t = timed_search(torch, idx, Q, k=100)
        ms.append(t)
        same &= (np.array_equal(ids, np.asarray(resp["ids"]))
                 and np.array_equal(dists, np.asarray(resp["dists"], np.float32)))
    print_latency("in this process (Index.search + fetch)", batches, ms)
    print(f"path E replay latency: ids and dists identical to the served JSON {same}; "
          f"queries rerun after a failed K2 certificate {scan_topk.failed - failed}, reruns "
          f"{adc.RERUNS}")
    check(same, "path E: a served latency response differs from Index.search")
    for name, (kw, Q, resp, _) in big.items():
        (ids, dists), t_first = timed_search(torch, idx, Q, **kw)
        _, t_again = timed_search(torch, idx, Q, **kw)
        same_i, same_d = np.array_equal(ids, resp["ids"]), np.array_equal(dists, resp["dists"])
        print(f"[{CARD}] path E replay {name} ({Q.shape[0]} queries, {kw}): Index.search + "
              f"fetch {t_first:.3f} ms, again {t_again:.3f} ms; ids identical {same_i}, "
              f"dists identical {same_d}")
        check(same_i and same_d, f"path E: the served {name} differs from Index.search")
    with Env(LSQ_TPU_SELECT_VARIANT="key"):
        key = idx.search(big["k1000"][1], k=K)
    check(np.array_equal(key.ids.cpu().numpy(), served_key),
          "path E: the key route in this process differs from the key server")
    check(idx.add(rows) == added, "path E: add gave other ids in this process")
    idx.delete(gone)
    after = idx.search(q0, k=100)
    check(np.array_equal(after.ids.cpu().numpy(), served_after["ids"])
          and np.array_equal(after.dists.cpu().numpy(), served_after["dists"]),
          "path E: the query after delete differs from the served one")
    idx.compact()
    torch.cuda.synchronize()
    print(f"path E replay: key route identical to the key server; add, delete, the query "
          f"after it and compact as served; reruns {dict(adc.RERUNS)}")


def served_counts(label: str, launches: dict, kernels) -> dict:
    """A server's own launch counts (its requests only, the warm-up not
    counted); fails the path unless each of `kernels` launched."""
    print(f"path E {label}: kernel launches of its requests {launches}")
    check(all(launches[n] > 0 for n in kernels),
          f"path E: the {label} never launched one of {kernels}: {launches}")
    return launches


def phase_cli(torch, data, dev, recall_c):
    """Path E: build -> eval -> serve (latency, the four protocol modes,
    large batches, a key-route server, mutations) -> the in-process replay
    -> reload. Returns the launches the two servers' requests made, as
    each server counted them: K1 (add), K2, K3 on the first, K4 on the
    key-route one."""
    from local_search_quantization_torch.benchmarks import bench_serve
    from local_search_quantization_torch.index import Index

    x_train, _, x_query, _ = data
    t_path = time.perf_counter()
    servers = []
    with tempfile.TemporaryDirectory() as tmp:
        try:
            index = os.path.join(tmp, "index")
            t0 = time.perf_counter()
            last = run_twin("build_index.py", "--out", index, *CLI_BUILD).splitlines()[-1]
            with open(os.path.join(index, "meta.json")) as f:
                meta = json.load(f)
            print(f"[{CARD}] path E: build_index twin {' '.join(CLI_BUILD)}: build_s "
                  f"{meta['build_s']} (Index.build + build_ivf), "
                  f"{time.perf_counter() - t0:.3f} s with the process, corpus and save; "
                  f"{last[:160]}")

            # The eval twin on the index as built (it regenerates the corpus
            # from the meta, so it runs before any mutation).
            table = os.path.join(tmp, "recall.json")
            t0 = time.perf_counter()
            run_twin("eval_index.py", "--index", index, "--nquery", "1000", "--knn", "1000",
                     "--out", table)
            with open(table) as f:
                ev = json.load(f)
            rec = [ev["recall"][f"r@{n}"] for n in (1, 10, 100, 1000)]
            want = [float(recall_c[n - 1]) for n in (1, 10, 100, 1000)]
            print(f"[{CARD}] path E: eval_index twin, 1000 queries at k=1000 in "
                  f"{time.perf_counter() - t0:.3f} s ({ev['qps']:.1f} qps in the twin): "
                  f"recall@1/10/100/1000 " + " / ".join(f"{r:.4f}" for r in rec)
                  + "; path C's default route " + " / ".join(f"{r:.4f}" for r in want))
            check(all(abs(a - b) <= 0.01 for a, b in zip(rec, want)),
                  "path E: the eval twin's recall is not path C's within 0.01")

            idx = Index.load(index, device=dev)  # the as-built index, for the replay
            a = Server(index, os.path.join(tmp, "a.log"))
            servers.append(a)
            name = torch.cuda.get_device_name(0)
            check(a.ready == {"ready": True, "method": "lsq", "n": CLI_NBASE, "d": D,
                              "k": 100, "ivf_nlist": IVF_NLIST, "refine": "sq8"},
                  f"path E: ready line {a.ready}")
            note = a.stderr().strip()
            check(name in note and "scan_topk" in note,
                  f"path E: the start-up line does not name the card and kernels: {note}")
            print(f"path E: server ready in {a.ready_s:.3f} s (load, kernels, warm-up); "
                  f"stderr: {note}")

            batches = latency_batches(x_query)
            served_lat = cli_latency(a, batches)

            ov = bench_serve.run(index, nq=2048, k=100, batch=256, device=dev)
            for line in bench_serve.lines(ov, a.ready["n"], 2048, 100, 256, dev.type, "f32"):
                print(f"[{CARD}] path E protocol: {line}")

            big = {"k1000": ({"k": K}, x_query),
                   "bf16": ({"k": 100, "precision": "bf16"}, x_query),
                   "refine10": ({"k": 100, "refine": 10}, x_query),
                   "nprobe32": ({"k": K, "nprobe": 32}, x_query),
                   "k10000": ({"k": 10_000}, x_query[:100])}
            # Each sent twice: the first pays for the server's first use of
            # the route (allocations, uploads), the second is steady.
            for i, (label, (kw, Q)) in enumerate(list(big.items())):
                resp, ms = a.ask(*framed(100 + i, Q, **kw))
                again, ms_again = a.ask(*framed(150 + i, Q, **kw))
                check(resp["ids"].shape == (Q.shape[0], kw["k"])
                      and np.array_equal(resp["ids"], again["ids"]),
                      f"path E: {label} response shape {resp['ids'].shape}, or unstable")
                big[label] = (kw, Q, resp, ms_again)
                print(f"[{CARD}] path E {label}: {Q.shape[0]} queries, {kw}, binary both "
                      f"ways: {ms:.3f} client ms, again {ms_again:.3f}")

            b = Server(index, os.path.join(tmp, "b.log"),
                       env=dict(os.environ, LSQ_TPU_SELECT_VARIANT="key"))
            servers.append(b)
            served_key, ms = b.ask(*framed(200, x_query, k=K))
            _, ms_again = b.ask(*framed(201, x_query, k=K))
            same = np.array_equal(served_key["ids"], big["k1000"][2]["ids"])
            print(f"[{CARD}] path E key-route server: ready in {b.ready_s:.3f} s; 1000 "
                  f"queries at k={K} in {ms:.3f} client ms, again {ms_again:.3f}; ids "
                  f"identical to the first server's: {same}")
            check(same, "path E: the key-route server returns other ids")
            served_b = served_counts("key-route server", b.close(), ("scan_key",))

            rows = x_train[:CLI_ADD]
            r_add, ms_add = a.ask({"op": "add", "id": 300, "binary_vectors": CLI_ADD},
                                  np.ascontiguousarray(rows, "<f4").tobytes())
            added = list(range(CLI_NBASE, CLI_NBASE + CLI_ADD))
            check(r_add["added"] == added and r_add["n"] == CLI_NBASE + CLI_ADD,
                  f"path E: add answered n={r_add['n']}")
            gone = big["k1000"][2]["ids"][0, :10]
            r_del, ms_del = a.ask({"op": "delete", "id": 301, "ids": gone.tolist()})
            after, _ = a.ask(*framed(302, x_query[:1], k=100))
            check(r_del["deleted"] == 10 and not np.isin(after["ids"], gone).any(),
                  "path E: a deleted id came back")
            r_comp, ms_comp = a.ask({"op": "compact", "id": 303})
            r_save, ms_save = a.ask({"op": "save", "id": 304})
            n_final = CLI_NBASE + CLI_ADD - 10
            check(r_comp["removed"] == 10 and r_comp["n"] == r_save["n"] == n_final,
                  f"path E: compact/save answered {r_comp}, {r_save}")
            served_a = served_counts("server", a.close(),
                                     ("ils_encode", "scan_topk", "scan_select"))
            print(f"[{CARD}] path E mutations, client ms: add of {CLI_ADD} rows in one "
                  f"frame {ms_add:.3f}, delete of the 10 nearest of query 0 {ms_del:.3f}, "
                  f"compact {ms_comp:.3f} (n={r_comp['n']}), save {ms_save:.3f}")

            cli_replay(torch, idx, batches, served_lat, big, served_key["ids"],
                       (rows, added, gone, x_query[:1], after))
            again = Index.load(index, device=dev)
            found = again.search(rows[:1000], k=100).ids.cpu().numpy()
            hit = float(np.mean([n_final - CLI_ADD + i in row for i, row in enumerate(found)]))
            same = (np.array_equal(again.B, idx.B) and np.array_equal(again._dbn, idx._dbn)
                    and again.n == idx.n == n_final)
            print(f"path E reload: n={again.n}, codes and norms identical to the replay's "
                  f"{same}; {hit:.4f} of 1000 added rows found in their own top-100")
            check(same and hit >= 0.9, "path E: the saved index is not the replayed one")
            del idx, again
            torch.cuda.empty_cache()
        finally:
            for server in servers:
                server.kill()
    print(f"[{CARD}] path E: wall {time.perf_counter() - t_path:.3f} s")
    return {name: served_a[name] + served_b[name] for name in COUNTED}


# Path F: the rest of the quantizer family on path A's corpus and results:
# LSQR codebook updates, RVQ through Index, the paper's 64-bit table
# (`repro_paper` twin) and the small twins at the verify recipe's sizes.
SMALL = ["--dataset", "synthetic", "--ntrain", "2000", "--nbase", "20000",
         "--nquery", "200"]
SMALL_SIZES = ["2000", "20000", "200", "10"]


def timed(torch, fn):
    """(fn(), seconds) with the device idle at both ends."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def path_f1(torch, demo, data, dev, path_a):
    """LSQR against Cholesky on path A's final training codes, two LSQR
    solves bit for bit, the prox solve twice, then LSQ trained with LSQR from path A's ChainQ
    ("auto": K1), an LSQ-16 base encode and the k=1000 query (K2)."""
    from local_search_quantization_torch.ops.costs import qerror
    from local_search_quantization_torch.ops.prox import solve_l1_constrained
    from local_search_quantization_torch.ops.solver import update_codebooks
    from local_search_quantization_torch.utils.config import LSQConfig

    x_train = data[0]
    X = torch.as_tensor(x_train, device=dev)
    B = path_a["lsq"].B
    C_l, s_l = timed(torch, lambda: update_codebooks(X, B, H, method="lsqr"))
    C_l2, s_l2 = timed(torch, lambda: update_codebooks(X, B, H, method="lsqr"))
    C_c, s_c = timed(torch, lambda: update_codebooks(X, B, H, method="cholesky"))
    e_l, e_c = float(qerror(X, B, C_l)), float(qerror(X, B, C_c))
    print(f"[{CARD}] path F1: update_codebooks on path A's codes (n={X.shape[0]}, d={D}, "
          f"m={M}, h={H}): lsqr {s_l * 1e3:.3f} ms, again {s_l2 * 1e3:.3f} ms, cholesky "
          f"{s_c * 1e3:.3f} ms; qerror lsqr {e_l:.6e}, cholesky {e_c:.6e} "
          f"(ratio {e_l / e_c:.6f}); two lsqr solves identical: {torch.equal(C_l, C_l2)}")
    check(e_l <= e_c * (1 + 1e-3), "path F1: LSQR qerror above Cholesky's x (1 + 1e-3)")
    check(torch.equal(C_l, C_l2), "path F1: two LSQR solves differ")
    # SLSQ's prox solve (100 FISTA steps) from the Cholesky codebooks into
    # the ball of 0.7 of their L1 norm, as SLSQ1's tau, twice.
    tau = torch.sum(torch.abs(C_c)) * 0.7
    K_p, s_p = timed(torch, lambda: solve_l1_constrained(B, X, H, tau, C_c))
    K_p2, s_p2 = timed(torch, lambda: solve_l1_constrained(B, X, H, tau, C_c))
    l1 = float(torch.sum(torch.abs(K_p)))
    print(f"[{CARD}] path F1: solve_l1_constrained (100 FISTA steps) {s_p * 1e3:.3f} ms, "
          f"again {s_p2 * 1e3:.3f} ms; ||K||_1 {l1:.6e} of tau {float(tau):.6e}, qerror "
          f"{float(qerror(X, B, K_p)):.6e}; two solves identical: {torch.equal(K_p, K_p2)}")
    check(l1 <= float(tau) * (1 + 1e-5), "path F1: the prox solve left the L1 ball")
    check(torch.equal(K_p, K_p2), "path F1: two prox solves differ")

    args = demo.parse_args([
        "--dataset", "synthetic", "--ntrain", str(MAIN["ntrain"]),
        "--nbase", str(MAIN["nbase"]), "--nquery", str(MAIN["nquery"]),
        "--m", str(M), "--h", str(H), "--niter", str(MAIN["niter"]),
        "--ilsiter-base", str(MAIN["ilsiter_base"]), "--knn", str(K),
        "--synth-d", str(D), "--device", "cuda"])
    cfg = LSQConfig(m=M, h=H, niter=MAIN["niter"], ilsiter=8, seed=args.seed,
                    condition_mode="auto", codebook_method="lsqr")
    lsq, info = demo.train(args, cfg, x_train, dev, init=path_a["info"])
    out = demo.run_pipeline_tail(args, lsq, cfg, data[1], data[2], data[3], dev)
    rec = out["milestones"][MAIN["ilsiter_base"]]["recall"]
    rec_a = path_a["recall"]
    print(f"[{CARD}] path F1: LSQ (lsqr) train {info['lsq_s']:.3f} s (path A, cholesky: "
          f"{path_a['info']['lsq_s']:.3f} s), obj {lsq.obj[0]:.6e} -> {lsq.obj[-1]:.6e} "
          f"(path A {path_a['lsq'].obj[-1]:.6e}); base encode {out['encode_s']:.3f} s")
    print("path F1: recall lsqr vs path A: " + ", ".join(
        f"r@{n} {rec[n - 1]:.4f} vs {rec_a[n - 1]:.4f}" for n in (1, 10, 100, 1000)
        if n <= K))
    check(bool(lsq.obj[-1] < lsq.obj[0]), "path F1: the LSQR-trained objective did not fall")
    check(bool((rec[1:] >= rec[:-1]).all()), "path F1: recall curve decreases")
    check(abs(rec[9] - rec_a[9]) <= 0.03,
          f"path F1: recall@10 {rec[9]:.4f} not within 0.03 of path A's {rec_a[9]:.4f}")


def path_f2(torch, data, dev):
    """RVQ through Index: build, the training codes re-encoded, a k=1000
    search against the plain scan, save -> load, add."""
    from local_search_quantization_torch.index import Index
    from local_search_quantization_torch.models import quantize_rvq
    from local_search_quantization_torch.ops import select_kernels
    from local_search_quantization_torch.utils.eval import eval_recall

    x_train, x_base, x_query, gt = data
    idx, s_build = timed(torch, lambda: Index.build(x_train, x_base, "rvq", m=M, h=H,
                                                    niter=MAIN["niter"], seed=0, device=dev))
    X = torch.as_tensor(x_train, device=dev)
    same_train = torch.equal(quantize_rvq(X, idx.model.C), idx.model.B)
    Q = torch.as_tensor(x_query, device=dev)
    res = idx.search(Q, k=K)
    ms_search = cuda_ms(torch, lambda: idx.search(Q, k=K), 5)
    rec = eval_recall(gt, res.ids.cpu().numpy(), K, verbose=False)
    Bt = torch.as_tensor(idx.B, device=dev).t().to(torch.uint8).contiguous()
    dbn = torch.as_tensor(idx._dbn, device=dev)
    rd, ri = select_kernels.scan_topk_reference(idx._query_luts(Q).contiguous(), Bt, dbn, K)
    plain = torch.equal(ri.long(), res.ids.long()) and torch.equal(rd, res.dists)
    print(f"[{CARD}] path F2: Index.build('rvq', m={M}, h={H}, niter={MAIN['niter']}) of "
          f"{x_base.shape[0]} rows in {s_build:.3f} s, stage obj {idx.model.obj[0]:.6e} -> "
          f"{idx.model.obj[-1]:.6e}; quantize_rvq(train) = training codes: {same_train}; "
          f"search (default route, K2) {ms_search:.3f} ms at k={K}, recall " + ", ".join(
              f"@{n} {rec[n - 1]:.4f}" for n in (1, 10, 100, 1000) if n <= K)
          + f"; ids and dists = scan_topk_reference: {plain}")
    check(same_train, "path F2: quantize_rvq(train) differs from the training codes")
    check(plain, "path F2: the RVQ search differs from the plain scan")
    check(bool((rec[1:] >= rec[:-1]).all()) and rec[K - 1] > rec[0],
          "path F2: recall curve decreases")
    with tempfile.TemporaryDirectory() as path:
        idx.save(path)
        back = Index.load(path, device=dev)
    again = back.search(Q, k=K)
    check(back.method == "rvq" and torch.equal(again.ids, res.ids)
          and torch.equal(again.dists, res.dists), "path F2: save -> load searches otherwise")
    new = x_train[:10_000]
    added, s_add = timed(torch, lambda: back.add(new))
    found = back.search(torch.as_tensor(new, device=dev), k=K).ids.cpu().numpy()
    hit = {k: float(np.mean([i in row[:k] for i, row in zip(added, found)]))
           for k in (100, K)}
    print(f"[{CARD}] path F2: save -> load: identical search; add of {len(added)} rows "
          f"{s_add * 1e3:.1f} ms; found by their own vectors: {hit[100]:.4f} in their "
          f"top-100, {hit[K]:.4f} in their top-{K}")
    check(added == list(range(x_base.shape[0], x_base.shape[0] + 10_000)) and hit[K] >= 0.99,
          "path F2: added rows not found by their own vectors")
    return rec


def path_f3(torch, data, dev, tmp):
    """The `repro_paper` twin's 64-bit table on path A's corpus, then the
    `diag_normbyte` twin on its stage cache."""
    from local_search_quantization_torch.scripts import diag_normbyte, repro_paper

    x_train, x_base, x_query, gt = data
    corpus = os.path.join(tmp, "corpus.npz")
    np.savez(corpus, train=x_train, base=x_base, query=x_query, gt=gt, seed=0)
    stages = os.path.join(tmp, "stages")
    argv = ["--dataset", "synthetic", "--ntrain", str(MAIN["ntrain"]),
            "--nbase", str(MAIN["nbase"]), "--nquery", str(MAIN["nquery"]),
            "--niter", str(MAIN["niter"]), "--h", str(H), "--synth-d", str(D),
            "--milestones", "16,32",
            "--with-chainq", "--with-rvq", "--with-slsq", "--stage-cache", stages,
            "--corpus-cache", corpus, "--out", os.path.join(tmp, "table.json"),
            "--device", dev.type]
    t0 = time.perf_counter()
    try:
        table = repro_paper.main(argv)
    except SystemExit as e:
        fail(f"path F3: the repro_paper twin exited: {e}")
    wall = time.perf_counter() - t0
    rows = table["methods"]
    print(f"[{CARD}] path F3: repro_paper twin {' '.join(argv[:-8])} in {wall:.3f} s "
          f"(platform {table['platform']!r})")
    for name, row in rows.items():
        extra = (f", l0 {row['l0']} of S {row['S']} (dense {row['dense_l0']}), "
                 f"l1 {row['l1']:.6e}" if "l0" in row else "")
        print(f"  {name:<7} train_mse {row['train_mse']:.6e}, wall {row['wall_s']} s, "
              + ", ".join(f"{n} {v:.4f}" for n, v in row["recall"].items()
                          if n in ("r@1", "r@10", "r@100", "r@1000")) + extra)
    want = ("PQ", "OPQ", "ChainQ", "LSQ-16", "LSQ-32", "RVQ", "SLSQ1", "SLSQ2")
    check(all(name in rows for name in want), f"path F3: table rows {sorted(rows)}")
    for name in want:
        r = [rows[name]["recall"][f"r@{n}"] for n in (1, 10, 100, 1000) if n <= K]
        check(all(np.isfinite(r)) and r == sorted(r), f"path F3: {name} recall {r}")
    check(all(rows[v]["l0"] <= rows[v]["S"] for v in ("SLSQ1", "SLSQ2"))
          and rows["SLSQ1"]["l0"] < rows["SLSQ1"]["dense_l0"],
          "path F3: SLSQ sparsity out of its budget")
    nb, s_nb = timed(torch, lambda: diag_normbyte.main([stages, corpus, "--device",
                                                        dev.type]))
    print(f"[{CARD}] path F3: diag_normbyte twin (two {x_base.shape[0]}-row scans, "
          f"default route) {s_nb:.3f} s: " + "; ".join(f"{k}: {v}" for k, v in nb.items()))
    check(nb["quantized(norm byte)"]["r@10"] == rows["LSQ-32"]["recall"]["r@10"],
          "path F3: diag_normbyte's norm-byte scan is not the table's LSQ-32 row")
    return rows


def path_f4(dev):
    """The small twins at the verify recipe's sizes, each recall curve
    never decreasing."""
    import demo_chainq_torch
    import demo_lsq_sparse_torch
    import demo_opq_torch
    import demo_pq_torch

    from local_search_quantization_torch.scripts import calibrate_corpus, diag_flip

    small, on = SMALL + ["--device", dev.type], ["--device", dev.type]
    runs = [("demo_pq_torch", lambda: {"curve": demo_pq_torch.main(small)}),
            ("demo_opq_torch", lambda: {"curve": demo_opq_torch.main(small)}),
            ("demo_chainq_torch", lambda: {"curve": demo_chainq_torch.main(small)}),
            ("demo_lsq_sparse_torch", lambda: {"curve": demo_lsq_sparse_torch.main(
                small + ["--m", "7", "--variant", "SLSQ2"])[1]}),
            ("calibrate_corpus", lambda: calibrate_corpus.main(
                ["0.4", *SMALL[2:], "--niter", "10", *on])[0]),
            ("diag_flip", lambda: diag_flip.main(SMALL_SIZES + on))]
    for name, fn in runs:
        t0 = time.perf_counter()
        out = fn()
        curves = {k: (np.asarray(v) if k == "curve" else
                      np.asarray([v[f"r@{n}"] for n in (1, 10, 100)]))
                  for k, v in out.items() if k == "curve" or isinstance(v, dict)
                  and "r@1" in v}
        print(f"[{CARD}] path F4: {name} {time.perf_counter() - t0:.3f} s: " + "; ".join(
            f"{k} r@1 {c[0]:.4f} ... r@{c.shape[0] if k == 'curve' else 100} {c[-1]:.4f}"
            for k, c in curves.items()))
        check(bool(curves) and all(bool((np.diff(c) >= 0).all()) and c[-1] > 0
                                   for c in curves.values()),
              f"path F4: {name}: a recall curve decreases or stays at 0")


def phase_family(torch, demo, data, dev, path_a):
    """Path F: F1 LSQR, F2 RVQ through Index, F3 the paper table, F4 the
    small twins; K1, K2 and K3 must each launch."""
    torch.cuda.synchronize()
    zero_counters()
    t0 = time.perf_counter()
    path_f1(torch, demo, data, dev, path_a)
    t1 = time.perf_counter()
    path_f2(torch, data, dev)
    t2 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path_f3(torch, data, dev, tmp)
    t3 = time.perf_counter()
    path_f4(dev)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    launches = read_counters()
    print(f"[{CARD}] path F: F1 {t1 - t0:.3f} s, F2 {t2 - t1:.3f} s, F3 {t3 - t2:.3f} s, "
          f"F4 {t4 - t3:.3f} s, wall {t4 - t0:.3f} s")
    print(f"path F: kernel launches {launches}")
    check(all(launches[n] > 0 for n in ("ils_encode", "scan_topk", "scan_select")),
          f"path F: a kernel of the path never launched: {launches}")
    return launches


def phase_main(torch, demo, data, dev):
    """Path A ("auto": K1 and K2), then path B ("fused": K5 and K2) from
    path A's OPQ/ChainQ models. Returns both paths' launches and path A's
    results (its models and recall curve)."""
    launches_a, info, rec_a = drive_path(torch, demo, data, dev, "A", "auto", None)
    check(launches_a["ils_encode"] > 0 and launches_a["scan_topk"] > 0,
          f"path A: a kernel of the path never launched: {launches_a}")
    launches_b, _, rec_b = drive_path(torch, demo, data, dev, "B", "fused", info)
    check(launches_b["icm_sweeps_v2"] > 0 and launches_b["scan_topk"] > 0,
          f"path B: a kernel of the path never launched: {launches_b}")
    check(launches_b["ils_encode"] == 0, f"path B ran K1: {launches_b}")
    print("recall A (auto) vs B (fused): " + ", ".join(
        f"r@{n} {rec_a[n - 1]:.4f} vs {rec_b[n - 1]:.4f}" for n in (1, 10, 100, 1000)))
    return (launches_a, launches_b), {"info": info, "lsq": info["lsq"], "recall": rec_a}


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "local_search_quantization_torch")):
        fail("run from a checkout of the repository: "
             "local_search_quantization_torch/ is not beside this script", 3)
    try:
        import torch
    except ImportError:
        fail("torch is not installed", 2)
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on a GPU", 2)
    sys.path[:0] = [ROOT, os.path.join(ROOT, "demos")]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from local_search_quantization_torch import _build

    import demo_lsq_torch as demo

    global CARD
    t_script = time.perf_counter()
    dev = torch.device("cuda")
    card = CARD = phase_environment(torch, _build)
    t0 = time.perf_counter()
    data = demo.load_data(demo.parse_args([
        "--dataset", "synthetic", "--ntrain", str(MAIN["ntrain"]),
        "--nbase", str(MAIN["nbase"]), "--nquery", str(MAIN["nquery"]),
        "--synth-d", str(D)]))
    print(f"data: synthetic corpus {[a.shape for a in data]} in "
          f"{time.perf_counter() - t0:.3f} s")
    C, k1 = phase_k1(torch, data, dev)
    sweeps = phase_sweeps(torch, C, data, dev)
    k7 = phase_k7(torch, C, data, dev)
    practical = phase_l2(torch, dev)
    k2, k2_inputs = phase_k2(torch, C, data, dev)
    k3, t0, cap = phase_k3(torch, k2_inputs, practical.pop("l2_gbps"))
    k4 = phase_k4(torch, k2_inputs, t0, cap)
    del k2_inputs
    launches_ab, path_a = phase_main(torch, demo, data, dev)
    launches_c, recall_c = phase_serving(torch, data, dev)
    paths = [*launches_ab, launches_c, phase_bench_path(torch, dev),
             phase_cli(torch, data, dev, recall_c),
             phase_family(torch, demo, data, dev, path_a)]
    # Each kernel's count summed over the paths that run it (K6 is on none).
    launches = {name: sum(p[name] for p in paths) for name in COUNTED}

    # K1 reads xsq, the perturbation keys and codes and the visit orders,
    # and writes the costs, beside the unaries, table and codes.
    k1_extra = (K1_N * 4 * 2 + K1_ROUNDS * K1_N * (M + NPERT) * 4
                + K1_ROUNDS * M * 4)
    sweep_bound = icm_bound(K1_N, ICMITER * M, M * M * H * H * 2, M * 4)
    measured = {
        "ils_encode": (*k1, *icm_bound(K1_N, K1_ROUNDS * ICMITER * M,
                                       M * M * H * H * 4, k1_extra)),
        "scan_topk": k2, "icm_sweeps_v2": (*sweeps["v2"], *sweep_bound),
        "icm_sweeps_v1": (*sweeps["v1"], *sweep_bound), "scan_select": k3,
        "scan_key": k4, "icm_sweeps_dissect": (*k7, *sweep_bound)}
    # No single PyTorch call computes any of these functions: library_ms is
    # null (torch.topk, the select half of K2 and K3 alone, is printed above).
    kernels = [{"name": name, "route": "cuda", "source": src, "replaces": site,
                "launches": launches[name], "max_abs_err": measured[name][0],
                "ms": measured[name][1], "plain_ms": measured[name][2],
                "bound_ms": measured[name][3], "bound_by": measured[name][4],
                "library_ms": None}
               for name, (src, site) in KERNELS.items()]
    # The L2 gather probe's bound where the kernel gathers table rows from L2.
    for entry in kernels:
        if entry["name"] in practical:
            entry["practical_bound_ms"] = practical[entry["name"]]
    print(f"[{CARD}] chip_smoke: whole script wall {time.perf_counter() - t_script:.3f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
