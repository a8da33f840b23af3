#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: build, check, drive, report.

    python3 chip_smoke.py

Run from the root of a checkout. Needs a CUDA device and nvcc; imports
nothing of JAX. Phases:

1. the card (nvidia-smi name and power limit), torch and CUDA versions, and
   the build of both kernels from `local_search_quantization_torch/csrc/`;
2. K1 (the whole-ILS encode kernel) against its plain PyTorch version on the
   same streamed randomness: an integer fixture and the SIFT width
   (n=131072, d=128, m=7, h=256, ilsiter=4, icmiter=4, npert=4). Codes,
   costs, milestones and counts must be identical: both sum in one fixed
   order and break ties to the lowest index;
3. K2 (the ADC scan + exact top-k) against its plain version over a
   1M-row base, 1000 queries at k=1000 (the main path's query shape): ids
   and dists identical, for uint8 and int32 code layouts;
4. the main path through `demos/demo_lsq_torch.py`'s functions on the
   synthetic SIFT-statistics corpus (100k train, 1M base, 1000 queries):
   LSQ training from random codes (m=7, h=256, niter=10, ilsiter=8), an
   LSQ-16 base encode, norm quantization, the k=1000 ADC query and recall.
   The kernels' launch counters are zeroed just before it and must be > 0
   after it; the accept invariant, the recall curve and a plain-version
   check of the query results must hold.

Prints the kernels' JSON line and then, last, the device line. Any failed
check exits non-zero before those lines are printed.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# SIFT width of the K1 check and the main path.
D, M, H = 128, 7, 256
K1_N, K1_ROUNDS, ICMITER, NPERT = 131072, 4, 4, 4
K2_N, K2_QUERIES, K = 1_000_000, 1000, 1000
MAIN = dict(ntrain=100_000, nbase=1_000_000, nquery=1000, niter=10, ilsiter_base=16)


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
    for name in ("ils_encode", "scan_topk"):
        _build.load(name)
        info = _build.BUILD_INFO[name]
        print(f"build {name}: {info['seconds']:.2f} s (cached={info['cached']})")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  ptxas: {line.strip()}")
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
    print(f"K1 {label} time: kernel {ms:.3f} ms, plain {plain:.3f} ms "
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
    print(f"K2 time: kernel {times['uint8']:.3f} ms (uint8 codes), "
          f"{times['int32']:.3f} ms (int32 codes), plain {plain:.3f} ms, "
          f"for {K2_QUERIES} queries")
    return err, times["uint8"], plain


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


def phase_main(torch, demo, data, dev):
    from local_search_quantization_torch.ops import icm_kernels, select_kernels
    from local_search_quantization_torch.ops.adc import lsq_query_luts
    from local_search_quantization_torch.utils.config import LSQConfig
    from local_search_quantization_torch.utils.synth import random_codes

    args = demo.parse_args([
        "--dataset", "synthetic", "--ntrain", str(MAIN["ntrain"]),
        "--nbase", str(MAIN["nbase"]), "--nquery", str(MAIN["nquery"]),
        "--m", str(M), "--h", str(H), "--niter", str(MAIN["niter"]),
        "--ilsiter-base", str(MAIN["ilsiter_base"]), "--knn", str(K),
        "--synth-d", str(D), "--device", "cuda"])
    cfg = LSQConfig(m=M, h=H, niter=args.niter, seed=args.seed)
    x_train, x_base, x_query, gt = data
    torch.cuda.reset_peak_memory_stats()
    icm_kernels.ils_encode_streamed.launches = 0
    select_kernels.scan_topk.launches = 0
    t0 = time.perf_counter()
    lsq, train_s = demo.train(args, cfg, x_train, dev)
    out = demo.run_pipeline_tail(args, lsq, cfg, x_base, x_query, gt, dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"ils_encode": icm_kernels.ils_encode_streamed.launches,
                "scan_topk": select_kernels.scan_topk.launches}
    peak = torch.cuda.max_memory_allocated()
    ms = out["milestones"][MAIN["ilsiter_base"]]
    rec = ms["recall"]
    print(f"main path: train {train_s:.3f} s, base encode {out['encode_s']:.3f} s "
          f"({out['encode_vec_per_s']:.0f} vec/s, LSQ-{MAIN['ilsiter_base']}), "
          f"norms {ms['norms_s']:.3f} s, query {ms['query_s']:.3f} s "
          f"({ms['qps']:.1f} qps at k={K}), wall {wall:.3f} s")
    print("main path: recall " + ", ".join(
        f"r@{n}={rec[n - 1]:.4f}" for n in (1, 10, 100, 1000) if n <= K))
    print(f"main path: train obj {lsq.obj[0]:.6e} -> {lsq.obj[-1]:.6e}, base error "
          f"{ms['base_error']:.6e}, peak device memory {peak / 2**30:.3f} GiB")
    print(f"main path: kernel launches {launches}")

    check(all(v > 0 for v in launches.values()),
          f"a kernel of the main path never launched: {launches}")
    check(bool(lsq.obj[-1] < lsq.obj[0]), "training objective did not fall")
    Xb = torch.as_tensor(x_base, device=dev)
    B0 = torch.as_tensor(random_codes(args.seed, x_base.shape[0], M, H), device=dev)
    cost0 = mrf_cost_chunked(torch, Xb, B0, lsq.C)
    check(bool((ms["cost"] <= cost0).all()), "base encode raised some row's cost")
    check(bool(torch.isfinite(ms["cost"]).all()), "non-finite base cost")
    ids, dists = ms["ids"], ms["dists"]
    check(tuple(ids.shape) == (MAIN["nquery"], K) and ids.dtype == torch.int32,
          f"query ids have shape {tuple(ids.shape)} {ids.dtype}")
    check(bool(((ids >= 0) & (ids < x_base.shape[0])).all()), "ids out of range")
    check(bool(torch.isfinite(dists).all() and (dists.diff(dim=1) >= 0).all()),
          "dists not finite and ascending")
    check(bool((rec[1:] >= rec[:-1]).all()), "recall curve decreases")
    check(rec[K - 1] >= 0.5 and rec[K - 1] > rec[0], f"recall@{K} {rec[K - 1]} too low")
    # The kernel's answers on the real encoded base against the plain version.
    Bt = ms["B"].t().to(torch.uint8).contiguous()
    luts = lsq_query_luts(torch.as_tensor(x_query[:32], device=dev), lsq.C).contiguous()
    rd, ri = select_kernels.scan_topk_reference(luts, Bt, ms["db_norms"], K)
    check(torch.equal(ri, ids[:32]) and torch.equal(rd, dists[:32]),
          "main-path query results differ from the plain version")
    print("main path: checks passed (accept invariant, recall curve, "
          "plain-version agreement on 32 queries)")
    return launches


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

    dev = torch.device("cuda")
    card = phase_environment(torch, _build)
    t0 = time.perf_counter()
    data = demo.load_data(demo.parse_args([
        "--dataset", "synthetic", "--ntrain", str(MAIN["ntrain"]),
        "--nbase", str(MAIN["nbase"]), "--nquery", str(MAIN["nquery"]),
        "--synth-d", str(D)]))
    print(f"data: synthetic corpus {[a.shape for a in data]} in "
          f"{time.perf_counter() - t0:.3f} s")
    C, (k1_err, k1_ms, k1_plain) = phase_k1(torch, data, dev)
    k2_err, k2_ms, k2_plain = phase_k2(torch, C, data, dev)
    launches = phase_main(torch, demo, data, dev)

    kernels = [
        {"name": "ils_encode", "route": "cuda",
         "source": "local_search_quantization_torch/csrc/ils_encode.cu",
         "replaces": "local_search_quantization_tpu/ops/icm_pallas.py:336",
         "launches": launches["ils_encode"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain},
        {"name": "scan_topk", "route": "cuda",
         "source": "local_search_quantization_torch/csrc/scan_topk.cu",
         "replaces": "local_search_quantization_tpu/ops/select_pallas.py:226",
         "launches": launches["scan_topk"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain},
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
