#!/usr/bin/env python
"""IVF-ADC serving bench at SIFT1M scale: qps and recall against nprobe
(twin of `benchmarks/bench_ivf.py`).

A host benchmark, as its reference: the native IVF scanner
(`utils/native.linscan_ivf`) against the exhaustive native scan, which is
both the qps baseline and the ADC recall ceiling. PQ training, encoding,
the reconstructions, the partition's k-means and the LUTs run on `--device`
(the GPU unless `--device cpu`); the scans run on the host and need the
native library (`make -C native`): without it this raises with
`utils/native`'s message. The corpus is an `.npz` with train, base, query
and gt arrays (e.g. `utils.synth.synthetic_dataset(0, d=128, n_train=1e5,
n_base=1e6, n_query=1e4)` saved with `np.savez`). Stages cache to --cache.

    python -m local_search_quantization_torch.benchmarks.bench_ivf [--nq 1000] [--nlist 1024]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

# Run as a file from any directory: the repo root goes ahead of this folder.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from local_search_quantization_torch import ivf  # noqa: E402
from local_search_quantization_torch.benchmarks._common import (  # noqa: E402
    bench_device,
    card_line,
    device_arg,
)
from local_search_quantization_torch.models.pq import quantize_pq, train_pq  # noqa: E402
from local_search_quantization_torch.ops import adc  # noqa: E402
from local_search_quantization_torch.ops.subspaces import reconstruct_pq  # noqa: E402
from local_search_quantization_torch.refine import RefineStore, rerank  # noqa: E402
from local_search_quantization_torch.utils import native  # noqa: E402
from local_search_quantization_torch.utils.config import PQConfig  # noqa: E402

BLOCK = 1 << 17
NPROBES = (1, 2, 4, 8, 16, 32, 64, 128)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def say(line: str) -> None:
    print(line, flush=True)


def run(args, dev: torch.device) -> dict:
    """The sweep's results table; prints a line a row."""
    if not native.has_ivf():
        raise RuntimeError(native.NOT_BUILT)
    os.makedirs(args.cache, exist_ok=True)

    with np.load(args.corpus) as z:
        xt, xb = z["train"], z["base"]
        xq, gt = z["query"][: args.nq], z["gt"][: args.nq]
    n, d = xb.shape
    m, h = 8, 256
    extra = None
    if args.method == "lsq":
        # 64-bit additive codes (m=7 + norm byte) from a stage cache of the
        # repro pipeline (lsq.npz model + lsq_codes.npz milestones).
        from local_search_quantization_torch.ops import costs, norms
        from local_search_quantization_torch.utils import checkpoint as ckpt

        if not args.stage_cache:
            raise SystemExit("--method lsq needs --stage-cache")
        lsq = ckpt.load_model(os.path.join(args.stage_cache, "lsq.npz"), dev)
        zc = ckpt.load_codes(os.path.join(args.stage_cache, "lsq_codes.npz"))
        B = np.asarray(zc["B"][-1])  # deepest ILS milestone
        m, h = B.shape[1], lsq.C.shape[1]
        bn = _host(norms.quantize_norms(B, lsq.C, lsq.cbnorms))
        extra = _host(lsq.cbnorms)[bn].astype(np.float32)

        def build_luts(q):
            return _host(adc.lsq_query_luts(torch.as_tensor(q, device=dev), lsq.C))

        def recon(blk):
            return costs.reconstruct(torch.as_tensor(blk, device=dev), lsq.C)
    else:
        codes_path = os.path.join(args.cache, "pq_codes.npz")
        if os.path.exists(codes_path):
            with np.load(codes_path) as cz:
                C_sub_np, B = cz["C_sub"], cz["B"]
            say(f"[ivf-bench] code cache hit: {codes_path}")
        else:
            t0 = time.perf_counter()
            model = train_pq(torch.as_tensor(xt, device=dev),
                             PQConfig(m=m, h=h, kmeans_maxiter=25, seed=0))
            t1 = time.perf_counter()
            B = np.empty((n, m), np.int32)
            for s0 in range(0, n, BLOCK):
                B[s0:s0 + BLOCK] = _host(quantize_pq(
                    torch.as_tensor(xb[s0:s0 + BLOCK], device=dev), model.C_sub))
            t2 = time.perf_counter()
            C_sub_np = _host(model.C_sub)
            np.savez(codes_path, C_sub=C_sub_np, B=B)
            say(f"[ivf-bench] PQ train {t1 - t0:.1f}s encode {t2 - t1:.1f}s")
        C_sub = torch.as_tensor(C_sub_np, device=dev)

        def build_luts(q):
            return _host(adc.pq_query_luts(torch.as_tensor(q, device=dev), C_sub))

        def recon(blk):
            return reconstruct_pq(torch.as_tensor(blk, device=dev), C_sub, d)

    part_path = os.path.join(args.cache, f"part_{args.method}_{args.nlist}.npz")
    if os.path.exists(part_path):
        with np.load(part_path) as pz:
            arrs = dict(pz)
        build_s = float(arrs.pop("build_s"))
        part = ivf.IVFPartition.from_arrays(arrs)
        say(f"[ivf-bench] partition cache hit: {part_path}")
    else:
        t0 = time.perf_counter()
        xhat = torch.empty((n, d), dtype=torch.float32, device=dev)
        for s0 in range(0, n, BLOCK):
            xhat[s0:s0 + BLOCK] = recon(B[s0:s0 + BLOCK])
        part = ivf.build_partition(B, xhat, extra, args.nlist, device=dev, seed=0,
                                   sample=args.sample, iters=args.kmeans_iters)
        build_s = time.perf_counter() - t0
        np.savez(part_path, build_s=np.float64(build_s), **part.to_arrays())
        say(f"[ivf-bench] partition built in {build_s:.1f}s")

    luts = build_luts(xq)
    codes_u8 = np.ascontiguousarray(B, np.uint8)
    k = args.k

    def recalls(ids):
        return {f"r@{nn}": round(float(np.mean([gt[q] in ids[q, :nn]
                                                for q in range(args.nq)])), 4)
                for nn in (1, 10, 100) if nn <= k}

    def timeit(fn):
        best = np.inf
        for _ in range(2):
            t0 = time.perf_counter()
            out = fn()
            best = min(best, time.perf_counter() - t0)
        return out, args.nq / best

    # Exhaustive native scan: the qps baseline and the ADC recall ceiling.
    (_, ei), ex_qps = timeit(lambda: native.linscan(luts, codes_u8, extra, k))
    results = {"method": args.method, "n": n, "nq": args.nq, "k": k, "m": m, "h": h,
               "nlist": args.nlist, "partition_build_s": round(build_s, 1),
               "exhaustive": {"qps": round(ex_qps, 1), **recalls(ei)}, "sweep": []}
    say(json.dumps({"exhaustive": results["exhaustive"]}))

    store = None
    if args.refine:
        store = RefineStore.build(xb, "sq8")
        kc = min(args.refine * k, n)
        (_, ri), rq = timeit(lambda: rerank(
            store, xq, native.linscan(luts, codes_u8, extra, kc)[1], k))
        results["exhaustive_refined"] = {"refine": args.refine, "qps": round(rq, 1),
                                         **recalls(_host(ri))}
        say(json.dumps({"exhaustive_refined": results["exhaustive_refined"]}))

    for nprobe in NPROBES:
        if nprobe > args.nlist:
            break

        def scan():
            # Probe selection is part of the serving cost; the LUTs are
            # built outside both timings.
            return ivf.search(part, luts, k, ivf.coarse_probes(xq, part, nprobe))

        res, qps = timeit(scan)
        kept = float(np.mean([len(set(ei[q]) & set(res.ids[q])) / k
                              for q in range(args.nq)]))
        row = {"nprobe": nprobe, "qps": round(qps, 1), "speedup": round(qps / ex_qps, 2),
               f"adc_top{k}_kept": round(kept, 4), **recalls(res.ids)}
        results["sweep"].append(row)
        say(json.dumps(row))
        if args.refine:
            def scan_refined():
                cand = ivf.search(part, luts, args.refine * k,
                                  ivf.coarse_probes(xq, part, nprobe))
                return rerank(store, xq, cand.ids, k)

            rres, rqps = timeit(scan_refined)
            rrow = {"nprobe": nprobe, "refine": args.refine, "qps": round(rqps, 1),
                    "speedup": round(rqps / ex_qps, 2), **recalls(_host(rres.ids))}
            results["sweep"].append(rrow)
            say(json.dumps(rrow))
    return results


def main(argv=None) -> dict:
    ap = device_arg(argparse.ArgumentParser(description=__doc__.splitlines()[0]))
    ap.add_argument("--corpus", default=".corpus_v5_paper.npz")
    ap.add_argument("--cache", default=os.path.join(tempfile.gettempdir(),
                                                    "ivf_bench_cache"))
    ap.add_argument("--nq", type=int, default=1000)
    ap.add_argument("--nlist", type=int, default=1024)
    ap.add_argument("--sample", type=int, default=1 << 17)
    ap.add_argument("--kmeans-iters", type=int, default=15)
    ap.add_argument("--k", type=int, default=100)
    ap.add_argument("--method", default="pq", choices=["pq", "lsq"],
                    help="lsq reads a repro stage cache (--stage-cache: lsq.npz "
                         "model + lsq_codes.npz milestones)")
    ap.add_argument("--stage-cache", default=None)
    ap.add_argument("--refine", type=int, default=0,
                    help="also sweep the exact re-rank with this candidate factor "
                         "(sq8 store over the base set)")
    ap.add_argument("--out", default=None, help="optional JSON output path")
    args = ap.parse_args(argv)
    dev = bench_device(args.device)
    print(card_line(dev), flush=True)
    results = run(args, dev)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"[ivf-bench] wrote {args.out}", flush=True)
    return results


if __name__ == "__main__":
    main()
