#!/usr/bin/env python
"""Training-stage and base-encode wall time (twin of
benchmarks/bench_train_encode.py).

PQ and OPQ training on 100k x 128 uint8-valued vectors (m=8, h=256, 100
iterations), and the LSQ-16 encode of 1M vectors (m=7, h=256, icmiter=4,
npert=4) through `encode_chunked`, host arrays in and codes back. Each stage
runs twice; the second run is the steady state (the first also builds the
kernels and warms the allocator). Host wall clock, the device idle at both
ends.

    python -m local_search_quantization_torch.benchmarks.bench_train_encode [pq,opq,encode]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from local_search_quantization_torch.benchmarks._common import (
    bench_device,
    card_line,
    device_arg,
    sync,
)
from local_search_quantization_torch.models import train_opq, train_pq
from local_search_quantization_torch.ops.icm import encode_chunked
from local_search_quantization_torch.utils.config import OPQConfig, PQConfig

STAGES = ("pq", "opq", "encode")
D, M_PQ, M, ILSITER = 128, 8, 7, 16  # width, PQ/OPQ and LSQ codebooks, LSQ-16


def _twice(fn, dev) -> tuple[float, float, object]:
    times, out = [], None
    for seed in (0, 1):
        sync(dev)
        t0 = time.perf_counter()
        out = fn(seed)
        sync(dev)
        times.append(time.perf_counter() - t0)
    return times[0], times[1], out


def run(stages=STAGES, *, ntrain: int = 100_000, nbase: int = 1_000_000, h: int = 256,
        iters: int = 100, device="cuda") -> dict:
    """{stage: (first s, steady s, detail)}."""
    dev = bench_device(device)
    rng = np.random.default_rng(0)
    Xt = torch.as_tensor(rng.integers(0, 256, size=(ntrain, D)).astype(np.float32),
                         device=dev)
    out = {}
    if "pq" in stages:
        first, steady, pq = _twice(lambda s: train_pq(Xt, PQConfig(
            m=M_PQ, h=h, kmeans_maxiter=iters, seed=s)), dev)
        out["pq"] = (first, steady, float(pq.error))
    if "opq" in stages:
        first, steady, opq = _twice(lambda s: train_opq(Xt, OPQConfig(
            m=M_PQ, h=h, niter=iters, seed=s)), dev)
        out["opq"] = (first, steady, float(opq.obj[-1]))
    if "encode" in stages:
        X = rng.integers(0, 256, size=(nbase, D)).astype(np.float32)
        C = torch.as_tensor((rng.normal(size=(M, h, D)) * 36.0).astype(np.float32),
                            device=dev)
        B0 = rng.integers(0, h, size=(nbase, M), dtype=np.int32)

        def encode(seed):
            gen = torch.Generator(device=dev).manual_seed(seed)
            res = encode_chunked(gen, X, B0, C, ilsiter=ILSITER, icmiter=4, npert=4)
            return res.B.cpu(), float(res.cost.mean())

        first, steady, (_, mean_cost) = _twice(encode, dev)
        out["encode"] = (first, steady, mean_cost)
    return {"stages": out, "ntrain": ntrain, "nbase": nbase, "m_pq": M_PQ, "m": M,
            "iters": iters, "ilsiter": ILSITER}


def lines(res: dict) -> list[str]:
    out = []
    st = res["stages"]
    if "pq" in st:
        first, steady, err = st["pq"]
        out.append(f"PQ train {res['ntrain']:,} x m={res['m_pq']} x {res['iters']} iters: "
                   f"first {first:.3f} s, steady {steady:.3f} s (error {err:.6e})")
    if "opq" in st:
        first, steady, obj = st["opq"]
        out.append(f"OPQ train {res['ntrain']:,} x m={res['m_pq']} x {res['iters']} "
                   f"alternations: first {first:.3f} s, steady {steady:.3f} s "
                   f"(objective {obj:.6e})")
    if "encode" in st:
        first, steady, cost = st["encode"]
        out.append(f"LSQ-{res['ilsiter']} base encode of {res['nbase']:,} vectors: "
                   f"{steady:.3f} s wall ({res['nbase'] / steady:,.0f} vec/s end to end, "
                   f"host arrays in and codes back; first {first:.3f} s); mean cost "
                   f"{cost:.2f}")
    return out


def main(argv=None) -> dict:
    ap = device_arg(argparse.ArgumentParser(description=__doc__.splitlines()[0]))
    ap.add_argument("stages", nargs="?", default=",".join(STAGES),
                    help="comma-separated: any of pq,opq,encode (default: all)")
    ap.add_argument("--ntrain", type=int, default=100_000)
    ap.add_argument("--nbase", type=int, default=1_000_000)
    ap.add_argument("--h", type=int, default=256)
    ap.add_argument("--iters", type=int, default=100)
    args = ap.parse_args(argv)
    dev = bench_device(args.device)
    print(card_line(dev), flush=True)
    res = run(tuple(args.stages.split(",")), ntrain=args.ntrain, nbase=args.nbase,
              h=args.h, iters=args.iters, device=dev)
    print("\n".join(lines(res)))
    return res


if __name__ == "__main__":
    main()
