#!/usr/bin/env python
"""SIFT1B-scale path benchmarks on the GPU (twin of `benchmarks/bench_scale.py`).

Three phases:

1. **encode64m** — sustained ILS encode of 64M rows (512 chunks x 131,072
   rows x 16 ILS rounds, icmiter=4, npert=4) through K1 (condition mode
   "kernel"), with every chunk generated on the card from a
   `torch.Generator`, as the reference generates its data with jax.random.
2. **query100m** — `adc.linscan_lsq` over 100M host codes: more than the
   segment bound (2^26 rows), so the codes stream to the card in two
   segments whose top-k lists merge (`_run_scan`); the time includes the
   upload of each segment.
3. **k10000** — 1M codes at k=10000, the reference linscan's default depth,
   through the "auto" route.

    python -m local_search_quantization_torch.benchmarks.bench_scale [encode64m] \
        [query100m] [k10000] [--device cpu]

Each phase runs at the reference's size; its function takes the sizes as
arguments. Times are the host clock ended by `torch.cuda.synchronize`.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

# Run as a file from any directory: the repo root goes ahead of this folder.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from local_search_quantization_torch.benchmarks._common import (  # noqa: E402
    bench_device,
    card_line,
    device_arg,
    sync,
)
from local_search_quantization_torch.ops import adc, icm  # noqa: E402

PHASES = ("encode64m", "query100m", "k10000")
M, H, D = 7, 256, 128
ICMITER, NPERT = 4, 4
IN_FLIGHT = 8


def _codebooks(seed: int, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor((np.random.default_rng(seed).normal(size=(M, H, D)) * 12.0)
                           .astype(np.float32), device=dev)


def encode64m(dev: torch.device, n_total: int = 64 * 1024 * 1024, chunk: int = 131072,
              ilsiter: int = 16) -> str:
    nchunks = n_total // chunk
    C = _codebooks(0, dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def encode_one():
        X = torch.randn((chunk, D), generator=gen, device=dev) * 40.0
        B0 = torch.randint(0, H, (chunk, M), generator=gen, device=dev, dtype=torch.int32)
        res = icm.ils_encode(gen, X, B0, C, ilsiter=ilsiter, icmiter=ICMITER,
                             npert=NPERT, condition_mode="kernel")
        return res.cost.sum(), res.B.sum()

    float(encode_one()[0])  # warm-up chunk (the kernel build at first use)
    sync(dev)
    t0 = time.perf_counter()
    acc = []
    for _ in range(nchunks):
        acc.append(encode_one())
        if len(acc) >= IN_FLIGHT:  # bound the chunks in flight
            float(acc.pop(0)[0])
    for c, _ in acc:
        float(c)
    dt = time.perf_counter() - t0
    vs = nchunks * chunk / dt
    return (f"[encode64m] {nchunks * chunk:,} rows x {ilsiter} ILS rounds in {dt:.1f}s = "
            f"{vs:,.0f} vec/s end-to-end ({vs * ilsiter:,.0f} vec/s per ILS round), "
            f"codes+cost device-resident")


def query100m(dev: torch.device, n_total: int = 100_000_000, nq: int = 2048,
              k: int = 1000, segment: int = 1 << 26) -> list[str]:
    rng = np.random.default_rng(1)
    C = _codebooks(1, dev)
    B = rng.integers(0, H, size=(n_total, M), dtype=np.int32)
    dbn = (rng.normal(size=n_total).astype(np.float32) ** 2) * 1e4
    Q = torch.as_tensor(rng.normal(size=(nq, D)).astype(np.float32) * 40.0, device=dev)
    nseg = -(-n_total // segment)
    out = []
    for run in ("cold", "steady"):
        sync(dev)
        t0 = time.perf_counter()
        res = adc.linscan_lsq(B, Q + (1.0 if run == "steady" else 0.0), C, dbn, k=k,
                              base_segment=segment)
        sync(dev)
        dt = time.perf_counter() - t0
        ids, dists = res.ids.cpu().numpy(), res.dists.cpu().numpy()
        if ids.shape != (nq, k) or ids.max() >= n_total or (np.diff(dists, axis=1) < 0).any():
            raise RuntimeError(f"query100m: malformed result {ids.shape}")
        out.append(f"[query100m:{run}] {nq} queries x k={k} over {n_total:,} codes "
                   f"({nseg} host-merged segments) in {dt:.1f}s = {nq / dt:,.1f} qps "
                   f"incl. {B.nbytes / 2**30:.1f} GB H2D code streaming")
    return out


def k10000(dev: torch.device, n: int = 1_000_000, nq: int = 1024, k: int = 10000) -> str:
    rng = np.random.default_rng(2)
    C = _codebooks(2, dev)
    B = rng.integers(0, H, size=(n, M), dtype=np.int32)
    dbn = (rng.normal(size=n).astype(np.float32) ** 2) * 1e4
    Q = torch.as_tensor(rng.normal(size=(nq, D)).astype(np.float32) * 40.0, device=dev)
    adc.linscan_lsq(B, Q + 1.0, C, dbn, k=k, query_chunk=256)  # warm-up
    sync(dev)
    t0 = time.perf_counter()
    res = adc.linscan_lsq(B, Q, C, dbn, k=k, query_chunk=256)
    sync(dev)
    dt = time.perf_counter() - t0
    if tuple(res.ids.shape) != (nq, k):
        raise RuntimeError(f"k10000: result shape {tuple(res.ids.shape)}")
    route = adc.cuda_route(k, n, M, H) if dev.type == "cuda" else "CPU"
    return (f"[k10000] {nq} queries x k={k} over {n:,} codes (auto route: {route}) "
            f"in {dt:.1f}s = {nq / dt:,.1f} qps")


def main(argv=None) -> list[str]:
    ap = device_arg(argparse.ArgumentParser(description=__doc__.splitlines()[0]))
    ap.add_argument("phases", nargs="*", help=f"any of {', '.join(PHASES)} (default: all)")
    args = ap.parse_args(argv)
    unknown = set(args.phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}; choose from {PHASES}")
    dev = bench_device(args.device)
    print(card_line(dev), flush=True)
    out = []
    for p in args.phases or PHASES:
        if p == "encode64m":
            got = [encode64m(dev)]
        elif p == "query100m":
            got = query100m(dev)
        else:
            got = [k10000(dev)]
        print("\n".join(got), flush=True)
        out += got
    return out


if __name__ == "__main__":
    main()
