#!/usr/bin/env python
"""ADC query throughput (qps) at SIFT1M scale on the GPU (twin of
`benchmarks/bench_query.py`).

    python -m local_search_quantization_torch.benchmarks.bench_query \
        [mode [k [base_block [topk_method [d]]]]] [--device cpu]

The same argv and data as the reference (`default_rng(0)`: C, B, Q, norms;
n=1M codes, m=7, h=256, 1024 queries, 256 a chunk): `adc.linscan_lsq` with
host codes (uploaded by each call), a warm-up over the first base block,
then a first and a steady run. mode and topk_method are those
`adc.linscan_lsq` takes (mode "matmul"/"gather"; topk_method "auto",
"kernel", "exact", "tournament", ...); any other raises. Times are the host
clock around the call, ended by `torch.cuda.synchronize`.
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
from local_search_quantization_torch.ops import adc  # noqa: E402

M, H = 7, 256
QUERY_CHUNK = 256


def run(mode: str = "matmul", k: int = 1000, base_block: int = 1 << 16,
        topk_method: str = "exact", d: int = 128, *, n: int = 1_000_000,
        nq: int = 1024, device="cuda") -> dict:
    """{"qps", "first_s", "steady_s", "warm_s", ...} of linscan_lsq over n codes."""
    dev = bench_device(device)
    rng = np.random.default_rng(0)
    C = torch.as_tensor((rng.normal(size=(M, H, d)) * 36.0).astype(np.float32), device=dev)
    B = rng.integers(0, H, size=(n, M)).astype(np.int32)
    Q = torch.as_tensor(rng.integers(0, 256, size=(nq, d)).astype(np.float32), device=dev)
    dbn = (rng.normal(size=n) ** 2 * 1e5).astype(np.float32)
    kw = dict(k=k, query_chunk=QUERY_CHUNK, mode=mode, base_block=base_block,
              topk_method=topk_method)

    def timed(fn):
        sync(dev)
        t0 = time.perf_counter()
        fn()
        sync(dev)
        return time.perf_counter() - t0

    warm = timed(lambda: adc.linscan_lsq(B[:base_block], Q[:QUERY_CHUNK], C,
                                         dbn[:base_block], **kw))
    first = timed(lambda: adc.linscan_lsq(B, Q, C, dbn, **kw))
    steady = timed(lambda: adc.linscan_lsq(B, Q + 1.0, C, dbn, **kw))
    return {"qps": nq / steady, "first_s": first, "steady_s": steady, "warm_s": warm,
            "n": n, "k": k, "mode": mode, "topk_method": topk_method}


def lines(res: dict) -> list[str]:
    return [f"mode={res['mode']}/{res['topk_method']}: {res['qps']:,.0f} qps over "
            f"{res['n']:,} codes (k={res['k']}) = {res['qps'] * res['n']:.3e} "
            f"code-dists/s  [first={res['first_s']:.1f}s steady={res['steady_s']:.1f}s]"]


def main(argv=None) -> dict:
    ap = device_arg(argparse.ArgumentParser(description=__doc__.splitlines()[0]))
    ap.add_argument("mode", nargs="?", default="matmul")
    ap.add_argument("k", nargs="?", type=int, default=1000)
    ap.add_argument("base_block", nargs="?", type=int, default=1 << 16)
    ap.add_argument("topk_method", nargs="?", default="exact")
    ap.add_argument("d", nargs="?", type=int, default=128,
                    help="dimension, e.g. 960 for GIST1M")
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--nq", type=int, default=1024)
    args = ap.parse_args(argv)
    dev = bench_device(args.device)
    print(card_line(dev), flush=True)
    res = run(args.mode, args.k, args.base_block, args.topk_method, args.d, n=args.n,
              nq=args.nq, device=dev)
    print(f"[warmup {res['warm_s']:.1f}s]", file=sys.stderr)
    print("\n".join(lines(res)))
    return res


if __name__ == "__main__":
    main()
