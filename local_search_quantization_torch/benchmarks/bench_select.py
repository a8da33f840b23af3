#!/usr/bin/env python
"""Device-resident qps of the scan+select kernels, cold against warm-started,
on the GPU (twin of `benchmarks/bench_select.py`).

"cold" is `select_kernels.fused_scan_topk` (no threshold), "warm" is
`scan_topk_warm` (a sampled bound t0 first; its certificate check and the
reruns of the queries that fail it are part of its time). Each is timed by
CUDA events over two runs on two query sets after a warm-up.

    python -m local_search_quantization_torch.benchmarks.bench_select [k] [nq] [--device cpu]

Switches, as the reference's: LSQ_TPU_SELECT_VARIANTS (comma list, default
"sorted"; "grouped" is K2, "sorted"/"unsorted" K3, "key" K4, which has no
cold path), LSQ_TPU_SELECT_PRECISION (f32/bf16), LSQ_TPU_SELECT_SHAPE
("m,h", e.g. 15,256), LSQ_TPU_SELECT_WARM_ONLY=1. The reference's tb and
nqt sweeps (extra argv, LSQ_TPU_SELECT_NQTS) are the TPU's block geometry,
which the port does not have: given, they are noted and ignored.
"""

from __future__ import annotations

import argparse
import os
import sys

# Run as a file from any directory: the repo root goes ahead of this folder.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from local_search_quantization_torch.benchmarks._common import (  # noqa: E402
    bench_device,
    card_line,
    device_arg,
    time_ms,
)
from local_search_quantization_torch.ops import adc  # noqa: E402
from local_search_quantization_torch.ops.select_kernels import (  # noqa: E402
    fused_scan_topk,
    scan_topk_warm,
)

D = 128


def run(k: int = 1000, nq: int = 1024, *, n: int = 1_000_000, m: int = 7, h: int = 256,
        variants=("sorted",), precision: str = "f32", warm_only: bool = False,
        device="cuda") -> list[dict]:
    """[{"variant", "cold_qps", "warm_qps"}] (cold 0 where not timed)."""
    dev = bench_device(device)
    rng = np.random.default_rng(0)
    C = torch.as_tensor((rng.normal(size=(m, h, D)) * 36.0).astype(np.float32), device=dev)
    B = rng.integers(0, h, size=(n, m)).astype(np.int32)
    Bt = torch.as_tensor(np.ascontiguousarray(B.T)).to(
        dev, torch.uint8 if h <= 256 else torch.int32)
    Q = torch.as_tensor(rng.integers(0, 256, size=(nq, D)).astype(np.float32), device=dev)
    dbn = torch.as_tensor((rng.normal(size=n) ** 2 * 1e5).astype(np.float32), device=dev)
    tables = [adc.lsq_query_luts(Q, C), adc.lsq_query_luts(Q + 1.0, C)]

    def qps(fn):
        turn = [0]

        def call():
            turn[0] += 1
            return fn(tables[turn[0] % 2])

        return nq / (time_ms(call, dev, reps=2) / 1e3)

    out = []
    for v in variants:
        # "key" has no cold path: it needs a warm threshold.
        cold = 0.0 if (warm_only or v == "key") else qps(
            lambda lt: fused_scan_topk(lt, Bt, dbn, k=k, variant=v, precision=precision))
        warm = qps(lambda lt: scan_topk_warm(lt, Bt, dbn, k=k, variant=v,
                                             precision=precision))
        out.append({"variant": v, "cold_qps": cold, "warm_qps": warm})
    return out


def main(argv=None) -> list[dict]:
    ap = device_arg(argparse.ArgumentParser(description=__doc__.splitlines()[0]))
    ap.add_argument("k", nargs="?", type=int, default=1000)
    ap.add_argument("nq", nargs="?", type=int, default=1024)
    ap.add_argument("tb", nargs="*", type=int, help="the TPU's block sweep: ignored")
    ap.add_argument("--n", type=int, default=1_000_000)
    args = ap.parse_args(argv)
    dev = bench_device(args.device)
    print(card_line(dev), flush=True)
    m, h = 7, 256
    shape = os.environ.get("LSQ_TPU_SELECT_SHAPE", "")
    if shape:
        m, h = (int(x) for x in shape.split(","))
    if args.tb or os.environ.get("LSQ_TPU_SELECT_NQTS"):
        print("note: the tb/nqt sweeps are the TPU's block geometry, which the port "
              "does not have; ignored")
    prec = os.environ.get("LSQ_TPU_SELECT_PRECISION", "f32")
    rows = run(args.k, args.nq, n=args.n, m=m, h=h,
               variants=os.environ.get("LSQ_TPU_SELECT_VARIANTS", "sorted").split(","),
               precision=prec,
               warm_only=os.environ.get("LSQ_TPU_SELECT_WARM_ONLY", "") == "1",
               device=dev)
    for r in rows:
        print(f"k={args.k} nq={args.nq} m={m} h={h} {r['variant']} {prec}: "
              f"cold {r['cold_qps']:8,.0f} qps | warm {r['warm_qps']:8,.0f} qps", flush=True)
    return rows


if __name__ == "__main__":
    main()
