#!/usr/bin/env python
"""Sharded query qps over an 8-shard mesh (twin of
`benchmarks/bench_query_multichip.py`).

    python -m local_search_quantization_torch.benchmarks.bench_query_multichip \
        [k] [--device cpu]

Validates and times the sharded query path end to end: codes sharded on the
data axis, replicated LUTs, each shard's top-k, one merge on the first device
(`parallel/query.py`). The same data as the reference (`default_rng(0)`: C,
C_sub, B, Q, norms; n=200,000 codes, d=128, m=7, h=256, 256 queries,
block 1<<14): `sharded_linscan_lsq` and `sharded_linscan_pq`, a first and a
steady run. The mesh is 8 shards on `cuda:0` (or on the CPU with `--device
cpu`): the shards share one card and run one after another, so the qps says
nothing of multi-GPU scaling. Times are the host clock around the call,
ended by `torch.cuda.synchronize`.
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
from local_search_quantization_torch.parallel.mesh import data_mesh  # noqa: E402
from local_search_quantization_torch.parallel.query import (  # noqa: E402
    sharded_linscan_lsq,
    sharded_linscan_pq,
)

D, M, H = 128, 7, 256
SHARDS = 8
BLOCK = 1 << 14


def run(k: int = 100, *, n: int = 200_000, nq: int = 256, device="cuda") -> list[dict]:
    """[{"name", "qps", "first_s", "steady_s"}] of the lsq and pq mesh scans."""
    dev = bench_device(device)
    rng = np.random.default_rng(0)
    C = torch.as_tensor((rng.normal(size=(M, H, D)) * 36.0).astype(np.float32), device=dev)
    ds = -(-D // M)  # zero-padded subspace layout (ops/subspaces.py)
    C_sub = torch.as_tensor((rng.normal(size=(M, H, ds)) * 36.0).astype(np.float32),
                            device=dev)
    B = rng.integers(0, H, size=(n, M)).astype(np.int32)
    Q = torch.as_tensor(rng.integers(0, 256, size=(nq, D)).astype(np.float32), device=dev)
    dbn = (rng.normal(size=n) ** 2 * 1e5).astype(np.float32)
    mesh = data_mesh([dev] * SHARDS)
    print(f"[mesh] {SHARDS} shards on {dev} (one device: the shards run one after "
          "another)", file=sys.stderr)
    out = []
    for name, call in (
            ("lsq", lambda q: sharded_linscan_lsq(mesh, B, q, C, dbn, k=k, query_chunk=nq,
                                                  block=BLOCK)),
            ("pq", lambda q: sharded_linscan_pq(mesh, B, q, C_sub, k=k, query_chunk=nq,
                                                block=BLOCK))):
        sync(dev)
        t0 = time.perf_counter()
        call(Q)
        sync(dev)
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = call(Q + 1.0)
        sync(dev)
        steady = time.perf_counter() - t0
        if tuple(res.ids.shape) != (nq, min(k, n)) or not (
                int(res.ids.min()) >= 0 and int(res.ids.max()) < n):
            raise RuntimeError(f"sharded_{name}: malformed ids {tuple(res.ids.shape)}")
        out.append({"name": name, "qps": nq / steady, "first_s": first, "steady_s": steady,
                    "n": n, "k": k})
    return out


def lines(results: list[dict]) -> list[str]:
    return [f"sharded_{r['name']}: {r['qps']:,.0f} qps over {r['n']:,} codes x {SHARDS} "
            f"shards (k={r['k']})  [compile+first={r['first_s']:.1f}s "
            f"steady={r['steady_s']:.2f}s]" for r in results]


def main(argv=None) -> list[dict]:
    ap = device_arg(argparse.ArgumentParser(description=__doc__.splitlines()[0]))
    ap.add_argument("k", nargs="?", type=int, default=100)
    args = ap.parse_args(argv)
    dev = bench_device(args.device)
    print(card_line(dev), flush=True)
    res = run(args.k, device=dev)
    print("\n".join(lines(res)))
    return res


if __name__ == "__main__":
    main()
