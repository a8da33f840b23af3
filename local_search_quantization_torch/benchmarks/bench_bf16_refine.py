#!/usr/bin/env python
"""The serving pairing bf16 scan + exact f32 refine on the GPU: qps and
true-NN recall at 1M (twin of `benchmarks/bench_bf16_refine.py`).

The grid {f32, bf16} x {refine off, refine 4} x k in {10, 100}, one table.
Two phases, either on the card or (with `--device cpu`) on the CPU:

  --prep:    generate the corpus (synthetic, d=128, exact ground truth),
             build the index (PQ m=8 or LSQ m=7 + norm byte, h=256) with
             an sq8 refine store, and save both under --cache;
  (measure): load the prepared index and corpus and run the grid.

qps: one `Index.search` call takes the whole query set and its results are
fetched to the host; the best of --trials timed calls after a warm call,
each with the query rows rolled. True-NN recall: the share of queries whose
exact nearest base row (the corpus ground truth) is in the top N returned.

    python -m local_search_quantization_torch.benchmarks.bench_bf16_refine --prep
    python -m local_search_quantization_torch.benchmarks.bench_bf16_refine [--out table.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

# Run as a file from any directory: the repo root goes ahead of this folder.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import numpy as np  # noqa: E402

from local_search_quantization_torch.benchmarks._common import (  # noqa: E402
    bench_device,
    card_line,
    device_arg,
    sync,
)
from local_search_quantization_torch.index import Index  # noqa: E402
from local_search_quantization_torch.utils.synth import synthetic_dataset  # noqa: E402


def corpus(cache: str, n: int, ntrain: int, nq: int):
    """(train, base, query, gt) of the synthetic corpus, cached under `cache`."""
    path = os.path.join(cache, f"corpus_{n}_{ntrain}_{nq}.npz")
    if os.path.exists(path):
        with np.load(path) as z:
            return z["train"], z["base"], z["query"], z["gt"]
    dd = synthetic_dataset(0, d=128, n_train=ntrain, n_base=n, n_query=nq)
    os.makedirs(cache, exist_ok=True)
    np.savez(path, train=dd.train, base=dd.base, query=dd.query, gt=dd.gt)
    return dd.train, dd.base, dd.query, dd.gt


def index_dir(cache: str, method: str, n: int) -> str:
    return os.path.join(cache, f"idx_{method}_{n}")


def prep(cache: str, *, n: int, ntrain: int, nq: int, method: str,
         device="cuda") -> str:
    dev = bench_device(device)
    train, base, _, _ = corpus(cache, n, ntrain, nq)
    t0 = time.time()
    idx = Index.build(train, base, method, h=256, niter=10, seed=0, refine="sq8",
                      device=dev)
    idx.save(index_dir(cache, method, n))
    return (f"[prep] built + saved {index_dir(cache, method, n)} in "
            f"{time.time() - t0:.0f}s (n={idx.n}, refine={idx.refine.kind})")


def measure(cache: str, *, n: int, ntrain: int, nq: int, method: str, trials: int = 3,
            device="cuda") -> list[dict]:
    dev = bench_device(device)
    idx = Index.load(index_dir(cache, method, n), device=dev)
    if idx.refine is None:
        raise RuntimeError("run --prep first (refine store missing)")
    _, _, query, gt = corpus(cache, n, ntrain, nq)
    Q = query.astype(np.float32)
    rows = []
    for precision in ("f32", "bf16"):
        for refine in (0, 4):
            for k in (10, 100):
                kw = dict(k=k, precision=precision, refine=refine or None)
                ids = idx.search(Q, **kw).ids.cpu().numpy()  # warm; recall from it
                best = float("inf")
                for t in range(trials):
                    Qv = np.roll(Q, t + 1, axis=0)
                    sync(dev)
                    t0 = time.perf_counter()
                    res = idx.search(Qv, **kw)
                    res.ids.cpu(), res.dists.cpu()
                    best = min(best, time.perf_counter() - t0)
                hit = ids == gt[:, None]
                rows.append({"precision": precision, "refine": refine, "k": k,
                             "qps": round(nq / best, 1),
                             "true_r@1": round(float(hit[:, :1].any(axis=1).mean()), 4),
                             "true_r@10": round(float(hit[:, :min(10, k)].any(axis=1)
                                                      .mean()), 4)})
    return rows


def main(argv=None):
    ap = device_arg(argparse.ArgumentParser(description=__doc__.splitlines()[0]))
    ap.add_argument("--cache", default=".cache/bf16_refine")
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--ntrain", type=int, default=100_000)
    ap.add_argument("--nq", type=int, default=8192)
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--method", default="pq", choices=("pq", "lsq"),
                    help="index family: pq (m=8) or lsq (m=7 + norm byte), "
                         "the same 64-bit budget")
    ap.add_argument("--prep", action="store_true",
                    help="build the corpus, the index and its refine store")
    ap.add_argument("--out", default=None, help="optional JSON output path")
    args = ap.parse_args(argv)
    dev = bench_device(args.device)
    print(card_line(dev), flush=True)
    sizes = dict(n=args.n, ntrain=args.ntrain, nq=args.nq, method=args.method, device=dev)
    if args.prep:
        line = prep(args.cache, **sizes)
        print(line)
        return line
    print(f"[bench] n={args.n} nq={args.nq} device={dev.type}; grid = precision x "
          f"refine x k", file=sys.stderr)
    rows = measure(args.cache, trials=args.trials, **sizes)
    for row in rows:
        print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"n": args.n, "nq": args.nq, "method": f"{args.method}-h256",
                       "device": card_line(dev), "trials": args.trials, "rows": rows,
                       "note": "end-to-end Index.search incl. host fetch; true-NN "
                               "recall vs exact corpus gt"}, f, indent=1)
        print(f"[bench] wrote {args.out}")
    return rows


if __name__ == "__main__":
    main()
