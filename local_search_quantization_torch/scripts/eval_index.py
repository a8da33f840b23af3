#!/usr/bin/env python
"""Offline recall evaluation of a built index against exact ground truth, on
the GPU.

Twin of `scripts/eval_index.py` (same flags and recall JSON; `--device
cuda|cpu` replaces `--platform`). Queries and ground truth come from the
named dataset when its TEXMEX files are on disk, else from the synthetic
corpus regenerated from the index's meta (seed, ntrain, n), which reproduces
the base the index encoded.

    python -m local_search_quantization_torch.scripts.eval_index --index ./index_lsq --knn 1000
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

from local_search_quantization_torch.index import Index  # noqa: E402
from local_search_quantization_torch.utils.device import entry_device  # noqa: E402
from local_search_quantization_torch.utils.eval import eval_recall  # noqa: E402
from local_search_quantization_torch.utils.io import dataset_available, read_dataset  # noqa: E402
from local_search_quantization_torch.utils.synth import synthetic_dataset  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--index", required=True)
    ap.add_argument("--dataset", default=None,
                    help="dataset for queries/gt; default: the index's "
                         "meta.json dataset")
    ap.add_argument("--nquery", type=int, default=10_000)
    ap.add_argument("--knn", type=int, default=1000)
    ap.add_argument("--query-chunk", type=int, default=1024)
    ap.add_argument("--nprobe", type=int, default=0,
                    help="IVF probe count (needs build_index --ivf-nlist); 0 = exhaustive")
    ap.add_argument("--refine", type=int, default=0,
                    help="exact-rerank factor (needs build_index --refine)")
    ap.add_argument("--precision", default="f32", choices=("f32", "bf16"),
                    help="scan precision: bf16 rounds the LUTs once "
                         "(exhaustive scans only)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; raises without a GPU, "
                         "so pass cpu to run on the CPU)")
    ap.add_argument("--out", default=None, help="optional JSON output path")
    args = ap.parse_args(argv)

    idx = Index.load(args.index, device=entry_device(args.device))
    dataset = args.dataset or idx.meta.get("dataset", "synthetic")
    if dataset != "synthetic" and dataset_available(dataset):
        x_query = read_dataset(dataset + "_query", args.nquery).astype(np.float32)
        gt = read_dataset(dataset + "_groundtruth", args.nquery)[:, 0]
    else:
        print(f"[eval] {dataset} files not on disk; regenerating the "
              "synthetic corpus (seed/sizes from the index meta)")
        if "ntrain" not in idx.meta:
            raise SystemExit(
                "[eval] index meta lacks 'ntrain' (older build) — the "
                "synthetic corpus cannot be regenerated identically; "
                "rebuild the index or evaluate against dataset files")
        # The generator draws train, then base, then queries: the same seed,
        # ntrain and n reproduce the base the index encoded, and another
        # n_query only changes the query draw.
        dd = synthetic_dataset(idx.meta.get("seed", 0), d=idx.d,
                               n_train=idx.meta["ntrain"], n_base=idx.meta["n"],
                               n_query=args.nquery)
        x_query, gt = dd.query, dd.gt

    k = min(args.knn, idx.n)
    t0 = time.time()
    ids = []
    for s in range(0, x_query.shape[0], args.query_chunk):
        res = idx.search(x_query[s:s + args.query_chunk], k=k,
                         nprobe=args.nprobe or None, refine=args.refine or None,
                         precision=args.precision)
        ids.append(res.ids.cpu().numpy())
    ids = np.concatenate(ids)
    dt = time.time() - t0
    print(f"[eval] {x_query.shape[0]} queries x k={k} over {idx.n} codes "
          f"in {dt:.1f}s ({x_query.shape[0] / dt:.0f} qps)")
    curve = eval_recall(gt, ids, k)
    if args.out:
        table = {
            "index": args.index, "dataset": dataset, "k": k,
            "nprobe": args.nprobe or None,
            "refine": args.refine or None,
            "precision": args.precision,
            "nquery": int(x_query.shape[0]), "qps": x_query.shape[0] / dt,
            "recall": {f"r@{n}": float(curve[n - 1])
                       for n in (1, 2, 5, 10, 20, 50, 100, 200, 500, 1000)
                       if n <= k},
        }
        with open(args.out, "w") as f:
            json.dump(table, f, indent=2)
        print(f"[eval] wrote {args.out}")


if __name__ == "__main__":
    main()
