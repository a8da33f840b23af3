#!/usr/bin/env python
"""Build a serving index directory on the GPU: train a quantizer, encode the
base set, persist everything the serve twin needs.

Twin of `scripts/build_index.py` (same flags and index directory; `--device
cuda|cpu` replaces `--platform`). A directory it writes serves and evaluates
through either package's scripts.

    python -m local_search_quantization_torch.scripts.build_index --method lsq \
        --out ./index_lsq --ntrain 100000 --nbase 1000000 --niter 10 --ilsiter 16
"""

from __future__ import annotations

import argparse
import os
import sys
import time

# Run as a file from any directory: the repo root goes ahead of this folder.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import numpy as np  # noqa: E402

from local_search_quantization_torch.index import Index  # noqa: E402
from local_search_quantization_torch.utils.device import entry_device  # noqa: E402
from local_search_quantization_torch.utils.io import dataset_available, read_dataset  # noqa: E402
from local_search_quantization_torch.utils.synth import synthetic_dataset  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--method", required=True,
                    choices=["pq", "opq", "chainq", "lsq", "rvq"])
    ap.add_argument("--out", required=True, help="index directory to create")
    ap.add_argument("--dataset", default="SIFT1M")
    ap.add_argument("--ntrain", type=int, default=100_000)
    ap.add_argument("--nbase", type=int, default=1_000_000)
    ap.add_argument("--m", type=int, default=None,
                    help="codebooks; default 8 (pq/opq) or 7+norm byte "
                         "(chainq/lsq/rvq) = 64-bit codes")
    ap.add_argument("--h", type=int, default=256)
    ap.add_argument("--niter", type=int, default=10)
    ap.add_argument("--ilsiter", type=int, default=16,
                    help="ILS rounds for the lsq base encode")
    ap.add_argument("--sr", default="none", choices=["none", "SR-D", "SR-C"],
                    help="LSQ stochastic relaxation (LSQ++)")
    ap.add_argument("--sr-scale", type=float, default=1.0,
                    help="multiplier on the SR noise std")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--synth-d", type=int, default=128)
    ap.add_argument("--ivf-nlist", type=int, default=None,
                    help="also build an IVF coarse partition with this many "
                         "lists (serve with per-request nprobe)")
    ap.add_argument("--refine", default=None, choices=["sq8", "f32"],
                    help="also keep a (scalar-quantized) copy of the base "
                         "vectors for exact re-ranking (per-request refine)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; raises without a GPU, "
                         "so pass cpu to run on the CPU)")
    args = ap.parse_args(argv)
    device = entry_device(args.device)

    if args.dataset != "synthetic" and dataset_available(args.dataset):
        x_train = read_dataset(args.dataset, args.ntrain).astype(np.float32)
        x_base = read_dataset(args.dataset + "_base", args.nbase).astype(np.float32)
        dataset = args.dataset
    else:
        print(f"[build] {args.dataset} files not on disk; synthetic corpus")
        dd = synthetic_dataset(args.seed, d=args.synth_d, n_train=args.ntrain,
                               n_base=args.nbase, n_query=1)
        x_train, x_base = dd.train, dd.base
        dataset = "synthetic"

    t0 = time.time()
    idx = Index.build(
        x_train, x_base, args.method, m=args.m, h=args.h, niter=args.niter,
        ilsiter=args.ilsiter, seed=args.seed, verbose=True, refine=args.refine,
        sr=args.sr, sr_scale=args.sr_scale, meta={"dataset": dataset}, device=device)
    if args.ivf_nlist:
        idx.build_ivf(args.ivf_nlist, seed=args.seed)
    idx.meta["build_s"] = round(time.time() - t0, 1)
    idx.save(args.out)
    shown = {k: v for k, v in idx.meta.items() if k != "cbnorms"}
    print(f"[build] wrote {args.out} ({shown})")


if __name__ == "__main__":
    main()
