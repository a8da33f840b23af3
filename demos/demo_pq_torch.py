#!/usr/bin/env python
"""PQ demo on the PyTorch port: train -> encode base -> query -> recall@N.

The PyTorch/CUDA counterpart of demos/demo_pq.py, with the same flags
(`--device` in place of `--platform`) and the same `load_data`, which the
OPQ, ChainQ and sparse-LSQ twins share. Runs on the GPU and raises without
one, unless `--device cpu` asks for the CPU. Uses SIFT1M from ./data/sift/
when present, else the synthetic SIFT-statistics corpus.

    python demos/demo_pq_torch.py --dataset synthetic --ntrain 2000 --nbase 20000 --nquery 200
"""

from __future__ import annotations

import argparse
import os
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(_HERE), _HERE]  # the repo root, then demos/

import numpy as np  # noqa: E402
import torch  # noqa: E402

from demo_lsq_torch import Stopwatch, set_fp32_precision  # noqa: E402
from local_search_quantization_torch.models import quantize_pq, train_pq  # noqa: E402
from local_search_quantization_torch.ops import adc  # noqa: E402
from local_search_quantization_torch.ops.subspaces import qerror_pq  # noqa: E402
from local_search_quantization_torch.utils.config import PQConfig  # noqa: E402
from local_search_quantization_torch.utils.device import encode_in_chunks, entry_device  # noqa: E402
from local_search_quantization_torch.utils.eval import eval_recall  # noqa: E402
from local_search_quantization_torch.utils.io import dataset_available, read_dataset  # noqa: E402
from local_search_quantization_torch.utils.synth import synthetic_dataset  # noqa: E402

DEVICE_HELP = "torch device (default: cuda; raises without a GPU, so pass cpu to run on the CPU)"


def load_data(args):
    """(x_train, x_base, x_query, gt) as numpy arrays: the named dataset when
    its files are on disk, else the synthetic corpus (seed 0, d=--synth-d)."""
    if args.dataset != "synthetic" and dataset_available(args.dataset):
        x_train = read_dataset(args.dataset, args.ntrain).astype(np.float32)
        x_base = read_dataset(args.dataset + "_base", args.nbase).astype(np.float32)
        x_query = read_dataset(args.dataset + "_query", args.nquery).astype(np.float32)
        gt = read_dataset(args.dataset + "_groundtruth", args.nquery)[:, 0]
        return x_train, x_base, x_query, gt
    print(f"[demo] dataset {args.dataset} not found on disk; using synthetic data")
    d = synthetic_dataset(0, d=getattr(args, "synth_d", 64), n_train=args.ntrain,
                          n_base=min(args.nbase, 1_000_000),
                          n_query=min(args.nquery, 10_000))
    return d.train, d.base, d.query, d.gt


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", default="SIFT1M")
    ap.add_argument("--ntrain", type=int, default=10_000)
    ap.add_argument("--nbase", type=int, default=1_000_000)
    ap.add_argument("--nquery", type=int, default=10_000)
    ap.add_argument("--m", type=int, default=8)
    ap.add_argument("--h", type=int, default=256)
    ap.add_argument("--knn", type=int, default=1000)
    ap.add_argument("--synth-d", type=int, default=64,
                    help="dimensionality of the synthetic fallback dataset")
    ap.add_argument("--device", default="cuda", help=DEVICE_HELP)
    return ap.parse_args(argv)


def main(argv=None) -> np.ndarray:
    """The demo; returns the recall@N curve, N = 1..--knn."""
    args = parse_args(argv)
    set_fp32_precision()
    device = entry_device(args.device)
    cfg = PQConfig(m=args.m, h=args.h)  # validate args before the data load
    x_train, x_base, x_query, gt = load_data(args)

    with Stopwatch(device) as sw:
        model = train_pq(torch.as_tensor(x_train, device=device), cfg)
    print(f"Error in training is {float(model.error):e}  ({sw.seconds:.1f}s)")

    with Stopwatch(device) as sw:
        B_base = encode_in_chunks(lambda x: quantize_pq(x, model.C_sub), x_base, device)
        base_error = float(qerror_pq(torch.as_tensor(x_base, device=device), B_base,
                                     model.C_sub))
    print(f"Error in base is {base_error:e}  ({sw.seconds:.1f}s)")

    with Stopwatch(device) as sw:
        res = adc.linscan_pq(B_base, torch.as_tensor(x_query, device=device), model.C_sub,
                             k=args.knn)
    print(f"Queried {x_query.shape[0]} queries in {sw.seconds:.2f}s")
    return eval_recall(gt, res.ids.cpu().numpy(), args.knn)


if __name__ == "__main__":
    main()
