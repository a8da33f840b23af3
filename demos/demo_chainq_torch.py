#!/usr/bin/env python
"""ChainQ demo on the PyTorch port: OPQ init -> chain training -> exact
Viterbi base encoding -> norm quantization -> additive-ADC query -> recall@N.

The PyTorch/CUDA counterpart of demos/demo_chainq.py, with its flags
(`--device` in place of `--platform`) and `demo_pq_torch`'s `load_data`.
Chain codes are additive full-dimensional codes, so the additive scan (K2
on the GPU) serves them with rotated queries. Runs on the GPU and raises
without one, unless `--device cpu`.

    python demos/demo_chainq_torch.py --dataset synthetic --ntrain 2000 --nbase 20000 --nquery 200
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
from demo_pq_torch import DEVICE_HELP, load_data  # noqa: E402
from local_search_quantization_torch.models import train_chainq, train_opq  # noqa: E402
from local_search_quantization_torch.ops import adc, costs, norms, viterbi  # noqa: E402
from local_search_quantization_torch.utils.config import ChainQConfig, OPQConfig  # noqa: E402
from local_search_quantization_torch.utils.device import encode_in_chunks, entry_device  # noqa: E402
from local_search_quantization_torch.utils.eval import eval_recall  # noqa: E402


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", default="SIFT1M")
    ap.add_argument("--ntrain", type=int, default=10_000)
    ap.add_argument("--nbase", type=int, default=1_000_000)
    ap.add_argument("--nquery", type=int, default=10_000)
    ap.add_argument("--m", type=int, default=7)
    ap.add_argument("--h", type=int, default=256)
    ap.add_argument("--niter", type=int, default=10)
    ap.add_argument("--knn", type=int, default=1000)
    ap.add_argument("--synth-d", type=int, default=64)
    ap.add_argument("--device", default="cuda", help=DEVICE_HELP)
    return ap.parse_args(argv)


def main(argv=None) -> np.ndarray:
    """The demo; returns the recall@N curve, N = 1..--knn."""
    args = parse_args(argv)
    set_fp32_precision()
    device = entry_device(args.device)
    m, h = args.m, args.h
    opq_cfg = OPQConfig(m=m, h=h, niter=args.niter)  # validate before the load
    x_train, x_base, x_query, gt = load_data(args)
    X = torch.as_tensor(x_train, device=device)

    with Stopwatch(device) as sw:
        opq = train_opq(X, opq_cfg)
    print(f"Error after OPQ is {float(opq.obj[-1]):e}  ({sw.seconds:.1f}s)")

    with Stopwatch(device) as sw:
        chain = train_chainq(X, opq.B, opq.R, ChainQConfig(m=m, h=h, niter=args.niter))
    print(f"Error after ChainQ is {float(chain.obj[-1]):e}  ({sw.seconds:.1f}s)")

    # Viterbi-encode the base set in the rotated space (exact per vector).
    with Stopwatch(device) as sw:
        B_base = encode_in_chunks(lambda x: viterbi.viterbi_encode(x @ chain.R, chain.C),
                                x_base, device)
    print(f"Base Viterbi encoding: {x_base.shape[0] / sw.seconds:.0f} vec/s  "
          f"({sw.seconds:.1f}s)")
    RXb = torch.as_tensor(x_base, device=device) @ chain.R
    print(f"Error in base is {float(costs.qerror(RXb, B_base, chain.C)):e}")

    # Norm codebook + query (additive scan, queries rotated).
    cbnorms, _ = norms.train_norm_codebook(B_base[:100_000], chain.C, h)
    db_norms = cbnorms[norms.quantize_norms(B_base, chain.C, cbnorms).long()]
    with Stopwatch(device) as sw:
        res = adc.linscan_lsq(B_base, torch.as_tensor(x_query, device=device), chain.C,
                              db_norms, k=args.knn, R=chain.R)
    print(f"Queried {x_query.shape[0]} queries in {sw.seconds:.2f}s")
    return eval_recall(gt, res.ids.cpu().numpy(), args.knn)


if __name__ == "__main__":
    main()
