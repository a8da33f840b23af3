#!/usr/bin/env python
"""Sparse LSQ demo on the PyTorch port: PQ init -> L1-constrained codebook
training (SLSQ1/SLSQ2).

The PyTorch/CUDA counterpart of demos/demo_lsq_sparse.py, with its flags
(`--device` in place of `--platform`) and `demo_pq_torch`'s `load_data`.
SLSQ1: S = d*h, tau = 0.7*||C_PQ||_1; SLSQ2: S = d*h + d^2, tau = 0.9*||C_PQ||_1
(demo_lsq_sparse.jl:32-41). The training encodes run ILS in condition mode
"auto" (K1 on the GPU). Like the reference demo it trains only, unless
`--nbase` is given: then it also encodes that many base vectors (LSQ-16:
16 ILS rounds, K1), quantizes their norms, runs `--nquery` queries for the
min(1000, nbase) nearest (K2) and prints the recall curve. Runs on the GPU and raises without one, unless `--device cpu`.

    python demos/demo_lsq_sparse_torch.py --dataset synthetic --ntrain 2000 --variant SLSQ2
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
from local_search_quantization_torch.models import train_lsq_sparse, train_pq  # noqa: E402
from local_search_quantization_torch.ops import adc, icm, norms  # noqa: E402
from local_search_quantization_torch.utils.config import PQConfig, SLSQConfig  # noqa: E402
from local_search_quantization_torch.utils.device import entry_device  # noqa: E402
from local_search_quantization_torch.utils.eval import eval_recall  # noqa: E402
from local_search_quantization_torch.utils.synth import random_codes  # noqa: E402

ILSITER_BASE = 16  # LSQ-16, the first of repro_paper's milestones


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", default="SIFT1M")
    ap.add_argument("--ntrain", type=int, default=10_000)
    ap.add_argument("--nbase", type=int, default=0,
                    help="base vectors to encode and query; 0 (the reference "
                         "demo's behaviour) trains only")
    ap.add_argument("--nquery", type=int, default=0)
    ap.add_argument("--m", type=int, default=8)
    ap.add_argument("--h", type=int, default=256)
    ap.add_argument("--niter", type=int, default=10)
    ap.add_argument("--variant", choices=["SLSQ1", "SLSQ2"], default="SLSQ1")
    ap.add_argument("--synth-d", type=int, default=64,
                    help="dimensionality of the synthetic fallback dataset")
    ap.add_argument("--device", default="cuda", help=DEVICE_HELP)
    return ap.parse_args(argv)


def main(argv=None):
    """The demo; returns (the model, the recall@N curve or None)."""
    args = parse_args(argv)
    set_fp32_precision()
    device = entry_device(args.device)
    pq_cfg = PQConfig(m=args.m, h=args.h)  # validate args before the data load
    query = args.nbase > 0
    if not query:
        args.nbase, args.nquery = 1000, 100  # the loader needs something
    x_train, x_base, x_query, gt = load_data(args)
    d = x_train.shape[1]
    X = torch.as_tensor(x_train, device=device)

    with Stopwatch(device) as sw:
        pq = train_pq(X, pq_cfg)
    print(f"PQ init error {float(pq.error):e}  ({sw.seconds:.1f}s)")

    if args.variant == "SLSQ1":
        S, tau_scale = d * args.h, 0.7
    else:
        S, tau_scale = d * args.h + d * d, 0.9
    cfg = SLSQConfig(m=args.m, h=args.h, niter=args.niter, S=S, tau_scale=tau_scale)
    with Stopwatch(device) as sw:
        model = train_lsq_sparse(X, pq.B, pq.C_sub, torch.eye(d), cfg, verbose=True)
    print(f"{args.variant}: final obj {model.obj[-1]:e}, l0={int(model.l0[-1])} "
          f"(S={S}), l1={model.l1[-1]:e}  ({sw.seconds:.1f}s)")
    if not query:
        return model, None

    B0 = random_codes(0, x_base.shape[0], args.m, args.h)
    gen = torch.Generator(device=device).manual_seed(1)
    with Stopwatch(device) as sw:
        enc = icm.encode_chunked(gen, x_base, B0, model.C, ilsiter=ILSITER_BASE,
                                 icmiter=cfg.icmiter, npert=cfg.npert, randord=cfg.randord)
    print(f"Base encoding: {x_base.shape[0] / sw.seconds:.0f} vec/s  ({sw.seconds:.1f}s); "
          f"error in base is {float(torch.mean(enc.cost)):e}")
    db_norms = model.cbnorms[norms.quantize_norms(enc.B, model.C, model.cbnorms).long()]
    knn = min(1000, x_base.shape[0])
    with Stopwatch(device) as sw:
        res = adc.linscan_lsq(enc.B, torch.as_tensor(x_query, device=device), model.C,
                              db_norms, k=knn)
    print(f"Queried {x_query.shape[0]} queries in {sw.seconds:.2f}s")
    return model, eval_recall(gt, res.ids.cpu().numpy(), knn)


if __name__ == "__main__":
    main()
