#!/usr/bin/env python
"""OPQ demo on the PyTorch port: rotation + PQ train -> encode -> query ->
recall@N.

The PyTorch/CUDA counterpart of demos/demo_opq.py, with its flags
(`--device` in place of `--platform`) and `demo_pq_torch`'s `load_data`.
Runs on the GPU and raises without one, unless `--device cpu`.

    python demos/demo_opq_torch.py --dataset synthetic --ntrain 2000 --nbase 20000 --nquery 200
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
from local_search_quantization_torch.models import quantize_opq, train_opq  # noqa: E402
from local_search_quantization_torch.ops import adc  # noqa: E402
from local_search_quantization_torch.ops.subspaces import qerror_opq  # noqa: E402
from local_search_quantization_torch.utils.config import OPQConfig  # noqa: E402
from local_search_quantization_torch.utils.device import encode_in_chunks, entry_device  # noqa: E402
from local_search_quantization_torch.utils.eval import eval_recall  # noqa: E402


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", default="SIFT1M")
    ap.add_argument("--ntrain", type=int, default=10_000)
    ap.add_argument("--nbase", type=int, default=1_000_000)
    ap.add_argument("--nquery", type=int, default=10_000)
    ap.add_argument("--m", type=int, default=8)
    ap.add_argument("--h", type=int, default=256)
    ap.add_argument("--niter", type=int, default=10)
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
    cfg = OPQConfig(m=args.m, h=args.h, niter=args.niter, init="natural")
    x_train, x_base, x_query, gt = load_data(args)

    with Stopwatch(device) as sw:
        model = train_opq(torch.as_tensor(x_train, device=device), cfg)
    print(f"Error in training is {float(model.obj[-1]):e}  ({sw.seconds:.1f}s)")

    with Stopwatch(device) as sw:
        B_base = encode_in_chunks(lambda x: quantize_opq(x, model.R, model.C_sub), x_base,
                                device)
        base_error = float(qerror_opq(torch.as_tensor(x_base, device=device), B_base,
                                      model.C_sub, model.R))
    print(f"Error in base is {base_error:e}  ({sw.seconds:.1f}s)")

    with Stopwatch(device) as sw:
        res = adc.linscan_opq(B_base, torch.as_tensor(x_query, device=device),
                              model.C_sub, model.R, k=args.knn)
    print(f"Queried {x_query.shape[0]} queries in {sw.seconds:.2f}s")
    return eval_recall(gt, res.ids.cpu().numpy(), args.knn)


if __name__ == "__main__":
    main()
