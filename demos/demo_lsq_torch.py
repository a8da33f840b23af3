#!/usr/bin/env python
"""LSQ demo on the PyTorch port: OPQ -> ChainQ -> LSQ -> base encode -> norms
-> ADC query -> recall.

The PyTorch/CUDA counterpart of demos/demo_lsq.py, in the same order
(train_opq, train_chainq, train_lsq, encode_chunked, quantize_norms,
linscan_lsq, eval_recall). `--condition-mode` picks the ICM backend of both
the LSQ training encodes and the base encode: "auto" (the whole-ILS kernel,
K1, on the GPU; "gather" on the CPU) or "fused" (per-round ICM sweeps, K5),
or the "gather"/"matmul" tensor paths. Runs on the GPU (the CUDA kernels build at first use) and raises
without one, unless `--device cpu` asks for the CPU, where the kernels'
plain versions run. Uses SIFT1M from
./data/sift/ when present, else the synthetic SIFT-statistics corpus.

    python demos/demo_lsq_torch.py --ntrain 100000 --nbase 1000000 --nquery 1000
"""

from __future__ import annotations

import argparse
import time

import _bootstrap  # noqa: F401  (repo-root sys.path shim; see _bootstrap.py)

import numpy as np
import torch

from local_search_quantization_torch.index import entry_device
from local_search_quantization_torch.models import train_chainq, train_lsq, train_opq
from local_search_quantization_torch.ops import adc, icm, norms
from local_search_quantization_torch.utils.checkpoint import load_model, save_model
from local_search_quantization_torch.utils.config import ChainQConfig, LSQConfig, OPQConfig
from local_search_quantization_torch.utils.eval import eval_recall
from local_search_quantization_torch.utils.io import dataset_available, read_dataset
from local_search_quantization_torch.utils.synth import random_codes, synthetic_dataset


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", default="SIFT1M")
    ap.add_argument("--ntrain", type=int, default=10_000)
    ap.add_argument("--nbase", type=int, default=1_000_000)
    ap.add_argument("--nquery", type=int, default=10_000)
    ap.add_argument("--m", type=int, default=7)  # m codebooks + 1 norm byte
    ap.add_argument("--h", type=int, default=256)
    ap.add_argument("--niter", type=int, default=10)
    ap.add_argument("--ilsiter-base", type=int, default=16)  # LSQ-16
    ap.add_argument("--milestones", default=None,
                    help="comma-separated ILS round milestones for the base "
                         "encode, e.g. 16,32; overrides --ilsiter-base with "
                         "the last one")
    ap.add_argument("--knn", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--condition-mode", default="auto",
                    choices=["auto", "kernel", "fused", "gather", "matmul"],
                    help="ICM backend of the LSQ training encodes and the base "
                         "encode")
    ap.add_argument("--synth-d", type=int, default=128,
                    help="dimensionality of the synthetic fallback dataset")
    ap.add_argument("--save-model", default=None, help="save the trained LSQ model (.npz)")
    ap.add_argument("--load-model", default=None,
                    help="skip training; load an LSQ model (.npz) saved by "
                         "either package")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; raises without a GPU, "
                         "so pass cpu to run on the CPU)")
    return ap.parse_args(argv)


def set_fp32_precision() -> None:
    """Full float32 products, as the JAX package's precision='highest'."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def load_data(args):
    """(x_train, x_base, x_query, gt) as numpy arrays."""
    if args.dataset != "synthetic" and dataset_available(args.dataset):
        x_train = read_dataset(args.dataset, args.ntrain).astype(np.float32)
        x_base = read_dataset(args.dataset + "_base", args.nbase).astype(np.float32)
        x_query = read_dataset(args.dataset + "_query", args.nquery).astype(np.float32)
        gt = read_dataset(args.dataset + "_groundtruth", args.nquery)[:, 0]
        return x_train, x_base, x_query, gt
    print(f"[demo] dataset {args.dataset} not found on disk; using synthetic data")
    d = synthetic_dataset(0, d=args.synth_d, n_train=args.ntrain,
                          n_base=args.nbase, n_query=args.nquery)
    return d.train, d.base, d.query, d.gt


class Stopwatch:
    """Wall time of a stage that ends with the device idle."""

    def __init__(self, device: torch.device):
        self.device = device

    def __enter__(self):
        self._sync()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.seconds = time.perf_counter() - self.t0

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def train(args, cfg: LSQConfig, x_train: np.ndarray, device, init=None) -> tuple:
    """OPQ -> ChainQ -> LSQ, as demos/demo_lsq.py trains. `init`, the info of
    an earlier call, reuses its OPQ and ChainQ models. Returns (LSQ model,
    info), info holding the OPQ and ChainQ models and each stage's seconds."""
    X = torch.as_tensor(x_train, device=device)
    m, h = cfg.m, cfg.h
    if init is None:
        with Stopwatch(X.device) as sw:
            opq = train_opq(X, OPQConfig(m=m, h=h, niter=args.niter, seed=args.seed))
        print(f"Error after OPQ is {float(opq.obj[-1]):e}  ({sw.seconds:.1f}s)")
        opq_s = sw.seconds
        with Stopwatch(X.device) as sw:
            chain = train_chainq(X, opq.B, opq.R, ChainQConfig(m=m, h=h, niter=args.niter))
        print(f"Error after ChainQ is {float(chain.obj[-1]):e}  ({sw.seconds:.1f}s)")
        chainq_s = sw.seconds
    else:
        opq, chain = init["opq"], init["chain"]
        opq_s, chainq_s = init["opq_s"], init["chainq_s"]
    gen = torch.Generator(device=device).manual_seed(args.seed)
    with Stopwatch(X.device) as sw:
        lsq = train_lsq(X, chain.B, chain.R, cfg, generator=gen, verbose=True)
    print(f"Error after LSQ is {float(lsq.obj[-1]):e}  ({sw.seconds:.1f}s)")
    return lsq, {"opq": opq, "chain": chain, "opq_s": opq_s, "chainq_s": chainq_s,
                 "lsq_s": sw.seconds}


def run_pipeline_tail(args, lsq, cfg: LSQConfig, x_base, x_query, gt, device) -> dict:
    """Encode the base, quantize norms, query, recall. Returns the stage
    results: encode time and rate, and per milestone the codes, costs,
    quantized norms, norm and query times, results and recall curve."""
    m, h = lsq.C.shape[0], lsq.C.shape[1]
    if (m, h) != (args.m, args.h):
        print(f"[demo] model has m={m}, h={h}; overriding CLI --m/--h")
    milestones = (tuple(int(x) for x in args.milestones.split(","))
                  if args.milestones else (args.ilsiter_base,))
    device = torch.device(device)
    Xb = torch.as_tensor(x_base, device=device)
    Q = torch.as_tensor(x_query, device=device)
    B0 = random_codes(args.seed, Xb.shape[0], m, h)
    gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    out = {"milestones": {}}
    with Stopwatch(device) as sw:
        enc = icm.encode_chunked(gen, Xb, B0, lsq.C, ilsiter=milestones[-1],
                                 icmiter=cfg.icmiter, npert=cfg.npert,
                                 randord=cfg.randord, milestones=milestones,
                                 condition_mode=args.condition_mode)
    out["encode_s"] = sw.seconds
    out["encode_vec_per_s"] = Xb.shape[0] / sw.seconds
    print(f"Base encoding: {out['encode_vec_per_s']:.0f} vec/s  ({sw.seconds:.1f}s)")
    for s, rounds in enumerate(milestones):
        B_ms = enc.milestone_B[s]
        base_error = float(torch.mean(enc.milestone_cost[s]))
        print(f"=== LSQ-{rounds}: error in base is {base_error:e}")
        with Stopwatch(device) as sw_n:
            codes = norms.quantize_norms(B_ms, lsq.C, lsq.cbnorms)
            db_norms = lsq.cbnorms.to(device)[codes.long()]
        with Stopwatch(device) as sw_q:
            res = adc.linscan_lsq(B_ms, Q, lsq.C, db_norms, k=args.knn)
        print(f"Queried {Q.shape[0]} queries in {sw_q.seconds:.2f}s")
        recall = eval_recall(gt, res.ids.cpu().numpy(), args.knn)
        out["milestones"][rounds] = {
            "base_error": base_error, "B": B_ms, "cost": enc.milestone_cost[s],
            "norms_s": sw_n.seconds, "query_s": sw_q.seconds,
            "qps": Q.shape[0] / sw_q.seconds, "recall": recall,
            "db_norms": db_norms, "dists": res.dists, "ids": res.ids,
        }
    return out


def run(args) -> dict:
    """The whole demo; returns the tail's results plus the training time."""
    set_fp32_precision()
    device = entry_device(args.device)
    cfg = LSQConfig(m=args.m, h=args.h, niter=args.niter, seed=args.seed,
                    condition_mode=args.condition_mode)
    x_train, x_base, x_query, gt = load_data(args)
    if args.load_model:
        lsq = load_model(args.load_model, device)
        print(f"Loaded LSQ model from {args.load_model}")
        train_s = 0.0
    else:
        lsq, info = train(args, cfg, x_train, device)
        train_s = info["opq_s"] + info["chainq_s"] + info["lsq_s"]
        if args.save_model:
            save_model(args.save_model, lsq)
            print(f"Saved LSQ model to {args.save_model}")
    out = run_pipeline_tail(args, lsq, cfg, x_base, x_query, gt, device)
    out["train_s"] = train_s
    out["model"] = lsq
    return out


def main(argv=None):
    run(parse_args(argv))


if __name__ == "__main__":
    main()
