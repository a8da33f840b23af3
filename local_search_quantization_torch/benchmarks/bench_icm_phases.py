#!/usr/bin/env python
"""The ILS encode's phases, each in ms an iteration on the current device
(twin of benchmarks/bench_icm_phases.py).

Phases at n=2^17, d=128, m=7, h=256: the unaries (an X C^T product), the
per-vector cost (veccost), the perturbation, K5 (`fused_icm_sweeps`, 4
sweeps in one launch), and 4 sweeps of the "gather" and of the "matmul"
tensor paths. Each is timed alone with CUDA events after a warm-up.

    python -m local_search_quantization_torch.benchmarks.bench_icm_phases [--device cpu]
"""

from __future__ import annotations

import argparse

import torch

from local_search_quantization_torch.benchmarks._common import (
    bench_device,
    card_line,
    device_arg,
    sift_like,
    time_ms,
)
from local_search_quantization_torch.ops import icm
from local_search_quantization_torch.ops.costs import veccost
from local_search_quantization_torch.ops.icm_kernels import fused_icm_sweeps
from local_search_quantization_torch.ops.luts import get_binaries, get_unaries

# Timed calls of each phase after one warm-up: fewer for the sweeps, which
# take longer.
REPS, SWEEP_REPS = 8, 4
ICMITER = 4  # sweeps a timed call of K5 and of the tensor paths


def run(*, n: int = 1 << 17, d: int = 128, m: int = 7, h: int = 256,
        device="cuda") -> dict:
    """{phase: ms an iteration}."""
    dev = bench_device(device)
    X, C, B = sift_like(n, d, m, h, dev)
    unaries = get_unaries(X, C)
    binaries = get_binaries(C)
    b16 = binaries.to(torch.bfloat16)
    order = torch.arange(m, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    phases = {
        "unaries einsum": (lambda: get_unaries(X, C), REPS),
        "veccost": (lambda: veccost(X, B, C), REPS),
        "perturb": (lambda: icm.perturb_codes(gen, B, min(4, m), h), REPS),
        f"K5 fused kernel ({ICMITER} icm)": (
            lambda: fused_icm_sweeps(B, unaries, b16, order, icmiter=ICMITER), SWEEP_REPS),
        f"gather sweeps ({ICMITER})": (
            lambda: icm.icm_sweeps(B, unaries, binaries, order.tolist(), ICMITER,
                                   condition_mode="gather"), SWEEP_REPS),
        f"matmul sweeps ({ICMITER})": (
            lambda: icm.icm_sweeps(B, unaries, binaries, order.tolist(), ICMITER,
                                   condition_mode="matmul"), SWEEP_REPS),
    }
    return {name: time_ms(fn, dev, reps=r) for name, (fn, r) in phases.items()}


def lines(results: dict) -> list[str]:
    return [f"{name:24s}: {ms:9.3f} ms/iter" for name, ms in results.items()]


def main(argv=None) -> dict:
    ap = device_arg(argparse.ArgumentParser(description=__doc__.splitlines()[0]))
    ap.add_argument("--n", type=int, default=1 << 17)
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--m", type=int, default=7)
    ap.add_argument("--h", type=int, default=256)
    args = ap.parse_args(argv)
    dev = bench_device(args.device)
    print(card_line(dev), flush=True)
    results = run(n=args.n, d=args.d, m=args.m, h=args.h, device=dev)
    print("\n".join(lines(results)))
    return results


if __name__ == "__main__":
    main()
