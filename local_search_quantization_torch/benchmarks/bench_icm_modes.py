#!/usr/bin/env python
"""The ILS encode rate per ICM condition mode (twin of
benchmarks/bench_icm_modes.py).

One ILS round (4 ICM sweeps, npert=4) at n=2^17, d=128, m=7, h=256, run
`rounds` times in a row, each on the codes the last left; vec/s and ms a
round for "gather", "matmul", "fused" (K5 each round) and "kernel" (K1).

    python -m local_search_quantization_torch.benchmarks.bench_icm_modes [mode ...]
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
from local_search_quantization_torch.ops.icm import ils_encode

MODES = ("gather", "matmul", "fused", "kernel")
ROUNDS = 5  # ILS rounds chained in one timed call


def run(*, n: int = 1 << 17, d: int = 128, m: int = 7, h: int = 256, modes=MODES,
        device="cuda") -> dict:
    """{mode: (vec/s, ms a round)}."""
    dev = bench_device(device)
    X, C, B = sift_like(n, d, m, h, dev)
    out = {}
    for mode in modes:
        gen = torch.Generator(device=dev).manual_seed(0)

        def chained(mode=mode, gen=gen):
            b = B
            for _ in range(ROUNDS):
                b = ils_encode(gen, X, b, C, ilsiter=1, icmiter=4, npert=min(4, m),
                               condition_mode=mode).B

        ms = time_ms(chained, dev, reps=1) / ROUNDS
        out[mode] = (n / ms * 1e3, ms)
    return out


def lines(results: dict) -> list[str]:
    return [f"{mode:8s}: {vps:12.0f} vec/s  ({ms:.3f} ms/round)"
            for mode, (vps, ms) in results.items()]


def main(argv=None) -> dict:
    ap = device_arg(argparse.ArgumentParser(description=__doc__.splitlines()[0]))
    ap.add_argument("modes", nargs="*", help=f"any of {', '.join(MODES)} (default: all)")
    ap.add_argument("--n", type=int, default=1 << 17)
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--m", type=int, default=7)
    ap.add_argument("--h", type=int, default=256)
    args = ap.parse_args(argv)
    dev = bench_device(args.device)
    print(card_line(dev), flush=True)
    results = run(n=args.n, d=args.d, m=args.m, h=args.h,
                  modes=tuple(args.modes) or MODES, device=dev)
    print("\n".join(lines(results)))
    return results


if __name__ == "__main__":
    main()
