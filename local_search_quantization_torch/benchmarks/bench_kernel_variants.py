#!/usr/bin/env python
"""K7: the cost of each part of K5's ICM visit, from kernel variants that
take parts out (twin of benchmarks/bench_kernel_variants.py).

Variants (the numbers they leave are not encodings; timing only):
  full      K5's visit (the production kernel's function)
  predwrite the state write under one predicate per codebook
  nowrite   no state write (isolates the write)
  noargmin  code 3 written in place of the argmin (isolates the argmin)
  mmonly    the table sums alone (the gathers and adds: a lower bound)

Each variant runs `rounds` launches in a row, each on the codes the last
left, on a j-stacked table built once outside the timing; K5 and K6 run
the same way through `fused_icm_sweeps` (which stacks K5's table on every
call). Prints ms a round and ns per (row x visit).

    python -m local_search_quantization_torch.benchmarks.bench_kernel_variants [variant ...]
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
from local_search_quantization_torch.ops.icm_kernels import (
    DISSECT_VARIANTS,
    binaries_to_j_stacked,
    fused_icm_sweeps,
    icm_sweeps_dissect,
)
from local_search_quantization_torch.ops.luts import get_binaries, get_unaries

REPS = 2  # timed chains of `rounds` launches each, after one warm-up


def run(*, n: int = 1 << 17, d: int = 128, m: int = 7, h: int = 256, icmiter: int = 4,
        rounds: int = 16, variants=DISSECT_VARIANTS, device="cuda") -> dict:
    """{name: (ms a round, ns per row-visit)} for each K7 variant, "K5" and
    "K6", on bench_kernel_variants.py's inputs (:32-47)."""
    dev = bench_device(device)
    X, C, B = sift_like(n, d, m, h, dev)
    unaries = get_unaries(X, C)
    b16 = get_binaries(C).to(torch.bfloat16)
    stacked = binaries_to_j_stacked(b16).contiguous()
    order = torch.arange(m, dtype=torch.int32, device=dev)
    row_visits = n * icmiter * m

    def chain(step):
        def go():
            codes = B
            for _ in range(rounds):
                codes = step(codes)
        return go

    runs = {v: chain(lambda c, v=v: icm_sweeps_dissect(
        c, unaries, stacked, order, icmiter=icmiter, variant=v)[0]) for v in variants}
    for name, k in (("K5", "v2"), ("K6", "v1")):
        runs[name] = chain(lambda c, k=k: fused_icm_sweeps(c, unaries, b16, order,
                                                           icmiter=icmiter, variant=k))
    out = {}
    for name, go in runs.items():
        per_round = time_ms(go, dev, reps=REPS) / rounds
        out[name] = (per_round, per_round * 1e6 / row_visits)
    return out


def lines(results: dict) -> list[str]:
    names = {"K5": "K5 (v2)", "K6": "K6 (v1)"}
    return [f"{names.get(name, name):9s}: {ms:9.3f} ms/round  ({ns:7.4f} ns per row-visit)"
            for name, (ms, ns) in results.items()]


def main(argv=None) -> dict:
    ap = device_arg(argparse.ArgumentParser(description=__doc__.splitlines()[0]))
    ap.add_argument("variants", nargs="*",
                    help=f"any of {', '.join(DISSECT_VARIANTS)} (default: all)")
    ap.add_argument("--n", type=int, default=1 << 17)
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--m", type=int, default=7)
    ap.add_argument("--h", type=int, default=256)
    ap.add_argument("--icmiter", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=16)
    args = ap.parse_args(argv)
    dev = bench_device(args.device)
    print(card_line(dev), flush=True)
    results = run(n=args.n, d=args.d, m=args.m, h=args.h, icmiter=args.icmiter,
                  rounds=args.rounds, variants=tuple(args.variants) or DISSECT_VARIANTS,
                  device=dev)
    print("\n".join(lines(results)))
    return results


if __name__ == "__main__":
    main()
