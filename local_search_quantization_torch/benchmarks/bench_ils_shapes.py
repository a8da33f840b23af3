#!/usr/bin/env python
"""K1's ILS rate across (m, h) shapes (twin of benchmarks/bench_ils_shapes.py).

The marginal method of bench.py (two round counts, least of the trials) at
each shape, in condition mode "kernel". Each argument is "m,h" or "m,h,d"
(d defaults to 128; d=960 is GIST1M's width, run on request). A shape K1
cannot hold (`ils_kernel_fits`) is reported as such and not timed; a shape
that fails is printed as FAILED, and the script then exits non-zero.

    python -m local_search_quantization_torch.benchmarks.bench_ils_shapes 7,256 8,256 7,512
"""

from __future__ import annotations

import argparse

from local_search_quantization_torch.benchmarks import bench
from local_search_quantization_torch.benchmarks._common import (
    baseline_vecs_per_sec,
    bench_device,
    card_line,
    device_arg,
)
from local_search_quantization_torch.ops.icm_kernels import ils_kernel_fits

K_LO, K_HI = 2, 18
TRIALS = 2
SHAPES = ((7, 256, 128), (8, 256, 128), (7, 512, 128))


def bench_config(m: int, h: int, *, n: int, d: int, device) -> float:
    """K1's marginal vec/s per ILS round at (m, h, d)."""
    return bench.run(n=n, d=d, m=m, h=h, k_lo=K_LO, k_hi=K_HI, trials=TRIALS,
                     device=device)["vecs_per_sec"]


def run(shapes=SHAPES, *, n: int = 1 << 17, device="cuda") -> dict:
    """{(m, h, d): vec/s, "does not fit K1", or "FAILED — ..."}."""
    out = {}
    for m, h, d in shapes:
        if not ils_kernel_fits(m, h):
            out[(m, h, d)] = "does not fit K1"
            continue
        try:
            out[(m, h, d)] = bench_config(m, h, n=n, d=d, device=device)
        except (RuntimeError, ValueError) as e:  # report, keep sweeping
            out[(m, h, d)] = f"FAILED — {type(e).__name__}: {e}"
    return out


def lines(results: dict) -> list[str]:
    out = []
    for (m, h, d), v in results.items():
        if isinstance(v, str):
            out.append(f"m={m} h={h} d={d}: {v}")
            continue
        base = baseline_vecs_per_sec(m)
        out.append(f"m={m} h={h} d={d}: {v:12,.0f} vec/s per ILS round ({v / base:.2f}x "
                   f"the {base / 1e3:.0f}k CUDA estimate at this width)")
    return out


def _shape(arg: str) -> tuple[int, int, int]:
    vals = [int(x) for x in arg.split(",")]
    if len(vals) not in (2, 3):
        raise argparse.ArgumentTypeError(f"a shape is m,h or m,h,d, got {arg!r}")
    return (vals[0], vals[1], vals[2] if len(vals) == 3 else 128)


def main(argv=None) -> dict:
    ap = device_arg(argparse.ArgumentParser(description=__doc__.splitlines()[0]))
    ap.add_argument("shapes", nargs="*", type=_shape,
                    help="m,h or m,h,d (default: 7,256 8,256 7,512)")
    ap.add_argument("--n", type=int, default=1 << 17)
    args = ap.parse_args(argv)
    dev = bench_device(args.device)
    print(card_line(dev), flush=True)
    results = run(tuple(args.shapes) or SHAPES, n=args.n, device=dev)
    print("\n".join(lines(results)), flush=True)
    if any(isinstance(v, str) and v.startswith("FAILED") for v in results.values()):
        raise SystemExit(1)
    return results


if __name__ == "__main__":
    main()
