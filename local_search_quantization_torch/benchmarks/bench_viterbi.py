#!/usr/bin/env python
"""ChainQ's exact Viterbi encode rate (twin of benchmarks/bench_viterbi.py).

Marginal method: the least of the trials at 2^15 and at 2^17 rows. Per
vector the dynamic program does (m - 1) * 2h^2 min-plus operations over
[h, h] transitions; in the port it is plain PyTorch (ops/viterbi.py), the
largest stage of ChainQ.

    python -m local_search_quantization_torch.benchmarks.bench_viterbi [--block 1024]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from local_search_quantization_torch.benchmarks._common import (
    bench_device,
    card_line,
    device_arg,
    min_ms,
)
from local_search_quantization_torch.ops.viterbi import viterbi_encode

N_LO, N_HI = 1 << 15, 1 << 17
TRIALS = 3
D, M = 128, 7


def run(*, n_lo: int = N_LO, n_hi: int = N_HI, h: int = 256, block: int = 1024,
        device="cuda") -> dict:
    """{"vecs_per_sec", "minplus_ops_per_sec", ...} between n_lo and n_hi rows."""
    dev = bench_device(device)
    rng = np.random.default_rng(0)
    C = torch.as_tensor((rng.normal(size=(M, h, D)) * 36.0).astype(np.float32), device=dev)
    X = torch.as_tensor(rng.integers(0, 256, size=(n_hi, D)).astype(np.float32), device=dev)
    t_lo = min_ms(lambda: viterbi_encode(X[:n_lo], C, block=block), dev, trials=TRIALS)
    t_hi = min_ms(lambda: viterbi_encode(X[:n_hi], C, block=block), dev, trials=TRIALS)
    v = (n_hi - n_lo) / max((t_hi - t_lo) / 1e3, 1e-9)
    return {"vecs_per_sec": v, "minplus_ops_per_sec": v * (M - 1) * 2 * h * h,
            "t_lo_ms": t_lo, "t_hi_ms": t_hi, "m": M, "h": h, "block": block,
            "n_lo": n_lo, "n_hi": n_hi}


def lines(res: dict) -> list[str]:
    return [f"viterbi m={res['m']} h={res['h']} block={res['block']}: "
            f"{res['vecs_per_sec']:12,.0f} vec/s ({res['minplus_ops_per_sec'] / 1e12:.2f} "
            f"T minplus-ops/s; T{res['n_lo']}={res['t_lo_ms']:.3f} ms, "
            f"T{res['n_hi']}={res['t_hi_ms']:.3f} ms)"]


def main(argv=None) -> dict:
    ap = device_arg(argparse.ArgumentParser(description=__doc__.splitlines()[0]))
    ap.add_argument("--block", type=int, default=1024)
    ap.add_argument("--n-lo", type=int, default=N_LO)
    ap.add_argument("--n-hi", type=int, default=N_HI)
    ap.add_argument("--h", type=int, default=256)
    args = ap.parse_args(argv)
    dev = bench_device(args.device)
    print(card_line(dev), flush=True)
    res = run(n_lo=args.n_lo, n_hi=args.n_hi, h=args.h, block=args.block, device=dev)
    print("\n".join(lines(res)))
    return res


if __name__ == "__main__":
    main()
