#!/usr/bin/env python
"""Headline benchmark: the ILS/ICM encode rate on one GPU (twin of bench.py).

Prints the card line, a detail line, and last ONE JSON line:
{"metric", "value", "unit", "vs_baseline"}.

Metric: vectors a second through one full ILS round (perturbation + 4 ICM
sweeps over m=7 codebooks at h=256, d=128 + per-vector accept-if-better),
at the reference's SIFT1M base-encoding config (icmiter=4, npert=4, random
visit order), through K1 (condition mode "kernel"). The marginal rate
n * (K_HI - K_LO) / (T_HI - T_LO) between a K_LO-round and a K_HI-round
encode (each the least of TRIALS runs, CUDA events after a warm-up) takes
out the per-encode LUT builds and launch costs, as bench.py does.

vs_baseline: the ratio to the reference CUDA encoder's estimated rate on the
hardware it shipped for (Titan X; BASELINE.md, ~333k vec/s a round).

    python -m local_search_quantization_torch.benchmarks.bench [--device cpu]
"""

from __future__ import annotations

import argparse
import json

import torch

from local_search_quantization_torch.benchmarks._common import (
    baseline_vecs_per_sec,
    bench_device,
    card_line,
    device_arg,
    min_ms,
    sift_like,
)
from local_search_quantization_torch.ops.icm import ils_encode

K_LO, K_HI = 2, 34
TRIALS = 3
ICMITER, NPERT = 4, 4  # the reference's base-encoding config


def run(*, n: int = 1 << 17, d: int = 128, m: int = 7, h: int = 256, k_lo: int = K_LO,
        k_hi: int = K_HI, trials: int = TRIALS, mode: str = "kernel",
        device="cuda") -> dict:
    """The marginal ILS rate: {"vecs_per_sec", "t_lo_ms", "t_hi_ms", ...}."""
    dev = bench_device(device)
    X, C, B = sift_like(n, d, m, h, dev)
    seed = [0]

    def encode(rounds):
        seed[0] += 1
        gen = torch.Generator(device=dev).manual_seed(seed[0])
        return ils_encode(gen, X, B, C, ilsiter=rounds, icmiter=ICMITER,
                          npert=min(NPERT, m), randord=True, condition_mode=mode)

    t_lo = min_ms(lambda: encode(k_lo), dev, trials=trials)
    t_hi = min_ms(lambda: encode(k_hi), dev, trials=trials)
    vps = n * (k_hi - k_lo) / max((t_hi - t_lo) / 1e3, 1e-9)
    return {"vecs_per_sec": vps, "t_lo_ms": t_lo, "t_hi_ms": t_hi, "n": n, "d": d,
            "m": m, "h": h, "icmiter": ICMITER, "mode": mode, "k_lo": k_lo,
            "k_hi": k_hi, "device": dev.type}


def lines(res: dict) -> list[str]:
    detail = (f"[bench] {res['n']} vecs, marginal over {res['k_hi'] - res['k_lo']} ILS "
              f"rounds (icm={res['icmiter']}, m={res['m']}, h={res['h']}, d={res['d']}, "
              f"mode={res['mode']}): T{res['k_lo']}={res['t_lo_ms']:.3f} ms "
              f"T{res['k_hi']}={res['t_hi_ms']:.3f} ms on {res['device']}")
    per = "GPU" if res["device"] == "cuda" else res["device"]
    headline = {
        "metric": "ils_encode_throughput",
        "value": round(res["vecs_per_sec"], 1),
        "unit": (f"vectors/sec/{per} (1 ILS round: {res['icmiter']} ICM sweeps, "
                 f"m={res['m']}, h={res['h']}, d={res['d']})"),
        "vs_baseline": round(res["vecs_per_sec"]
                             / baseline_vecs_per_sec(res["m"], res["icmiter"]), 3),
    }
    return [detail, json.dumps(headline)]


def main(argv=None) -> dict:
    ap = device_arg(argparse.ArgumentParser(description=__doc__.splitlines()[0]))
    ap.add_argument("--n", type=int, default=1 << 17)
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--m", type=int, default=7)
    ap.add_argument("--h", type=int, default=256)
    ap.add_argument("--k-lo", type=int, default=K_LO)
    ap.add_argument("--k-hi", type=int, default=K_HI)
    ap.add_argument("--trials", type=int, default=TRIALS)
    ap.add_argument("--mode", default="kernel",
                    choices=["kernel", "fused", "gather", "matmul"])
    args = ap.parse_args(argv)
    dev = bench_device(args.device)
    print(card_line(dev), flush=True)
    res = run(n=args.n, d=args.d, m=args.m, h=args.h, k_lo=args.k_lo, k_hi=args.k_hi,
              trials=args.trials, mode=args.mode, device=dev)
    print("\n".join(lines(res)))
    return res


if __name__ == "__main__":
    main()
