"""What every bench twin shares: the device, the timer, the card line and
the reference encoder's throughput estimate.

Each twin runs on the GPU unless `--device cpu` (or `device="cpu"`) asks
for the CPU, and raises without a GPU otherwise. Times on the card are CUDA
events after a warm-up; on the CPU they are host wall clock, and every
twin's first line names the device they were taken on.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch

from local_search_quantization_torch.utils.device import entry_device


def device_arg(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    parser.add_argument("--device", default="cuda",
                        help="torch device (default: cuda; raises without a GPU, "
                             "so pass cpu to run on the CPU)")
    return parser


def bench_device(device) -> torch.device:
    """CUDA unless the caller asks for the CPU; raises when CUDA is asked for
    and there is none. Full float32 products, as the JAX package's
    precision='highest'."""
    device = entry_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return device


def card_line(device: torch.device) -> str:
    """The card's name and power limit as `nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader` prints them; for a CPU run, says so."""
    if device.type != "cuda":
        return "device: cpu (host wall clock; no card time)"
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"{torch.cuda.get_device_name(device)} (nvidia-smi not read: {e})"
    lines = smi.stdout.strip().splitlines()
    index = device.index or 0
    if smi.returncode != 0 or len(lines) <= index:
        return f"{torch.cuda.get_device_name(device)} (nvidia-smi not read)"
    return lines[index].strip()


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_ms(fn, device: torch.device, *, reps: int = 3, warmup: int = 1) -> float:
    """Mean milliseconds of fn() over `reps` runs after `warmup` runs: CUDA
    events on the card, host wall clock on the CPU."""
    for _ in range(warmup):
        fn()
    sync(device)
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def min_ms(fn, device: torch.device, *, trials: int) -> float:
    """The least of `trials` single runs of fn() after one warm-up run, ms."""
    return min(time_ms(fn, device, reps=1, warmup=1 if t == 0 else 0)
               for t in range(trials))


def sift_like(n: int, d: int, m: int, h: int, device: torch.device, seed: int = 0):
    """The JAX benchmarks' inputs (bench.py:62-66): X uint8-valued [n, d],
    C ~ N(0, 36^2) [m, h, d], B uniform codes [n, m] int32, from
    np.random.default_rng(seed) in that order."""
    rng = np.random.default_rng(seed)
    X = rng.integers(0, 256, size=(n, d)).astype(np.float32)
    C = (rng.normal(size=(m, h, d)) * 36.0).astype(np.float32)
    B = rng.integers(0, h, size=(n, m), dtype=np.int32)
    return (torch.as_tensor(X, device=device), torch.as_tensor(C, device=device),
            torch.as_tensor(B, device=device))


def baseline_vecs_per_sec(m: int = 7, icmiter: int = 4) -> float:
    """The reference CUDA encoder's estimated vec/s per ILS round at (m,
    icmiter): 333k at m=7, icmiter=4 (BASELINE.md, from its memory traffic on
    the Titan X it shipped for), scaled as 1 / (icmiter * m * (m - 1)), the
    conditioning passes a vector needs. The port's own copy of bench.py's."""
    return 333_000.0 * (4 * 7 * 6) / (icmiter * m * (m - 1))
