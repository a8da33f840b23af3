"""What every part of the benchmark shares: where its files are, the cell's
files found by name, seeds split into streams, the card's description, and
the percentile the latency metrics use.

Nothing here imports the port or torch at import time.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import subprocess

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    """BENCHMARK.json at the root of the checkout."""
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def workload(name: str) -> dict:
    """`workloads/<cell>.json`: the configuration's name, the driver, the
    traffic parameters and the limits of the comparison that decides
    `correct`."""
    return load_json(os.path.join(HERE, "workloads", name + ".json"))


def config(name: str) -> dict:
    """`configs/<config>.json`: the deployment's sizes."""
    return load_json(os.path.join(HERE, "configs", name + ".json"))


def stream_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for one named stream of draws (corpus, queries, traffic,
    sample...), from the run's `--seed`: streams never share draws, and the
    same seed gives the same inputs."""
    digest = hashlib.sha256(f"{int(seed)}:{stream}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def percentile(values, q: float) -> float:
    """The q-th percentile (0 < q <= 100) by nearest rank over every value;
    inf (a request that failed or never came) sorts last."""
    vals = sorted(values)
    if not vals:
        return math.inf
    rank = max(1, math.ceil(q / 100.0 * len(vals)))
    return vals[rank - 1]


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reads them, or why they
    could not be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"
    return out.stdout.strip().replace("\n", "; ") or out.stderr.strip()


def cache_env(root: str = ROOT) -> dict:
    """PyTorch's extension and Triton's kernel caches at fixed paths inside
    the checkout, for any part of the program that builds through them (the
    port builds its own kernels into `build/torch_kernels/` there), so that
    only a checkout's first run builds."""
    base = os.path.join(root, "build", "portbench_cache")
    return {"TORCH_EXTENSIONS_DIR": os.path.join(base, "torch_extensions"),
            "TRITON_CACHE_DIR": os.path.join(base, "triton")}
