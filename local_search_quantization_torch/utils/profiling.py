"""Light tracing helpers (port of `utils/profiling.py`).

`span` times a phase on the host's wall clock and annotates it with
`torch.profiler.record_function`, so the phase shows by name in a trace
that is being captured; `report` and `reset` read and clear the totals;
`trace` captures a `torch.profiler` trace of CPU and CUDA activity.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch

_SPANS: dict[str, float] = defaultdict(float)
_COUNTS: dict[str, int] = defaultdict(int)


@contextlib.contextmanager
def span(name: str, verbose: bool = False):
    """Time a phase (host wall clock; device work is included only where the
    phase ends in a synchronize) under a `record_function` annotation."""
    t0 = time.perf_counter()
    with torch.profiler.record_function(name):
        yield
    dt = time.perf_counter() - t0
    _SPANS[name] += dt
    _COUNTS[name] += 1
    if verbose:
        print(f"[{name}] {dt:.3f}s")


def report() -> dict[str, tuple[float, int]]:
    """Accumulated {phase: (total_seconds, calls)}."""
    return {k: (_SPANS[k], _COUNTS[k]) for k in sorted(_SPANS)}


def reset() -> None:
    _SPANS.clear()
    _COUNTS.clear()


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a torch.profiler trace of the block into `logdir`: CPU
    activity, and CUDA activity where a CUDA device is present; written as
    a Chrome trace (`trace.json`) on exit. Yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
