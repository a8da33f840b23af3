"""Light tracing helpers (port of `utils/profiling.py`).

`span` times a phase on the host's wall clock and, while a profiler
captures, annotates it with `torch.profiler.record_function`, so the phase
shows by name in the trace, on the clock of the device's operations; with no
profiler running it only keeps the host totals (entering `record_function`
costs microseconds, reading whether a profiler runs a tenth of one).
`report` and `reset` read and clear the totals; `trace` captures a
`torch.profiler` trace of CPU and CUDA activity.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch

_profiler_enabled = torch._C._autograd._profiler_enabled
_SPANS: dict[str, float] = defaultdict(float)
_COUNTS: dict[str, int] = defaultdict(int)


class span:
    """Time a phase (host wall clock; device work is included only where the
    phase ends in a synchronize), under a `record_function` annotation while
    a profiler captures. A class, not a generator: entering and leaving it
    costs about half as much."""

    __slots__ = ("name", "verbose", "annotation", "t0")

    def __init__(self, name: str, verbose: bool = False):
        self.name, self.verbose = name, verbose

    def __enter__(self):
        self.annotation = None
        if _profiler_enabled():
            self.annotation = torch.profiler.record_function(self.name)
            self.annotation.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        if exc[0] is None:
            _SPANS[self.name] += dt
            _COUNTS[self.name] += 1
            if self.verbose:
                print(f"[{self.name}] {dt:.3f}s")
        return False


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
