"""The device trace of a window: `torch.profiler` (CPU and CUDA activity),
exported as a Chrome trace and read back.

The window is the span of the `WINDOW` annotation. Device operations are
the trace's kernels, copies and fills; the device is busy where any of them
runs (the union of their intervals), idle elsewhere. An idle gap is labelled
by what the host was doing at its middle: the innermost host event (an
operator, an annotation or a runtime call) that covers it.
"""

from __future__ import annotations

import contextlib
import json
from collections import defaultdict

import numpy as np

WINDOW = "portbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
# The longest gaps that are labelled (each needs a pass over the host events).
LABELLED_GAPS = 500


@contextlib.contextmanager
def capture(path: str):
    """Profile the block, annotated as the window, and write its Chrome trace
    to `path`; the device is synchronised before the window closes."""
    import torch

    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA])
    prof.start()
    try:
        with torch.profiler.record_function(WINDOW):
            yield
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    finally:
        prof.stop()
    prof.export_chrome_trace(path)


class Trace:
    """A window's device operations and host events, times in microseconds."""

    def __init__(self, events: list[dict]):
        wins = [e for e in events if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
        if not wins:
            raise ValueError(f"no {WINDOW} annotation in the trace")
        self.t0 = float(wins[0]["ts"])
        self.t1 = self.t0 + float(wins[0]["dur"])
        self.ops = [(e["name"], float(e["ts"]), float(e["dur"])) for e in events
                    if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
                    and self.t0 <= float(e["ts"]) < self.t1]
        host = [e for e in events if e.get("ph") == "X" and e.get("cat") in HOST_CATS
                and e.get("name") != WINDOW]
        self.host_names = [e["name"] for e in host]
        self.host_start = np.array([float(e["ts"]) for e in host])
        self.host_end = self.host_start + np.array([float(e.get("dur", 0.0)) for e in host])

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path) as f:
            return cls(json.load(f)["traceEvents"])

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def _busy_intervals(self) -> list[tuple[float, float]]:
        merged: list[list[float]] = []
        for _, ts, dur in sorted(self.ops, key=lambda o: o[1]):
            end = min(ts + dur, self.t1)
            if merged and ts <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], end)
            else:
                merged.append([ts, end])
        return [(a, b) for a, b in merged]

    @property
    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device."""
        return sum(b - a for a, b in self._busy_intervals()) * 1e-6

    def device_s(self, match=None) -> float:
        """Summed device seconds of the operations whose name contains
        `match` (all of them for None)."""
        return sum(dur for name, _, dur in self.ops
                   if match is None or match in name) * 1e-6

    def gaps(self) -> list[tuple[float, float]]:
        """The window's idle intervals, longest first."""
        out, t = [], self.t0
        for a, b in self._busy_intervals():
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if self.t1 > t:
            out.append((t, self.t1))
        return sorted(out, key=lambda g: g[0] - g[1])

    def host_at(self, t: float) -> str:
        """The innermost host event running at time t."""
        cover = np.flatnonzero((self.host_start <= t) & (self.host_end >= t))
        if cover.size == 0:
            return "host: outside any traced call"
        inner = cover[np.argmin(self.host_end[cover] - self.host_start[cover])]
        return self.host_names[inner]

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took the most time, and the longest
        idle gaps summed by what the host was doing, in seconds."""
        by_op: dict[str, float] = defaultdict(float)
        for name, _, dur in self.ops:
            by_op[name] += dur * 1e-6
        by_host: dict[str, float] = defaultdict(float)
        for a, b in self.gaps()[:LABELLED_GAPS]:
            by_host[self.host_at((a + b) / 2)] += (b - a) * 1e-6
        return {"device_ops": sorted(by_op.items(), key=lambda kv: -kv[1])[:top],
                "idle_gaps": sorted(by_host.items(), key=lambda kv: -kv[1])[:top]}


def idle_pct(run) -> float | None:
    """The device's idle share of the window, in percent; None without a
    trace or where no operation ran on the device."""
    tr = run.trace
    if tr is None or not tr.ops:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
