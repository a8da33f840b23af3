"""What the metric readers take from the port's own spans and counters.

The port annotates its entry points (`Index.add`, `Index.search`) with
`utils/profiling.span`, which enters `torch.profiler.record_function` while
a profiler captures: each span is then a host event of the window's trace,
on the clock of the device's operations. Its counters (`ops/launch_counts`)
are read over the window into `run.counts`. A program without these spans
or counters gives no events and no keys: each function then returns None.
"""

from __future__ import annotations


def _union(intervals) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _overlap(xs, ys) -> float:
    """The total length of the intersection of two lists of disjoint
    intervals, each sorted by start."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        lo, hi = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if hi > lo:
            total += hi - lo
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def exposed_ms(run, name: str) -> float | None:
    """The device's idle time inside the spans called `name`, in ms a span:
    the window's idle intervals intersected with the union of its `name`
    spans (clipped to the window; a nested span of the same name counts
    once), over the number of those spans that began in the window. None
    without a trace or without such a span."""
    tr = run.trace
    if tr is None:
        return None
    spans = [(float(a), float(b))
             for n, a, b in zip(tr.host_names, tr.host_start, tr.host_end)
             if n == name and b > tr.t0 and a < tr.t1]
    began = sum(a >= tr.t0 for a, _ in spans)
    if not began:
        return None
    clipped = _union((max(a, tr.t0), min(b, tr.t1)) for a, b in spans)
    return _overlap(sorted(tr.gaps()), clipped) * 1e-3 / began


def per_call(run, counter: str, calls: str) -> float | None:
    """`counter` over `calls`, both from the window's counts; None where
    the program has no such counters or made no call."""
    counts = run.counts
    if not counts or counter not in counts or not counts.get(calls):
        return None
    return counts[counter] / counts[calls]
