"""The device's idle share of the batch window: 1 less the union of its
operations' intervals over the window, in percent (`trace.idle_pct`).
Moves `search_qps`."""

from portbench.trace import idle_pct


def read(run):
    return idle_pct(run)
