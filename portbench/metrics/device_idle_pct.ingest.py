"""The device's idle share of the ingest window: 1 less the union of its
operations' intervals over the window, in percent (`trace.idle_pct`).
Moves `index_vps`."""

from portbench.trace import idle_pct


def read(run):
    return idle_pct(run)
