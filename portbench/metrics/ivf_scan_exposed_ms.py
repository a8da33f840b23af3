"""The device's idle time inside the probed scan, in ms a call: the window's
idle intervals intersected with its `index.search.ivf.scan` spans, over the
scans that began in the window (`spans.exposed_ms`). The host work the
device waits on inside `ivf.DeviceScan.search`; moves `search_qps`."""

from portbench.spans import exposed_ms


def read(run):
    return exposed_ms(run, "index.search.ivf.scan")
