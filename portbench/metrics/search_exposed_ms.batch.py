"""The device's idle time inside `Index.search`, in ms a call: the window's
idle intervals intersected with its `index.search` spans, over the calls that
began in the window (`spans.exposed_ms`). The host path the device waits on,
per call; moves `search_qps`."""

from portbench.spans import exposed_ms


def read(run):
    return exposed_ms(run, "index.search")
