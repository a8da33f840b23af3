"""The device's idle time inside `Index.add`, in ms an add: the window's idle
intervals intersected with its `index.add` spans, over the adds that began in
the window (`spans.exposed_ms`). The host work the device waits on, per add;
moves `index_vps`."""

from portbench.spans import exposed_ms


def read(run):
    return exposed_ms(run, "index.add")
