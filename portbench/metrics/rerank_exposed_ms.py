"""The device's idle time inside the re-rank, in ms a call: the window's
idle intervals intersected with its `index.search.refine.rerank` spans,
over the re-ranks that began in the window (`spans.exposed_ms`). The host
work the device waits on inside `refine.rerank`; a program without the span
gives None. Moves `search_qps`."""

from portbench.spans import exposed_ms


def read(run):
    return exposed_ms(run, "index.search.refine.rerank")
