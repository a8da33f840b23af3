"""Host syncs a probed `Index.search` makes: the port's `host_syncs` counter
over its `search_calls`, both over the window (`launch_counts.read()`). Each
is a point where the host waits on the card; moves `search_qps`."""

from portbench.spans import per_call


def read(run):
    return per_call(run, "host_syncs", "search_calls")
