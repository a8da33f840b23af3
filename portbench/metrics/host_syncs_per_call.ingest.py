"""Host syncs an `Index.add` makes: the port's `host_syncs` counter over its
`add_calls`, both over the window (`launch_counts.read()`). Each is a point
where the host waits on the card; moves `index_vps`."""

from portbench.spans import per_call


def read(run):
    return per_call(run, "host_syncs", "add_calls")
