"""Hand-written kernel launches a served request makes: the server's own
counts (its `serve: kernel launches {...}` line at the end of its stream,
every request since its warm-up) summed over the kernels, over the requests
it answered. Moves `search_p95_ms`."""

# launch_counts.read()'s keys that count launches of one kernel each
# ("scan_topk" is k2_filter plus the dense path, "dissect" a breakdown).
KERNELS = ("ils_encode", "icm_sweeps_v2", "icm_sweeps_v1", "icm_sweeps_dissect",
           "scan_select", "scan_key", "k2_filter", "k2_select", "scan_topk_dense")


def read(run):
    served = run.work.get("served_requests")
    if not served or run.counts is None:
        return None
    return sum(run.counts[k] for k in KERNELS) / served
