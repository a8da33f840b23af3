"""The IVF route's share of its roofline: the least time of the window's
probed searches (`roofline_ivf.ivf_search_s`: the coarse scores, and each
live row of the lists the reference probes for the batch, counted in
set-up from the partition's list sizes), over the device time of every
operation in the window, all of which those searches launched. The count is
of the work, not of the kernels, so it reads the same work whatever
implements the route. Moves `search_qps`."""

from portbench import roofline_ivf


def read(run):
    searches = run.work.get("ivf_searches")
    if not searches or run.trace is None or not run.trace.ops:
        return None
    least = sum(roofline_ivf.ivf_search_s(*s) for s in searches)
    return 100.0 * least / run.trace.device_s()
