"""The refine route's share of its roofline: the least time of the window's
refined probed searches (`roofline_refine.refine_search_s`: the first
stage's coarse scores and each live row of the lists the reference probes
for the batch, counted in set-up, at k = refine * k; then the re-rank's
gathered SQ8 rows, candidate ids and answers), over the device time of every
operation in the window, all of which those searches launched. The count is
of the work, not of the kernels, so it reads the same work whatever
implements the route. Moves `search_qps`."""

from portbench import roofline_refine


def read(run):
    searches = run.work.get("refine_searches")
    if not searches or run.trace is None or not run.trace.ops:
        return None
    least = sum(roofline_refine.refine_search_s(*s) for s in searches)
    return 100.0 * least / run.trace.device_s()
