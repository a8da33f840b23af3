"""K2's share of its roofline: the least time of the ADC scan and exact top-k
of every query the window searched (`roofline.scan_topk_s`), over the device
time of every operation in the window, all of which those searches launched
(the pre-scan, `k2_filter`, `k2_select`, the tables, the copies). The count is
of the work, not of the kernels, so it reads the same work whatever
implements it. Moves `search_qps`."""

from portbench import roofline


def read(run):
    searches = run.work.get("searches")
    if not searches or run.trace is None or not run.trace.ops:
        return None
    least = sum(roofline.scan_topk_s(*s) for s in searches)
    return 100.0 * least / run.trace.device_s()
