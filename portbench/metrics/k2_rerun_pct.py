"""K2's reruns: the queries whose certificate failed and that K2 searched
again on its dense path (`launch_counts.read()["scan_topk_failed"]`), as a
share of the queries the window searched. Wasted work; moves `search_qps`."""


def read(run):
    searches = run.work.get("searches")
    if not searches or run.counts is None:
        return None
    return 100.0 * run.counts["scan_topk_failed"] / sum(s[0] for s in searches)
