"""K1's share of its roofline: the least time of the window's ILS encodes
(`roofline.ils_encode_s`, every visit counted) over the device time of K1's
kernel (`ils_kernel`) in the trace. Moves `index_vps`."""

from portbench import roofline

KERNEL = "ils_kernel"


def read(run):
    encodes = run.work.get("encodes")
    if not encodes or run.trace is None:
        return None
    k1 = run.trace.device_s(KERNEL)
    if k1 <= 0:
        return None
    return 100.0 * sum(roofline.ils_encode_s(*e) for e in encodes) / k1
