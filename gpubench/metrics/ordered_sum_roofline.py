"""K4's share of its roofline: the least time its bytes take at the
device's memory bandwidth (the program's ``ordered_sum.bytes`` count over
the window: each launch's keys and summed elements read once and its bins
written once; the library sort that orders the keys is not counted) over
the device time of the ``ordered_sum_kernel`` launches in the trace."""
from gpubench import roofline
from gpubench.spans import count

KERNEL = "ordered_sum_kernel"


def read(run):
    nbytes = count("ordered_sum.bytes")
    if run.trace is None or not nbytes:
        return None
    seconds = sum(s for k, (_, s) in run.trace["kernels"].items()
                  if KERNEL in k)
    if seconds <= 0:
        return None
    return roofline.roofline_pct(nbytes, seconds)
