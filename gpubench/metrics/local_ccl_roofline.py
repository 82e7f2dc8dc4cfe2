"""K1's share of its roofline: the least time its bytes take at the
device's memory bandwidth (each tile's int32 cluster image read once and
its int32 labels written once, from the tile shape) over the device time
of the ``local_ccl_kernel`` launches in the trace."""
from gpubench import roofline

KERNEL = "local_ccl_kernel"


def read(run):
    if run.trace is None or "tile" not in run.shapes:
        return None
    hits = [v for k, v in run.trace["kernels"].items() if KERNEL in k]
    launches = sum(n for n, _ in hits)
    seconds = sum(s for _, s in hits)
    if not launches or seconds <= 0:
        return None
    nbytes = launches * roofline.local_ccl_bytes(*run.shapes["tile"])
    return roofline.roofline_pct(nbytes, seconds)
