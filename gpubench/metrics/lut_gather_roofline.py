"""K2's share of its roofline: the least time its bytes take at the
device's memory bandwidth (the program's ``lut_gather.bytes`` count over
the window: each launch's indices read, output written and table read
once) over the device time of the ``lut_direct`` and ``lut_staged``
launches in the trace."""
from gpubench import roofline
from gpubench.spans import count

KERNELS = ("lut_direct", "lut_staged")


def read(run):
    nbytes = count("lut_gather.bytes")
    if run.trace is None or not nbytes:
        return None
    seconds = sum(s for k, (_, s) in run.trace["kernels"].items()
                  if any(name in k for name in KERNELS))
    if seconds <= 0:
        return None
    return roofline.roofline_pct(nbytes, seconds)
