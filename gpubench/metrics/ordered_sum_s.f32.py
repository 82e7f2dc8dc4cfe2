"""K4's device seconds a scene: the device time of the
``ordered_sum_kernel`` launches in the trace (every tile's float segment
sums and every graph pass's float apply) over the window's scenes."""

KERNEL = "ordered_sum_kernel"


def read(run):
    if run.trace is None or not run.records:
        return None
    found = sum(s for k, (_, s) in run.trace["kernels"].items()
                if KERNEL in k)
    return found / len(run.records) if found > 0 else None
