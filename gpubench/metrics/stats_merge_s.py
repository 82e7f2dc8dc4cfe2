"""The statistics pass's host merge a pass: Timers ``accumulation`` +
``statscompletion``."""
from gpubench.readers import timer_mean


def read(run):
    return timer_mean(run, "accumulation", "statscompletion")
