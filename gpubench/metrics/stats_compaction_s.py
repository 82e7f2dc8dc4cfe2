"""The run compaction (ops/segstats on the card) a pass: Timers
``compaction``."""
from gpubench.readers import timer_mean


def read(run):
    return timer_mean(run, "compaction")
