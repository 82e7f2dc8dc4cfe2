"""Worker-busy seconds of per-tile segmentation a scene: Timers
``segmentation``, summed over the CONC_THREADS workers (not wall)."""
from gpubench.readers import timer_mean


def read(run):
    return timer_mean(run, "segmentation")
