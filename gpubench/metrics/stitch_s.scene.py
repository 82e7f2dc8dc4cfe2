"""The host stitch's own seconds a scene: Timers ``stitchtiles`` less
``stitchwait`` (its waits for tiles), plus ``stitchfinalize``."""
from gpubench.readers import timer_mean


def read(run):
    return timer_mean(run, "stitchtiles", "stitchfinalize",
                      minus=("stitchwait",))
