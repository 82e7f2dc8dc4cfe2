"""Seconds a statistics pass in ``SegmentHistAccumulator.extractSegments``:
the program's ``tilingstats.extract`` spans, summed over the window, over
its passes."""
from gpubench.spans import seconds_per_unit


def read(run):
    return seconds_per_unit(run, "tilingstats.extract")
