"""Graph-loop passes of small-segment elimination a tile:
``SegmentationResult.elimPasses``, the mean over the window's calls."""
from gpubench.readers import mean


def read(run):
    return mean(r["counts"][3] for r in run.records if "counts" in r)
