"""Runs through the statistics merge's lexsort (held plus new) over runs
the compaction delivered, over the window: the program's counts
``tilingstats.merge.sorted`` and ``tilingstats.merge.delivered``. 1 when
nothing is held across windows."""
from gpubench.spans import count


def read(run):
    sorted_runs = count("tilingstats.merge.sorted")
    delivered = count("tilingstats.merge.delivered")
    if sorted_runs is None or not delivered:
        return None
    return sorted_runs / delivered
