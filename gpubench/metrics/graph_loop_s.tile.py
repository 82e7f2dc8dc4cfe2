"""The small-segment graph loop a call: the program's
``elim_small.graph_loop`` spans (ops/elim_small), summed over the window,
over its calls."""
from gpubench.spans import seconds_per_unit


def read(run):
    return seconds_per_unit(run, "elim_small.graph_loop")
