"""The host blocked on the device a call: the program's ``ops.sync``
spans (each ``to_host`` or ``masked`` wait of ops/sync), summed over the
window, over its calls."""
from gpubench.spans import seconds_per_unit


def read(run):
    return seconds_per_unit(run, "ops.sync")
