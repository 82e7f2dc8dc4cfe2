"""
The host synchronisation points of the port's data-dependent loops.

The JAX package runs its fixpoint loops on the device (``lax.while_loop``);
here each loop decides on the host whether to go on, which waits for the
device. Every such wait goes through this module, so a run can count them:
``to_host.syncs`` is a plain integer that callers may reset and read.
"""

from .._kernels import count


def to_host(t):
    """A small tensor as Python values (waits for the device). Counted."""
    count(to_host, "syncs")
    return t.tolist()


to_host.syncs = 0


def masked(t, mask):
    """``t[mask]``: the result's size depends on the data, so this waits
    for the device too. Counted in ``to_host.syncs``."""
    count(to_host, "syncs")
    return t[mask]
