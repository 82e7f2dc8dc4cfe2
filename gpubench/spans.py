"""
What the per-layer readers of the program's own trace share: the spans
and counts that ``pyshepseg_tpu_torch.timinghooks.TRACE`` kept over the
traced window (the program keeps them while a profiler session runs).
Each returns None where the program keeps no such trace or the window
left nothing to read, and the harness then leaves the metric out.
"""

from .devtrace import union_seconds


def trace():
    """The program's trace, or None where the program keeps none."""
    from pyshepseg_tpu_torch import timinghooks
    found = getattr(timinghooks, "TRACE", None)
    return found if hasattr(found, "spans") else None


def named(name):
    """(start, end) in seconds of every span named ``name``."""
    t = trace()
    if t is None:
        return []
    return [(s.start / 1e9, s.end / 1e9) for s in t.spans if s.name == name]


def seconds_per_unit(run, name):
    """The summed seconds of the spans named ``name`` over the window's
    units of work (its records: calls, scenes or passes)."""
    found = named(name)
    if not found or not run.records:
        return None
    return sum(e - s for s, e in found) / len(run.records)


def outside(outer, inner):
    """The mean over the spans named ``outer`` of each one's seconds not
    covered by the union of the spans named ``inner`` inside it."""
    outs, ins = named(outer), named(inner)
    if not outs:
        return None
    return sum((e - s) - union_seconds(
        [(max(a, s), min(b, e)) for a, b in ins if a < e and b > s])
        for s, e in outs) / len(outs)


def count(name):
    """The trace's count ``name``, or None."""
    t = trace()
    return None if t is None else t.counts.get(name)
