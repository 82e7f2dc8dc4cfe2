"""
What several per-layer metric readers share. A reader returns None when
its run has nothing to read, and the harness then leaves the metric out.
"""


def mean(values):
    values = list(values)
    return sum(values) / len(values) if values else None


def timer_mean(run, *names, minus=()):
    """Per unit of work, the summed totals of the program's Timers
    ``names`` less ``minus``, averaged over the window's units."""
    recs = [r["timers"] for r in run.records if "timers" in r]
    if not recs or any(n not in t for t in recs for n in names):
        return None
    return mean(sum(t[n] for n in names) - sum(t.get(n, 0.0) for n in minus)
                for t in recs)


def idle_pct(run):
    """The device's idle share (%) of the traced window."""
    if run.trace is None or run.trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])


def peak_mib(run):
    """``torch.cuda.max_memory_allocated`` over the window, in MiB."""
    return run.peak / 2 ** 20 if run.peak else None
