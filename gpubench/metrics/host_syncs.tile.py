"""Host synchronisations a tile: the program's ``ops.sync.to_host.syncs``
counter over the window, over the calls."""


def read(run):
    n = run.counters.get("host_syncs")
    return n / len(run.records) if n is not None and run.records else None
