"""
The device trace of a ``--trace 1`` run: ``torch.profiler`` over the
measured window, reduced to the device's busy seconds (the union of its
kernel and copy intervals), the window's length, device time by kernel
name, and the breakdown the result line carries (the device operations
that took most time, the longest idle gaps by what the host was doing).
"""

import time

import numpy as np
import torch

TOP = 10
NAME_CHARS = 160
# the prefix of the harness's own record_function spans
ANNOTATION = "gpubench."


def union_seconds(spans):
    """Seconds covered by the union of ``(start, end)`` intervals."""
    busy, end = 0.0, float("-inf")
    for start, stop in sorted(spans):
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    return busy


def merged(spans):
    """The union of ``(start, end)`` intervals as sorted disjoint ones."""
    out = []
    for start, stop in sorted(spans):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], stop)
        else:
            out.append([start, stop])
    return out


def _ns(event, what):
    fn = getattr(event, what + "_ns", None)
    if fn is not None:
        return fn()
    return getattr(event, what + "_us")() * 1000


def events(prof):
    """(name, on_device, start_s, end_s) of every event of a finished
    profiler, on the profiler's clock. A span the host annotated
    (``record_function``) is a host event, though the profiler also draws
    it on the device's timeline."""
    out = []
    device = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        start = _ns(e, "start") / 1e9
        note = (getattr(e, "is_user_annotation", lambda: False)() or
                e.name().startswith(ANNOTATION))
        on = e.device_type() == device and not note
        if note and e.device_type() == device:
            continue
        out.append((e.name(), on, start, start + _ns(e, "duration") / 1e9))
    return out


def summarize(evs, t0, window_s):
    """The trace's summary from ``events`` over a window that starts at
    ``t0`` on their clock: busy_s, window_s, kernels {name: [count,
    seconds]} and the breakdown."""
    dev = [(s, e) for _, on, s, e in evs if on]
    kernels = {}
    for name, on, s, e in evs:
        if on:
            k = kernels.setdefault(name, [0, 0.0])
            k[0] += 1
            k[1] += e - s
    busy = merged(dev)
    edges = [t0] + [x for span in busy for x in span] + [t0 + window_s]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    host = [(n, s, e) for n, on, s, e in evs if not on]
    starts = np.array([s for _, s, _ in host])
    ends = np.array([e for _, _, e in host])
    idle = []
    for g0, g1 in gaps[:TOP]:
        mid = 0.5 * (g0 + g1)
        inside = np.flatnonzero((starts <= mid) & (ends >= mid)) if len(
            host) else []
        if len(inside):
            j = inside[np.argmin(ends[inside] - starts[inside])]
            label = host[j][0]
        else:
            label = "host outside any torch op"
        idle.append([label[:NAME_CHARS], g1 - g0])
    ops = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:TOP]
    return {"busy_s": union_seconds(dev), "window_s": window_s,
            "kernels": kernels,
            "breakdown": {"device_ops": [[n[:NAME_CHARS], v[1]]
                                         for n, v in ops],
                          "idle_gaps": idle}}


class Tracer:
    """``with Tracer(device):`` profiles the block; ``summary()`` after."""

    def __init__(self, device):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.device = device
        self.prof = profile(activities=acts)

    def __enter__(self):
        self.prof.__enter__()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.window_s = time.perf_counter() - self.t0
        return self.prof.__exit__(*exc)

    def summary(self):
        evs = events(self.prof)
        start = self.prof.profiler.kineto_results.trace_start_ns() / 1e9
        # the window opens after the profiler's own start-up
        t0 = max(start, min((s for _, _, s, _ in evs), default=start))
        return summarize(evs, t0, self.window_s)
