"""
Per-segment statistics of one band, from pyshepseg's ``SegmentStats``
semantics: over each segment's non-null pixels, ``min`` and ``max``, the
``mean`` as float32 of the float64 quotient of the exact sum, the
``stddev`` as float32 of the square root of the float64 mean squared
deviation from that float32 mean (summed over the segment's distinct
values in ascending order), and ``percentile`` p as the first distinct
value, in ascending order, at which the cumulative count reaches p % of
the segment's count. The distinct values and their counts come from one
sort on the device.

``float32=True`` accumulates the sums in float32: the control, one
precision below what the statistics state.
"""

import numpy as np
import torch


def value_runs(seg, band, nodata):
    """(segment, value, count) of each distinct (segment, value) pair of
    the non-null pixels, sorted by segment then value, as numpy arrays.
    ``seg`` and ``band`` are integer tensors of one shape on one device;
    values lie in 0..65535."""
    keep = seg.reshape(-1) > 0
    vals = band.reshape(-1).to(torch.int64)
    if nodata is not None:
        keep &= vals != nodata
    key = seg.reshape(-1)[keep] * 65536 + vals[keep]
    uniq, counts = torch.unique(key, return_counts=True)
    return ((uniq // 65536).cpu().numpy(), (uniq % 65536).cpu().numpy(),
            counts.cpu().numpy())


def segment_stats(runs, nseg, selection, missing=-9999, float32=False):
    """{name: float64 array of rows 0..nseg} for ``selection``, a list of
    (name, statistic[, percentile]) with statistics min, max, mean,
    stddev, percentile. Rows of segments without a value hold
    ``missing``; row 0 is left at 0."""
    sid, val, cnt = runs
    starts = np.searchsorted(sid, np.arange(nseg + 1))
    ends = np.searchsorted(sid, np.arange(nseg + 1), side="right")
    has = ends > starts
    has[0] = False
    group = np.repeat(np.arange(nseg + 1), ends - starts)
    n = np.bincount(group, weights=cnt, minlength=nseg + 1)
    acc = np.float32 if float32 else np.float64
    vc = (val * cnt).astype(acc)
    if float32:
        total = np.zeros(nseg + 1, np.float32)
        np.add.at(total, group, vc)
    else:
        total = np.bincount(group, weights=vc, minlength=nseg + 1)
    mean32 = np.zeros(nseg + 1, np.float32)
    mean32[has] = (total[has] / n[has].astype(acc)).astype(np.float32)
    out = {}
    for sel in selection:
        name, stat = sel[0], sel[1]
        col = np.full(nseg + 1, float(missing))
        col[0] = 0.0
        if stat == "min":
            col[has] = val[starts[has]]
        elif stat == "max":
            col[has] = val[ends[has] - 1]
        elif stat == "mean":
            col[has] = mean32[has]
        elif stat == "stddev":
            dev = (val - mean32.astype(np.float64)[group]).astype(acc)
            sq = (cnt.astype(acc) * dev ** 2).astype(acc)
            if float32:
                ssq = np.zeros(nseg + 1, np.float32)
                np.add.at(ssq, group, sq)
            else:
                ssq = np.bincount(group, weights=sq, minlength=nseg + 1)
            col[has] = np.sqrt(ssq[has] / n[has].astype(acc)).astype(
                np.float32)
        elif stat == "percentile":
            target = n * (sel[2] / 100.0)
            cum = np.cumsum(cnt)
            before = np.where(starts > 0, cum[np.maximum(starts - 1, 0)], 0)
            k = np.searchsorted(cum, target + before, side="left")
            k = np.minimum(k, ends - 1)
            k = np.where(target <= 0, ends - 1, k)
            col[has] = val[k[has]]
        else:
            raise ValueError("unknown statistic %r" % stat)
        out[name] = col
    return out
