"""
Shepherd segmentation of one float32 tile in plain PyTorch: the steps of
``reference/segment.py`` with its assignment, clumps, single pixels,
adjacency and ``max_spectral_diff`` imported as they are, and the two
sums restated in float32:

- a segment's band sums: each from 0.0, its pixels added one at a time in
  row-major order, in float32, on the host (the CPU's serial
  ``index_add_`` into a 1-D vector), never with the card's atomics;
- step 4: means are the float32 sum over the float32 size; in a pass,
  each target's movers are summed on the host in ascending id from 0.0
  and that total is added onto the target's sum; the movers' sums become
  0.

This order is the port's and the JAX package's documented choice, not
pyshepseg's: pyshepseg sums a segment's pixels in float32 in the order
its Numba loops visit them and, in a pass, adds each mover onto its
target as it goes, so its bits may differ in the last place wherever a
merge decision sits on a tie.

``tf32=True`` rounds both operands of the assignment's product to TF32
first: the control, one precision below what the configuration states.
"""

import numpy as np
import torch

from .segment import (MAX_PASSES, adjacency, assign, clump,
                      eliminate_single_pixels, max_spectral_diff)

__all__ = ["max_spectral_diff", "serial_sums", "segment_tile"]

_NO_ID = 1 << 40


def serial_sums(index, values, n):
    """(bands, n) float32 on the host: for each band and bin, 0.0 plus the
    values of ``index``'s elements in that bin, one at a time in element
    order. ``index`` (m,) int64, ``values`` (bands, m) float32, any
    device."""
    index = index.cpu()
    values = values.cpu()
    return torch.stack([torch.zeros(n, dtype=torch.float32).index_add_(
        0, index, values[b]) for b in range(values.shape[0])])


def eliminate_small_segments(ea, eb, size, sums, min_size, max_diff_sqr):
    """Step 4 on the adjacency (ea, eb) with per-id ``size`` (int64) and
    float32 band ``sums`` ((bands, ids)). Returns (remap id -> final id,
    final sizes, merges, passes)."""
    n = size.shape[0]
    dev = size.device
    ids = torch.arange(n, device=dev)
    remap = ids.clone()
    inf = float("inf")
    merges = passes = 0
    for target in range(1, min_size):
        count = int((size == target).sum())
        prev, npass = -1, 0
        while count > 0 and count != prev and npass < MAX_PASSES:
            a, b = remap[ea], remap[eb]
            live = (a != b) & (a != 0) & (b != 0)
            sa, sb = size[a], size[b]
            means = sums / size.clamp_min(1).to(torch.float32)
            d = torch.zeros(a.shape, dtype=torch.float32, device=dev)
            for band in range(means.shape[0]):
                diff = means[band][a] - means[band][b]
                d = d + diff * diff
            a_in = live & (sa == target) & (sb > sa)
            b_in = live & (sb == target) & (sa > sb)
            who = torch.cat([a[a_in], b[b_in]])
            into = torch.cat([b[a_in], a[b_in]])
            dist = torch.cat([d[a_in], d[b_in]])
            best = torch.full((n,), inf, device=dev).scatter_reduce(
                0, who, dist, "amin")
            tie = dist == best[who]
            pick = torch.full((n,), _NO_ID, device=dev).scatter_reduce(
                0, who[tie], into[tie], "amin")
            move = ((size == target) & (ids > 0) & (pick != _NO_ID) &
                    (best <= max_diff_sqr))
            to = torch.where(move, pick, ids)
            remap = to[remap]
            movers = torch.nonzero(move).squeeze(1)
            dest = pick[movers]
            size = size.index_add(0, dest, size[movers])
            size[movers] = 0
            # each target's movers, ascending id, summed from 0.0 on the host
            targets, slot = torch.unique(dest, return_inverse=True)
            totals = serial_sums(slot, sums[:, movers], targets.shape[0])
            sums = sums.clone()
            sums[:, targets] = sums[:, targets] + totals.to(dev)
            sums[:, movers] = 0
            merges += int(movers.numel())
            prev = count
            count = int((size == target).sum())
            npass += 1
        passes += npass
    return remap, size, merges, passes


def segment_tile(img, centres, nodata, min_size, max_diff, tf32=False):
    """Steps 1-5 on one (bands, H, W) float32 tile tensor. Returns (int64
    ids (H, W), dict of the counts: clumps, singlePixelsEliminated,
    smallSegmentsEliminated, elimPasses, maxSegId)."""
    cl = assign(img, centres, nodata, tf32)
    seg, nclumps = clump(cl)
    planes = [p.to(torch.float32) for p in img]
    seg = eliminate_single_pixels(seg, planes)
    n = nclumps + 1
    flat = seg.reshape(-1)
    size = torch.bincount(flat, minlength=n)
    sums = serial_sums(flat, torch.stack(
        [p.reshape(-1) for p in planes]), n).to(img.device)
    after_single = int((size[1:] > 0).sum())
    merges = passes = 0
    remap = torch.arange(n, device=img.device)
    if min_size > 1:
        ea, eb = adjacency(seg)
        max_diff_sqr = float(np.float32(max_diff) ** 2)
        remap, size, merges, passes = eliminate_small_segments(
            ea, eb, size, sums, min_size, max_diff_sqr)
    # step 5, the contiguous relabel, as reference/segment.py's
    keep = (size > 0) & (torch.arange(n, device=img.device) > 0)
    new_id = torch.where(keep, torch.cumsum(keep, 0), 0)
    out = new_id[remap][seg]
    return out, dict(clumps=nclumps,
                     singlePixelsEliminated=nclumps - after_single,
                     smallSegmentsEliminated=merges, elimPasses=passes,
                     maxSegId=int(keep.sum()))
