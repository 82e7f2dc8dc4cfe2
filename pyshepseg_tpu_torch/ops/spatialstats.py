"""
Batched box functions for the built-in spatial per-segment statistics
(counterpart: pyshepseg_tpu/ops/spatialstats.py).

The spatial stats engine accumulates per-segment pixel coordinate lists
and, when a segment completes, evaluates a user function over the
segment's bounding box (reference: pyshepseg/tilingstats.py:1037-1216,
1846-1932, numba callbacks invoked one segment at a time). The built-in
functions (variogram, edge-pixel count) are tensor code instead: every
segment that completes in a finalization round is scattered into a
padded bounding-box tile on the host, boxes of one padded shape are
stacked, and one call evaluates the whole batch on the device. Both
functions also run one box at a time under ``torch.func.vmap`` (the
``DeviceSpatialUserFunc`` contract of tilingstats).

Padding uses the null value (variogram) / zero (mask), which both
functions ignore, so padded results equal the per-segment host results:
bit for bit for the integer edge count; to float32 accumulation order for
the variogram sums (the host path accumulates in float64; both land in a
float32 RAT column; PARITY.md deviation 6).
"""

import numpy as np
import torch


def pad_box_shape(h: int, w: int):
    """Bucket a bounding-box shape to powers of two (min 8), so one
    finalization round stacks its boxes into a few batches."""
    def up(n):
        b = 8
        while b < n:
            b *= 2
        return b
    return up(h), up(w)


def edge_pixel_counts(masks, four_connected: bool):
    """
    (B, Hb, Wb) 0/1 masks -> (B,) int32 counts of mask pixels with at
    least one missing 4-/8-neighbour (segment edge pixels — reference
    userFuncNumEdgePixels, tilingstats.py:1145-1216). Exact.
    """
    if four_connected:
        offsets = ((-1, 0), (1, 0), (0, -1), (0, 1))
    else:
        offsets = ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1),
                   (1, -1), (1, 0), (1, 1))
    m = masks.to(torch.bool)
    hb, wb = m.shape[-2:]
    rows = torch.arange(hb, device=m.device)
    cols = torch.arange(wb, device=m.device)
    inner = m
    for dy, dx in offsets:
        nbr = torch.roll(m, (dy, dx), dims=(-2, -1))
        # roll wraps; the wrapped-in row and column read as "missing"
        if dy != 0:
            nbr = nbr & (rows != (0 if dy > 0 else hb - 1))[:, None]
        if dx != 0:
            nbr = nbr & (cols != (0 if dx > 0 else wb - 1))[None, :]
        inner = inner & nbr
    edge = m & ~inner
    return edge.sum(dim=(-2, -1)).to(torch.int32)


def variogram_sums(vals, valid, max_dist: int):
    """
    (B, Hb, Wb) value boxes + validity masks -> per-distance-bin pair
    counts (int32) and squared-difference sums (float32), (B, max_dist)
    each, over the offset lattice (yoffset, xoffset) in 1..max_dist with
    dist = floor(sqrt(yo^2+xo^2)) in 1..max_dist — exactly the
    reference's double offset loop (tilingstats.py:1037-1094). The host
    finishes with sqrt(sumsq/count) per bin.
    """
    b, hb, wb = vals.shape
    v = vals.to(torch.float32)
    counts = [torch.zeros((b,), dtype=torch.int32, device=v.device)
              for _ in range(max_dist)]
    sums = [torch.zeros((b,), dtype=torch.float32, device=v.device)
            for _ in range(max_dist)]
    for yo in range(1, max_dist + 1):
        for xo in range(1, max_dist + 1):
            dist = int(np.sqrt(yo * yo + xo * xo))
            if dist < 1 or dist > max_dist:
                continue
            if yo >= hb or xo >= wb:
                continue
            a = v[:, :hb - yo, :wb - xo]
            c = v[:, yo:, xo:]
            ok = valid[:, :hb - yo, :wb - xo] & valid[:, yo:, xo:]
            d = torch.where(ok, a - c, 0.0)
            counts[dist - 1] = counts[dist - 1] + ok.sum(
                dim=(1, 2)).to(torch.int32)
            sums[dist - 1] = sums[dist - 1] + (d * d).sum(dim=(1, 2))
    return torch.stack(counts, dim=1), torch.stack(sums, dim=1)


def scatter_boxes(ptsList, fill, dtype, valueOf):
    """
    Host: scatter each segment's points into its padded bounding-box
    tile. ``ptsList`` holds recarrays with fields x, y (whole-image
    coords); all boxes in the list share ONE padded shape (group before
    calling). ``valueOf(pts)`` gives the per-point values (or None for a
    0/1 mask). Returns the (B, Hb, Wb) numpy array.
    """
    shapes = [(int(p['y'].max() - p['y'].min() + 1),
               int(p['x'].max() - p['x'].min() + 1)) for p in ptsList]
    hb, wb = pad_box_shape(max(s[0] for s in shapes),
                           max(s[1] for s in shapes))
    out = np.full((len(ptsList), hb, wb), fill, dtype=dtype)
    for i, p in enumerate(ptsList):
        ys = (p['y'] - p['y'].min()).astype(np.int64)
        xs = (p['x'] - p['x'].min()).astype(np.int64)
        out[i, ys, xs] = 1 if valueOf is None else valueOf(p)
    return out
