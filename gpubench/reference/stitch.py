"""
The cross-tile stitch in plain NumPy, from its stated semantics
(pyshepseg's ``stitchTiles`` with the port's documented choices):

- the uniform grid: every tile is ``tile`` square, steps by ``tile -
  overlap``, and the last tile of an axis shifts back to end at the
  raster's edge, sharing a wider strip with its neighbour;
- between two tiles that share a strip of width ``s``, the earlier tile
  writes the first ``s - s // 2`` of it and the later one the rest;
- tiles are stitched in row-major order. A segment of a tile that lies
  on both sides of the midline of the strip it shares with the tile above
  (then the tile to the left, which wins) takes the id of the most common
  non-null co-located pixel there in the earlier tile's output (the
  smallest id on a tie); a segment with no such pixel keeps no match;
- every other segment with a pixel inside the tile's own window gets the
  next new id, in ascending order of its tile id; the rest are written by
  the tiles that own them.
"""

import numpy as np


def axis_starts(total, tile, overlap):
    """Start of each tile along one axis of the uniform grid."""
    if total <= tile:
        return [0]
    starts = [0]
    while starts[-1] + tile < total:
        starts.append(min(starts[-1] + tile - overlap, total - tile))
    return starts


def grid(height, width, tile, overlap):
    """{(col, row): (x, y, xsize, ysize)} of the uniform grid."""
    ys = axis_starts(height, tile, overlap)
    xs = axis_starts(width, tile, overlap)
    return {(c, r): (x, y, min(tile, width), min(tile, height))
            for r, y in enumerate(ys) for c, x in enumerate(xs)}


def _matches(mine, theirs, along_rows):
    """{tile id: earlier id} for the segments of ``mine`` (the tile's
    side of a shared strip) that cross its midline, from ``theirs`` (the
    earlier tile's output over the same pixels)."""
    mid = mine.shape[0 if along_rows else 1] // 2
    before = mine[:mid] if along_rows else mine[:, :mid]
    after = mine[mid:] if along_rows else mine[:, mid:]
    top = int(mine.max()) + 1
    crossing = ((np.bincount(before.ravel(), minlength=top) > 0) &
                (np.bincount(after.ravel(), minlength=top) > 0))
    crossing[0] = False
    sel = crossing[mine] & (theirs != 0)
    if not sel.any():
        return {}
    pairs = (mine[sel].astype(np.uint64) << np.uint64(32)) | \
        theirs[sel].astype(np.uint64)
    uniq, counts = np.unique(pairs, return_counts=True)
    a = (uniq >> np.uint64(32)).astype(np.int64)
    b = (uniq & np.uint64(0xFFFFFFFF)).astype(np.int64)
    # per segment: the largest count, then the smallest earlier id
    order = np.lexsort((b, -counts, a))
    a, b = a[order], b[order]
    first = np.ones(len(a), dtype=bool)
    first[1:] = a[1:] != a[:-1]
    return dict(zip(a[first].tolist(), b[first].tolist()))


def stitch(tiles, height, width, tile, overlap):
    """The mosaic (uint32 (height, width)) of ``tiles``, a dict
    {(col, row): uint32 (ysize, xsize) tile ids}, and its largest id."""
    geo = grid(height, width, tile, overlap)
    ncols = 1 + max(c for c, _ in geo)
    nrows = 1 + max(r for _, r in geo)
    out = np.zeros((height, width), dtype=np.uint32)
    right, bottom = {}, {}
    last = 0
    for r in range(nrows):
        for c in range(ncols):
            x, y, xs, ys = geo[(c, r)]
            t = tiles[(c, r)]
            top_s = geo[(c, r - 1)][1] + geo[(c, r - 1)][3] - y if r else 0
            left_s = geo[(c - 1, r)][0] + geo[(c - 1, r)][2] - x if c else 0
            bot_s = (y + ys - geo[(c, r + 1)][1]) if r < nrows - 1 else 0
            right_s = (x + xs - geo[(c + 1, r)][0]) if c < ncols - 1 else 0
            match = {}
            if top_s:
                match.update(_matches(t[:top_s], bottom.pop((c, r - 1)),
                                      True))
            if left_s:
                match.update(_matches(t[:, :left_s], right.pop((c - 1, r)),
                                      False))
            mapping = np.zeros(int(t.max()) + 1, dtype=np.uint32)
            matched = np.zeros(len(mapping), dtype=bool)
            for k, v in match.items():
                mapping[k] = v
                matched[k] = True
            y0, y1 = top_s // 2, ys - (bot_s - bot_s // 2)
            x0, x1 = left_s // 2, xs - (right_s - right_s // 2)
            window = t[y0:y1, x0:x1]
            present = np.bincount(window.ravel(), minlength=len(mapping)) > 0
            present[0] = False
            owned = np.flatnonzero(present & ~matched)
            mapping[owned] = np.arange(last + 1, last + 1 + len(owned),
                                       dtype=np.uint32)
            last += len(owned)
            out[y + y0:y + y1, x + x0:x + x1] = mapping[window]
            if right_s:
                right[(c, r)] = mapping[t[:, xs - right_s:]]
            if bot_s:
                bottom[(c, r)] = mapping[t[ys - bot_s:]]
    return out, last


def histogram(mosaic):
    """Pixel count of each id of a mosaic, the null bin zeroed."""
    hist = np.bincount(mosaic.ravel()).astype(np.int64)
    hist[0] = 0
    return hist
