"""
Shepherd segmentation of one tile in plain PyTorch, from its stated
semantics (Shepherd et al. 2019, as pyshepseg's ``doShepherdSegmentation``
defines them, with the port's documented choices):

1. Cluster assignment: each pixel goes to the centre with the least
   ``0.5 |c|^2 - x.c`` in float32 (``|c|^2`` summed band by band, the
   product in full float32), the lowest index on a tie; a pixel equal to
   the null value in any band is null (0).
2. Clumps: 4-connected components of equal cluster, numbered 1.. in the
   scan order of their first pixel.
3. Single pixels: passes that first find, for every pixel whose segment
   has one pixel, the spectrally nearest neighbour (float32 squared
   difference of the pixel values, bands added in order; neighbours in
   row-major order, the first strict minimum) whose segment has more than
   one pixel, then apply all of them; until a pass finds none. The null
   segment is a segment like any other here, as in pyshepseg.
4. Small segments: for each target size 1 .. minSegmentSize-1, passes
   over the segment adjacency while the count of segments of that size
   changes (at most 10): every segment of the target size merges into the
   adjacent strictly larger segment of least float32 squared distance
   between mean spectra (means of exact integer sums), the smallest id on
   a tie, if that squared distance is within maxSpectralDiff squared;
   decisions are taken on the state before the pass.
5. Contiguous relabel 1..n in id order.

``tf32=True`` rounds both operands of the assignment's product to TF32
(10 stored mantissa bits) first: the control, one precision below what
the configuration states.
"""

import numpy as np
import torch

# neighbours in row-major order of the 3 x 3 window, 4-connected
OFFSETS4 = ((-1, 0), (0, -1), (0, 1), (1, 0))
MAX_PASSES = 10
_NO_ID = 1 << 40


def neighbour(a, dy, dx, fill):
    """``out[y, x] = a[y + dy, x + dx]``, ``fill`` outside the image."""
    h, w = a.shape[-2:]
    out = torch.full_like(a, fill)
    out[..., max(-dy, 0):h - max(dy, 0), max(-dx, 0):w - max(dx, 0)] = \
        a[..., max(dy, 0):h + min(dy, 0), max(dx, 0):w + min(dx, 0)]
    return out


def round_tf32(t):
    """float32 values rounded to TF32 (to nearest, ties away)."""
    bits = t.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def max_spectral_diff(centres, percentile=50):
    """The 'auto' limit: the given percentile of the pairwise distances
    between the centres (float32 distances, as pyshepseg)."""
    c = np.asarray(centres, dtype=np.float64)
    i, j = np.triu_indices(c.shape[0], k=1)
    dist = np.sqrt(((c[i] - c[j]) ** 2).sum(axis=1)).astype(np.float32)
    return np.percentile(dist, percentile)


def assign(img, centres, nodata, tf32=False):
    """Cluster ids 1..K (int64 (H, W)), 0 where null; ``img`` is the
    (bands, H, W) integer tile, ``centres`` a (K, bands) float32
    tensor on its device."""
    nb, h, w = img.shape
    x = img.reshape(nb, h * w).to(torch.float32)
    c = centres
    if tf32:
        x, c = round_tf32(x), round_tf32(c)
    half = c[:, 0] * c[:, 0]
    for b in range(1, nb):
        half = half + c[:, b] * c[:, b]
    half = 0.5 * half
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        scores = half[:, None] - c @ x
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    cl = (torch.argmin(scores, dim=0) + 1).reshape(h, w)
    if nodata is not None:
        cl = torch.where((img == nodata).any(dim=0), 0, cl)
    return cl


def clump(cl):
    """4-connected components of equal non-zero ``cl``: int64 ids 1..n in
    the scan order of each component's first pixel, 0 for null; and n.
    Min-index propagation with pointer jumping to the fixpoint: a label
    is always the index of a pixel of the same component, no larger than
    the pixel's own."""
    h, w = cl.shape
    n = h * w
    idx = torch.arange(n, device=cl.device)
    lab = torch.where(cl.reshape(-1) != 0, idx, n)
    same = [(neighbour(cl, dy, dx, -1) == cl) & (cl != 0)
            for dy, dx in OFFSETS4]
    end = lab.new_full((1,), n)
    while True:
        grid = lab.reshape(h, w)
        new = grid
        for (dy, dx), s in zip(OFFSETS4, same):
            nb = neighbour(grid, dy, dx, n)
            new = torch.where(s, torch.minimum(new, nb), new)
        flat = new.reshape(-1)
        for _ in range(4):
            jumped = torch.cat([flat, end])[flat]
            if torch.equal(jumped, flat):
                break
            flat = jumped
        if torch.equal(flat, lab):
            break
        lab = flat
    root = lab == idx
    rank = torch.cat([torch.cumsum(root, 0), lab.new_zeros(1)])
    return rank[lab].reshape(h, w), int(root.sum())


def eliminate_single_pixels(seg, planes):
    """Step 3 on ``seg`` (int64 ids) with float32 ``planes``. Returns
    the new ``seg``."""
    d2s = []
    for dy, dx in OFFSETS4:
        d2 = torch.zeros_like(planes[0])
        for p in planes:
            diff = p - neighbour(p, dy, dx, 0.0)
            d2 = d2 + diff * diff
        d2s.append(d2)
    inf = float("inf")
    while True:
        size = torch.bincount(seg.reshape(-1))
        mine = size[seg]
        single = mine == 1
        if not bool(single.any()):
            return seg
        eligible = mine > 1
        best = torch.full_like(planes[0], inf)
        target = torch.zeros_like(seg)
        for (dy, dx), d2 in zip(OFFSETS4, d2s):
            ok = neighbour(eligible, dy, dx, False)
            d = torch.where(ok, d2, inf)
            better = d < best
            best = torch.where(better, d, best)
            target = torch.where(better, neighbour(seg, dy, dx, 0), target)
        move = single & torch.isfinite(best)
        if not bool(move.any()):
            return seg
        seg = torch.where(move, target, seg)


def adjacency(seg):
    """Unique pairs (a < b) of different non-null ids that touch
    4-connected, as two int64 vectors."""
    keys = []
    for a, b in ((seg[:, :-1], seg[:, 1:]), (seg[:-1, :], seg[1:, :])):
        ok = (a != 0) & (b != 0) & (a != b)
        lo, hi = torch.minimum(a[ok], b[ok]), torch.maximum(a[ok], b[ok])
        keys.append(lo * _NO_ID + hi)
    keys = torch.unique(torch.cat(keys))
    return keys // _NO_ID, keys % _NO_ID


def eliminate_small_segments(ea, eb, size, sums, min_size, max_diff_sqr):
    """Step 4 on the adjacency (ea, eb) with per-id ``size`` (int64) and
    integer band ``sums`` ((bands, ids) int64). Returns (remap id ->
    final id, final sizes, merges, passes)."""
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
            means = sums.to(torch.float32) / size.clamp_min(1).to(
                torch.float32)
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
            sums = sums.index_add(1, dest, sums[:, movers])
            sums[:, movers] = 0
            merges += int(movers.numel())
            prev = count
            count = int((size == target).sum())
            npass += 1
        passes += npass
    return remap, size, merges, passes


def segment_tile(img, centres, nodata, min_size, max_diff, tf32=False):
    """Steps 1-5 on one (bands, H, W) integer tile tensor. Returns (int64
    ids (H, W), dict of the counts: clumps, singlePixelsEliminated,
    smallSegmentsEliminated, elimPasses, maxSegId)."""
    cl = assign(img, centres, nodata, tf32)
    seg, nclumps = clump(cl)
    planes = [p.to(torch.float32) for p in img]
    seg = eliminate_single_pixels(seg, planes)
    n = nclumps + 1
    flat = seg.reshape(-1)
    size = torch.bincount(flat, minlength=n)
    sums = torch.stack([torch.zeros(n, dtype=torch.int64, device=img.device)
                        .index_add_(0, flat, p.reshape(-1).to(torch.int64))
                        for p in img])
    after_single = int((size[1:] > 0).sum())
    merges = passes = 0
    remap = torch.arange(n, device=img.device)
    if min_size > 1:
        ea, eb = adjacency(seg)
        max_diff_sqr = float(np.float32(max_diff) ** 2)
        remap, size, merges, passes = eliminate_small_segments(
            ea, eb, size, sums, min_size, max_diff_sqr)
    keep = (size > 0) & (torch.arange(n, device=img.device) > 0)
    new_id = torch.where(keep, torch.cumsum(keep, 0), 0)
    out = new_id[remap][seg]
    return out, dict(clumps=nclumps,
                     singlePixelsEliminated=nclumps - after_single,
                     smallSegmentsEliminated=merges, elimPasses=passes,
                     maxSegId=int(keep.sum()))
