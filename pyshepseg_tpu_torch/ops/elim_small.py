"""
Small-segment elimination in graph space
(counterpart: pyshepseg_tpu/ops/elim_small.py).

Within one pass at a given targetSize, merge decisions are taken against a
frozen snapshot of sizes and spectral sums, and a merge target is strictly
larger than the merging segment, so candidates (size == targetSize) and
targets (size > targetSize) are disjoint: no merge chains exist inside a
pass and applying the merges commutes. Segments only ever merge, so the
current adjacency is the image's original adjacency pushed through an
id remap (orig id -> current id). Hence:

1. extract the unique segment-adjacency edge list from the image once
   (one int64 sort of ``lo << 32 | hi`` keys, then dedupe);
2. run every find+apply pass on (2E,) and (capacity,) vectors: remap the
   edge endpoints, per-edge mean distances, two segment minima
   (``scatter_reduce`` "amin", exact and order-free), merge application
   as capacity-sized index adds, and remap composition;
3. rewrite the segment image with one gather at the end, fused with the
   contiguous relabel.

The id-remap gathers go through kernel K2 (ops/lut.py) on the card at
every capacity, with their index and table types as they are: the graph
passes (reuse n / c of ~3 and 1) on its direct route, which reads the
table through the caches; the final relabel (reuse in the hundreds) on
its staged route, which copies the table into shared memory, when the
table is too large for the direct route's L1 and still fits shared memory
(lut.lut_route), else on the direct route too. Ties between
equal-distance neighbours go to the smallest neighbour id (the JAX
package's documented deviation from the reference).
"""

import numpy as np
import torch

from .. import _kernels
from . import lut
from .constants import SegIdType, SEGNULLVAL, MINSEGID
from .shifts import shift, offsets_for
from .segreduce import (seg_sizes, seg_spectral_sums, relabel,
                        relabel_subtract, image_tensor)
from .sync import to_host, masked

# "no neighbour" in the best-neighbour reduction (above any segment id)
_BIG_ID = 0xFFFFFFFF


def round_capacity(n: int) -> int:
    """Round a segment-count capacity up to a power of two (>= 1024)."""
    cap = 1024
    while cap < n:
        cap *= 2
    return cap


def edge_sort_keys(seg, four_connected: bool):
    """
    Sorted canonical (min id, max id) segment-adjacency pairs of a segment
    image, one per adjacent pixel pair of two different non-null segments
    (duplicates included), plus the first-of-run flags and the number of
    unique pairs (a tensor). Returns (a, b, first, n_unique), a and b
    int64.
    """
    offsets = [(dy, dx) for dy, dx in offsets_for(four_connected)
               if (dy, dx) in ((0, 1), (1, 0), (1, 1), (1, -1))]
    seg64 = seg.long()
    parts = []
    for dy, dx in offsets:
        nbr = shift(seg64, dy, dx, SEGNULLVAL)
        ok = (seg64 != SEGNULLVAL) & (nbr != SEGNULLVAL) & (nbr != seg64)
        key = (torch.minimum(seg64, nbr) << 32) | torch.maximum(seg64, nbr)
        parts.append(masked(key, ok))
    keys = torch.sort(torch.cat(parts)).values
    first = torch.ones_like(keys, dtype=torch.bool)
    first[1:] = keys[1:] != keys[:-1]
    return keys >> 32, keys & 0xFFFFFFFF, first, first.sum()


def compact_edges(a, b, first):
    """The flagged unique pairs as (ea, eb) endpoint vectors."""
    return masked(a, first), masked(b, first)


def _merge_pass_edges(ids2, remap, size, sums, target: int, max_diff_sqr):
    """
    One find+apply pass for segments of exactly ``target`` pixels on the
    segment-adjacency graph (reference findMergeSegment + doMerge,
    shepseg.py:1003-1123, on frozen per-pass state). ``ids2`` is the (2E,)
    ORIGINAL endpoint vector [ea | eb]; ``remap`` maps original id ->
    current id; ``size`` (capacity,) int64 and ``sums`` (nBands, capacity)
    are indexed by current id. Returns (remap', size', sums', n_merged
    tensor).
    """
    capacity = size.shape[0]
    E = ids2.shape[0] // 2
    dev = size.device
    inf = float("inf")
    ids = torch.arange(capacity, device=dev)

    is_cand = (size == target) & (ids >= MINSEGID)
    # means divide in float32, as the JAX package's float32 table does
    means = sums.to(torch.float32) / torch.clamp(size, min=1).to(
        torch.float32)[None]

    if lut.use_lut(capacity, dev):
        cur2 = lut.lut_gather_flat(ids2, remap)
    else:
        cur2 = remap[ids2]
    cur_a, cur_b = cur2[:E], cur2[E:]
    live = (cur_a != cur_b) & (cur_a != SEGNULLVAL) & (cur_b != SEGNULLVAL)

    size2 = size[cur2]
    size_a, size_b = size2[:E], size2[E:]
    cand_a = (size_a == target) & (cur_a >= MINSEGID)
    cand_b = (size_b == target) & (cur_b >= MINSEGID)
    m2 = means[:, cur2]                                 # (nBands, 2E)
    diff = m2[:, :E] - m2[:, E:]
    d2u = diff[0] * diff[0]
    for band in range(1, diff.shape[0]):
        d2u = d2u + diff[band] * diff[band]

    ok_ab = live & cand_a & (size_b > size_a)        # a merges into b
    ok_ba = live & cand_b & (size_a > size_b)        # b merges into a
    d2 = torch.cat([torch.where(ok_ab, d2u, inf),
                    torch.where(ok_ba, d2u, inf)])
    nbr = torch.cat([torch.where(ok_ab, cur_b, _BIG_ID),
                     torch.where(ok_ba, cur_a, _BIG_ID)])

    # segment minima: best distance, then smallest neighbour at it
    d_best = torch.full((capacity,), inf, device=dev).scatter_reduce(
        0, cur2, d2, "amin", include_self=False)
    nb_hit = torch.where(d2 == d_best[cur2], nbr, _BIG_ID)
    best_nbr = torch.full((capacity,), _BIG_ID, device=dev).scatter_reduce(
        0, cur2, nb_hit, "amin", include_self=False)

    # spectral-difference limit (reference: shepseg.py:1060-1061, strict >)
    move = is_cand & (best_nbr != _BIG_ID) & (d_best <= max_diff_sqr)
    merge_to = torch.where(move, best_nbr, SEGNULLVAL)
    merge_map = torch.where(move, merge_to, ids)
    if lut.use_lut(capacity, dev):
        remap_new = lut.lut_gather_flat(remap, merge_map)
    else:
        remap_new = merge_map[remap]

    # merges commute (targets are never candidates): move each mover's
    # size and sums onto its target; non-movers add zeros to row 0
    moved_size = torch.where(move, size, 0)
    moved_sums = torch.where(move[None], sums, 0)
    size_new = size - moved_size + torch.zeros_like(size).index_add_(
        0, merge_to, moved_size)
    sums_new = sums - moved_sums + torch.zeros_like(sums).index_add_(
        1, merge_to, moved_sums)
    return remap_new, size_new, sums_new, move.sum()


def eliminate_small_segments_graph(ea, eb, seg_size, spect_sum,
                                   min_seg_size: int, max_spectral_diff,
                                   remap_init=None):
    """
    The full targetSize sweep (reference: shepseg.py:918-1000) on the
    adjacency graph. For targetSize = 1 .. min_seg_size-1, run find+apply
    passes until the count of segments at that size stops changing (at
    most 10 passes, the reference's MAXPASSES).

    ``ea``/``eb`` may be adjacencies of an earlier labelling (the clump
    image) with ``remap_init`` mapping those ids to the current ones;
    ``seg_size`` (int64) and ``spect_sum`` ((capacity, nBands)) are
    indexed by current id.

    Returns (remap original->current id (int64), seg_size (int64),
    numEliminated, totalPasses).
    """
    capacity = seg_size.shape[0]
    dev = seg_size.device
    max_diff_sqr = float(np.float32(max_spectral_diff) ** 2)
    remap = (torch.arange(capacity, device=dev) if remap_init is None
             else remap_init.long())
    size = seg_size.long()
    sums = spect_sum.T.contiguous()
    # int32 halves the index bytes K2 streams each pass; ids < capacity < 2^31
    ids2 = torch.cat([ea, eb]).to(torch.int32)

    num_elim = 0
    total_passes = 0
    for target in range(1, min_seg_size):
        count = to_host((size == target).sum())
        prev = -1
        passes = 0
        while count > 0 and count != prev and passes < 10:
            remap, size, sums, n = _merge_pass_edges(
                ids2, remap, size, sums, target, max_diff_sqr)
            prev = count
            count, n = to_host(torch.stack([(size == target).sum(), n]))
            num_elim += n
            passes += 1
        total_passes += passes
    return remap, size, num_elim, total_passes


def _remap_and_relabel(seg, remap, seg_size_out):
    """
    Apply the orig->current id remap and the contiguous relabel with ONE
    full-image gather: relabel subtracts per *current* id, so the two maps
    compose into one capacity-sized table,
    table[orig] = remap[orig] - sub[remap[orig]]. Returns seg's dtype.
    """
    sub = relabel_subtract(seg_size_out, MINSEGID)
    table = (remap - sub[remap]).to(seg.dtype)
    if lut.use_lut(table.shape[0], seg.device):
        return lut.lut_gather(seg, table)
    return table[seg.long()]


def eliminate_small_segments_device(seg, seg_size, spect_sum,
                                    min_seg_size: int, max_spectral_diff,
                                    four_connected: bool):
    """
    Edge extraction + graph elimination + final image rewrite, on a
    segment image ``seg`` (int32) with its sizes and spectral sums.
    Returns (relabelled seg, numEliminated, totalPasses).
    """
    if min_seg_size <= 1:
        return relabel(seg, seg_size, MINSEGID), 0, 0
    a, b, first, _ = edge_sort_keys(seg, four_connected)
    ea, eb = compact_edges(a, b, first)
    remap, seg_size_out, num_elim, passes = eliminate_small_segments_graph(
        ea, eb, seg_size, spect_sum, min_seg_size, max_spectral_diff)
    return _remap_and_relabel(seg, remap, seg_size_out), num_elim, passes


def eliminateSmallSegments(seg, img, maxSegId, minSegSize, maxSpectralDiff,
                           fourConnected=True, minSegId=MINSEGID,
                           device="cuda"):
    """
    Host API matching the reference signature (reference: shepseg.py:918).
    Modifies ``seg`` (numpy) in place; returns the number of segments
    eliminated.
    """
    if minSegSize <= 1:
        return 0
    device = _kernels.torch_device(device)
    capacity = round_capacity(int(maxSegId) + 1)
    seg_t = torch.from_numpy(np.asarray(seg).astype(np.int32)).to(device)
    img_t = image_tensor(img, device)
    seg_out, num_elim, _ = eliminate_small_segments_device(
        seg_t, seg_sizes(seg_t, capacity),
        seg_spectral_sums(seg_t, img_t, capacity), int(minSegSize),
        float(maxSpectralDiff), bool(fourConnected))
    seg[...] = seg_out.cpu().numpy().astype(SegIdType)
    return int(num_elim)
