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
   (``scatter_reduce`` "amin", exact and order-free), the merge
   application (:func:`merge_apply`), and remap composition;
3. rewrite the segment image with one gather at the end, fused with the
   contiguous relabel.

The merge application of integer sums goes through kernel K3
(csrc/merge_apply.cu) on the card: it moves only the movers' sizes and
sums onto their targets, in place, exact in any order. Float32 sums on
the card go through :func:`merge_apply_movers`: the selection kernel of
csrc/ordered_sum.cu writes the merge map, moves the sizes and lists the
movers as (target, id) keys, a library sort orders those keys (one a
candidate, never the capacity), and kernel K4 adds each target's movers
in ascending id from +0.0 onto the target's row and zeroes the movers'
rows: the bits of :func:`merge_apply_reference` on the CPU.

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

import functools

import numpy as np
import torch

from .. import _kernels
from .. import timinghooks
from . import lut
from .constants import SegIdType, SEGNULLVAL, MINSEGID
from .shifts import shift, offsets_for
from . import segreduce
from .segreduce import (seg_sizes, seg_spectral_sums, relabel,
                        relabel_subtract, image_tensor, index_sum)
from .sync import to_host, masked

# "no neighbour" in the best-neighbour reduction (above any segment id)
_BIG_ID = 0xFFFFFFFF
# an unused slot of merge_apply_movers' keys: its bin lies past any id
_NO_KEY = 2 ** 63 - 1


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


def merge_apply_reference(size, sums, best_nbr, d_best, target: int,
                          max_diff_sqr):
    """
    Plain PyTorch version of :func:`merge_apply`: the candidates (size ==
    ``target``, id >= MINSEGID) that have a best neighbour within
    ``max_diff_sqr`` move their size and sums onto it. Merges commute
    (targets are never candidates), so every mover's row is added to its
    target's with two capacity-sized index adds, in which each non-mover
    adds zeros to row 0; on the CPU a float bin is summed serially in id
    order from +0.0 (segreduce.index_sum). Returns (merge_map, size',
    sums', n_moved tensor) as new tensors.
    """
    capacity = size.shape[0]
    ids = torch.arange(capacity, device=size.device)
    # spectral-difference limit (reference: shepseg.py:1060-1061, strict >)
    move = ((size == target) & (ids >= MINSEGID) & (best_nbr != _BIG_ID) &
            (d_best <= max_diff_sqr))
    merge_to = torch.where(move, best_nbr, SEGNULLVAL)
    merge_map = torch.where(move, merge_to, ids)
    moved_size = torch.where(move, size, 0)
    moved_sums = torch.where(move[None], sums, 0)
    size_new = size - moved_size + index_sum(capacity, merge_to, moved_size)
    sums_new = sums - moved_sums + index_sum(capacity, merge_to, moved_sums,
                                             dim=1)
    return merge_map, size_new, sums_new, move.sum()


def merge_apply(size, sums, best_nbr, d_best, target: int, max_diff_sqr):
    """
    The apply step of a graph pass: ``size`` (capacity,) int64, ``sums``
    (nBands, capacity), ``best_nbr`` (capacity,) int64 (_BIG_ID for none)
    and ``d_best`` (capacity,) float32 indexed by current id; returns
    (merge_map, size', sums', n_moved tensor) as
    :func:`merge_apply_reference` does. On CUDA tensors with int64 sums
    this launches kernel K3, which updates ``size`` and ``sums`` in place
    and returns them; on CPU tensors it runs the plain version. Raises on
    float sums on the card (they take :func:`merge_apply_movers`), on
    tensors that are not contiguous, and on mixed devices.
    """
    tensors = (size, sums, best_nbr, d_best)
    if all(t.device.type == "cpu" for t in tensors):
        return merge_apply_reference(size, sums, best_nbr, d_best, target,
                                     max_diff_sqr)
    dev = size.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("merge_apply: size, sums, best_nbr, d_best on %s"
                         % ", ".join(str(t.device) for t in tensors))
    if (size.dtype, sums.dtype, best_nbr.dtype, d_best.dtype) != (
            torch.int64, torch.int64, torch.int64, torch.float32):
        raise ValueError("merge_apply: int64 size, sums and best_nbr and "
                         "float32 d_best only, got %s" % ", ".join(
                             str(t.dtype) for t in tensors))
    capacity = size.shape[0]
    if (size.dim() != 1 or sums.dim() != 2 or sums.shape[1] != capacity or
            best_nbr.shape != size.shape or d_best.shape != size.shape):
        raise ValueError("merge_apply: shapes %s" % ", ".join(
            str(tuple(t.shape)) for t in tensors))
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("merge_apply: every tensor must be contiguous")
    merge_map = torch.empty_like(size)
    moved = torch.empty((), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        code = _kernels.lib().merge_apply_launch(
            size.data_ptr(), sums.data_ptr(), sums.shape[0],
            best_nbr.data_ptr(), d_best.data_ptr(), merge_map.data_ptr(),
            moved.data_ptr(), capacity, int(target), MINSEGID, _BIG_ID,
            float(np.float32(max_diff_sqr)), dev.index,
            _kernels.stream_ptr(size))
    _kernels.check(code, "merge_apply")
    _kernels.count(merge_apply)
    return merge_map, size, sums, moved


merge_apply.launches = 0
merge_apply.movers = 0


def merge_apply_movers(size, sums, best_nbr, d_best, target: int,
                       max_diff_sqr, candidates: int):
    """
    The apply step of a graph pass with float32 ``sums`` ((nBands,
    capacity)); otherwise as :func:`merge_apply`. ``candidates`` is the
    number of ids of size ``target`` (the host holds it before the pass),
    an upper bound on the movers. On CUDA tensors: the selection kernel
    (csrc/ordered_sum.cu) writes the merge map, moves the sizes in place
    and writes one key ``target << 32 | id`` a mover; the ``candidates``
    keys are sorted; K4 (segreduce.ordered_sum_keys) adds each target's
    movers in ascending id from +0.0 onto its row and zeroes the movers'
    rows, in place: the bits of :func:`merge_apply_reference` on the CPU,
    which is its plain version (CPU tensors run it). No host sync. Raises
    on other dtypes, tensors that are not contiguous, and mixed devices.
    """
    tensors = (size, sums, best_nbr, d_best)
    if all(t.device.type == "cpu" for t in tensors):
        return merge_apply_reference(size, sums, best_nbr, d_best, target,
                                     max_diff_sqr)
    dev = size.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("merge_apply_movers: size, sums, best_nbr, d_best "
                         "on %s" % ", ".join(str(t.device) for t in tensors))
    if (size.dtype, sums.dtype, best_nbr.dtype, d_best.dtype) != (
            torch.int64, torch.float32, torch.int64, torch.float32):
        raise ValueError("merge_apply_movers: int64 size and best_nbr, "
                         "float32 sums and d_best only, got %s" % ", ".join(
                             str(t.dtype) for t in tensors))
    capacity = size.shape[0]
    if (size.dim() != 1 or sums.dim() != 2 or sums.shape[1] != capacity or
            best_nbr.shape != size.shape or d_best.shape != size.shape):
        raise ValueError("merge_apply_movers: shapes %s" % ", ".join(
            str(tuple(t.shape)) for t in tensors))
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("merge_apply_movers: every tensor must be "
                         "contiguous")
    merge_map = torch.empty_like(size)
    moved = torch.empty((), dtype=torch.int64, device=dev)
    keys = torch.full((int(candidates),), _NO_KEY, dtype=torch.int64,
                      device=dev)
    with torch.cuda.device(dev):
        code = _kernels.lib().merge_movers_launch(
            size.data_ptr(), best_nbr.data_ptr(), d_best.data_ptr(),
            merge_map.data_ptr(), keys.data_ptr(), keys.shape[0],
            moved.data_ptr(), capacity, int(target), MINSEGID, _BIG_ID,
            float(np.float32(max_diff_sqr)), dev.index,
            _kernels.stream_ptr(size))
    _kernels.check(code, "merge_movers")
    _kernels.count(merge_apply_movers)
    if keys.shape[0]:
        segreduce.ordered_sum_keys(torch.sort(keys).values, sums, sums,
                                   dim=1, zero_source=True, elements=0)
    return merge_map, size, sums, moved


merge_apply_movers.launches = 0
merge_apply_movers.movers = 0


def _merge_pass_edges(ids2, remap, size, sums, target: int, max_diff_sqr,
                      apply):
    """
    One find+apply pass for segments of exactly ``target`` pixels on the
    segment-adjacency graph (reference findMergeSegment + doMerge,
    shepseg.py:1003-1123, on frozen per-pass state). ``ids2`` is the (2E,)
    ORIGINAL endpoint vector [ea | eb]; ``remap`` maps original id ->
    current id; ``size`` (capacity,) int64 and ``sums`` (nBands, capacity)
    are indexed by current id; ``apply`` is :func:`merge_apply`,
    :func:`merge_apply_reference` or :func:`merge_apply_movers` (the
    kernels update ``size`` and ``sums`` in place). Returns (remap',
    size', sums', n_merged tensor).
    """
    capacity = size.shape[0]
    E = ids2.shape[0] // 2
    dev = size.device
    inf = float("inf")

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

    merge_map, size_new, sums_new, n = apply(size, sums, best_nbr, d_best,
                                             target, max_diff_sqr)
    if lut.use_lut(capacity, dev):
        remap_new = lut.lut_gather_flat(remap, merge_map)
    else:
        remap_new = merge_map[remap]
    return remap_new, size_new, sums_new, n


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

    The loop is an ``elim_small.graph_loop`` span and each pass an
    ``elim_small.pass`` span in it (timinghooks). Where K3 applies the
    passes, the movers a pass reads on the host are counted in
    ``merge_apply.movers``; where float32 sums on the card take
    :func:`merge_apply_movers`, in ``merge_apply_movers.movers``, and
    their rows read by K4 in ``ordered_sum.bytes``.

    Returns (remap original->current id (int64), seg_size (int64),
    numEliminated, totalPasses). ``seg_size`` and ``spect_sum`` are left
    as they were.
    """
    capacity = seg_size.shape[0]
    dev = seg_size.device
    max_diff_sqr = float(np.float32(max_spectral_diff) ** 2)
    remap = (torch.arange(capacity, device=dev) if remap_init is None
             else remap_init.long())
    # the loop's own copies: K3 and K4 update them in place
    size = seg_size.to(torch.int64, copy=True)
    sums = spect_sum.T.clone(memory_format=torch.contiguous_format)
    # K3 for integer sums on the card, the movers-only apply (K4) for float
    # sums there; the CPU takes the plain version
    movers_only = sums.is_cuda and sums.is_floating_point()
    apply = (merge_apply if sums.is_cuda and sums.dtype == torch.int64
             else merge_apply_reference)
    # int32 halves the index bytes K2 streams each pass; ids < capacity < 2^31
    ids2 = torch.cat([ea, eb]).to(torch.int32)

    num_elim = 0
    total_passes = 0
    with timinghooks.span("elim_small.graph_loop"):
        for target in range(1, min_seg_size):
            count = to_host((size == target).sum())
            prev = -1
            passes = 0
            while count > 0 and count != prev and passes < 10:
                if movers_only:
                    apply = functools.partial(merge_apply_movers,
                                              candidates=count)
                with timinghooks.span("elim_small.pass"):
                    remap, size, sums, n = _merge_pass_edges(
                        ids2, remap, size, sums, target, max_diff_sqr,
                        apply)
                    prev = count
                    count, n = to_host(
                        torch.stack([(size == target).sum(), n]))
                    if apply is merge_apply:
                        _kernels.count(merge_apply, "movers", n)
                    elif movers_only:
                        _kernels.count(merge_apply_movers, "movers", n)
                        _kernels.count(segreduce.ordered_sum, "bytes",
                                       n * sums.shape[0] * 4)
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
