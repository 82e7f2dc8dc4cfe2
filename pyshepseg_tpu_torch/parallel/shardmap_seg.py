"""
Full Shepherd segmentation of ONE image whose rows are sharded over a list
of devices (counterpart: pyshepseg_tpu/parallel/shardmap_seg.py).

parallel/mesh.py (CONC_MESH) scales by giving whole tiles to devices;
parallel/shardmap_clump.py clumps a single oversized image across devices.
This module completes that axis: the ENTIRE pipeline (cluster assignment
-> connected-component clumping -> single-pixel elimination ->
small-segment elimination -> contiguous relabel) on an image whose rows
are sharded over the list, producing output bit-identical to the
single-device pipeline (parallel/pipeline.segment_tile). It needs no
overlap/stitch reconciliation at all: the list IS one segmentation.

A row-sharded array is a Python list of per-stripe tensors, each on its
stripe's device, stepped by one process (see shardmap_clump). What moves
between devices:

- image-space stages hand ONE halo row of labels/masks a sweep to each
  neighbour (``exchange_rows``), with the global fixpoints decided from
  the stripes' flags in one host sync a sweep;
- per-segment state (sizes, spectral sums, the id remap) is
  capacity-sized: each stripe contributes its own scatter and the pieces
  are merged on the first stripe's device (sum or max). Sums of integer
  imagery are int64 (ops/segreduce), exact in any grouping, so the sharded
  result equals the single-device one bit for bit at any segment size.
  Float imagery is summed in float32 per stripe before the merge, a
  different order of additions than the whole-image sum: a segment's
  band sum may then differ from the single-device result in the last
  place, which can flip a nearest-neighbour tie;
- the small-segment elimination graph loop runs ONCE, on the first
  stripe's device, over the edge list gathered from all stripes (the JAX
  package runs it redundantly on every device only to avoid collectives
  inside the loop); the relabel table it yields goes to every device and
  is applied per stripe through ops/lut (kernel K2 on a CUDA device).
"""

import numpy as np
import torch

from .. import _kernels
from ..ops.constants import SegIdType, SEGNULLVAL, MINSEGID
from ..ops.kmeans import assign_clusters, null_scalar
from ..ops.shifts import shift, offsets_for
from ..ops.segreduce import (band_planes, image_tensor, seg_sizes,
                             seg_spectral_sums_planes)
from ..ops.elim_small import (compact_edges, eliminate_small_segments_graph,
                              _remap_and_relabel)
from ..ops.sync import masked, to_host
from .shardmap_clump import (AXIS, _clump_sharded,  # noqa: F401
                             exchange_rows, with_halo, any_over_stripes,
                             row_stripes)


def _merged(pieces, reduce):
    """The per-stripe capacity-sized ``pieces`` moved to the first
    stripe's device and reduced there (the JAX ``psum`` / ``pmax``)."""
    dev = pieces[0].device
    out = pieces[0]
    for piece in pieces[1:]:
        out = reduce(out, piece.to(dev, non_blocking=True))
    return out


def _replicated(t, stripes):
    """``t`` on every device that holds a stripe, as a list by stripe
    (one copy per distinct device)."""
    copies = {}
    for s in stripes:
        if s.device not in copies:
            copies[s.device] = t.to(s.device, non_blocking=True)
    return [copies[s.device] for s in stripes]


def _edge_sort_keys_stripe(segs, four_connected: bool):
    """
    Per-stripe sorted canonical (lo, hi) clump-adjacency pairs, including
    the pairs that cross into the stripe BELOW through one halo row (each
    cross-boundary pair is owned by the upper stripe, so the union over
    stripes covers every adjacency exactly as ops/elim_small.edge_sort_keys
    does for a whole image). Returns lists by stripe (a, b, first,
    n_unique), as edge_sort_keys' values.
    """
    _, bots = exchange_rows(segs, SEGNULLVAL)
    offsets = [(0, 1), (1, 0)] + ([] if four_connected
                                  else [(1, 1), (1, -1)])
    out = ([], [], [], [])
    for seg, bot in zip(segs, bots):
        s = seg.shape[0]
        seg64 = seg.long()
        ext = torch.cat([seg64, bot.long()[None]], dim=0)   # (s+1, W)
        keys, oks = [], []
        for dy, dx in offsets:
            nbr = shift(ext, dy, dx, SEGNULLVAL)[:s]
            oks.append((seg64 != SEGNULLVAL) & (nbr != SEGNULLVAL) &
                       (nbr != seg64))
            keys.append((torch.minimum(seg64, nbr) << 32) |
                        torch.maximum(seg64, nbr))
        # one data-sized selection (one host sync) a stripe
        keys = torch.sort(masked(torch.cat(keys), torch.cat(oks))).values
        first = torch.ones_like(keys, dtype=torch.bool)
        first[1:] = keys[1:] != keys[:-1]
        for lst, val in zip(out, (keys >> 32, keys & 0xFFFFFFFF, first,
                                  first.sum())):
            lst.append(val)
    return out


def _single_pixel_sharded(planes, segs, sizes, four_connected: bool,
                          pad_rows: int = 0):
    """
    Single-pixel elimination over the stripes with a halo exchange every
    pass: the frozen find-all-then-apply pass semantics of ops/elim_single
    (reference: shepseg.py:572-736) hold globally because every pass reads
    only pass-start state, on-stripe or from the halo rows. ``planes`` is
    a list by stripe of tuples of float32 (s, W) band planes, ``sizes`` the
    per-segment pixel counts on every stripe's device (a list by stripe).
    The last ``pad_rows`` rows of the image are padding: they are no
    merge targets (their null pixels are not counted in ``sizes[0]``
    either), so that padding cannot change a result.
    Returns the stripes' new segment ids (sizes are stale; the caller
    recounts). Every pass adds one to ``_single_pixel_sharded.passes``.
    """
    inf = float("inf")
    offsets = offsets_for(four_connected)

    # Pass-invariant spectral distance fields, halo'd: the values at
    # out-of-image positions are masked by nbr_ok's False halo fill.
    d2s = []
    nb = len(planes[0])
    halos = [exchange_rows([p[b] for p in planes], 0.0) for b in range(nb)]
    for i, stripe_planes in enumerate(planes):
        planes_h = [with_halo(stripe_planes[b], halos[b][0][i],
                              halos[b][1][i]) for b in range(nb)]
        fields = []
        for dy, dx in offsets:
            d2 = torch.zeros_like(stripe_planes[0])
            for plane_h in planes_h:
                diff = plane_h[1:-1] - shift(plane_h, dy, dx, 0.0)[1:-1]
                d2 = d2 + diff * diff
            fields.append(d2)
        d2s.append(fields)

    single, nbr_ok = [], []
    for seg, size in zip(segs, sizes):
        sizes_at = size[seg.long()]
        single.append(sizes_at == 1)
        nbr_ok.append(sizes_at > 1)
    if pad_rows:
        stripe_h = segs[0].shape[0]
        real_rows = stripe_h * len(segs) - pad_rows
        for i in range(len(segs)):
            lo = max(0, real_rows - i * stripe_h)
            single[i][lo:] = False
            nbr_ok[i][lo:] = False

    while True:
        seg_tops, seg_bots = exchange_rows(segs, SEGNULLVAL)
        ok_tops, ok_bots = exchange_rows(nbr_ok, False)
        counts = []
        for i, seg in enumerate(segs):
            seg_h = with_halo(seg, seg_tops[i], seg_bots[i])
            ok_h = with_halo(nbr_ok[i], ok_tops[i], ok_bots[i])
            best_d = torch.full(seg.shape, inf, dtype=torch.float32,
                                device=seg.device)
            new_seg = torch.zeros_like(seg)
            for (dy, dx), d2 in zip(offsets, d2s[i]):
                nbr_seg = shift(seg_h, dy, dx, 0)[1:-1]
                ok = shift(ok_h, dy, dx, False)[1:-1]
                d2m = torch.where(ok, d2, inf)
                better = d2m < best_d        # strict <: first minimum wins
                best_d = torch.where(better, d2m, best_d)
                new_seg = torch.where(better, nbr_seg, new_seg)
            elim = single[i] & torch.isfinite(best_d)
            segs[i] = torch.where(elim, new_seg, seg)
            single[i] = single[i] & ~elim
            nbr_ok[i] = nbr_ok[i] | elim
            counts.append(elim.sum())
        _kernels.count(_single_pixel_sharded, "passes")
        # the halo rows were taken before any stripe was updated, and an
        # update rebinds a stripe's tensors (nothing is written in place),
        # so every stripe read pass-start state
        if not any_over_stripes(counts):
            return segs


_single_pixel_sharded.passes = 0


def _size_psum(segs, capacity: int):
    """Global per-segment pixel counts: each stripe's histogram, summed
    on the first stripe's device. (capacity,) int64."""
    return _merged([seg_sizes(seg, capacity) for seg in segs], torch.add)


def _stage1_sharded(imgs, centers, img_null_val, four_connected: bool,
                    has_null: bool):
    """Stage 1 over the stripes: cluster + clump + per-stripe edge keys.
    Returns (segs, a, b, first, num_clumps, n_unique), lists by stripe
    but for the clump count."""
    clusters = [assign_clusters(img, c, img_null_val, has_null)
                for img, c in zip(imgs, _replicated(centers, imgs))]
    segs, num_clumps = _clump_sharded(clusters, SEGNULLVAL, four_connected)
    a, b, first, n_unique = _edge_sort_keys_stripe(segs, four_connected)
    return segs, a, b, first, num_clumps, n_unique


def _stage2_sharded(imgs, segs, a, b, first, max_spectral_diff,
                    min_seg_size: int, four_connected: bool,
                    capacity: int, pad_rows: int = 0):
    """
    Stage 2 over the stripes: single-pixel elimination (halo fixpoint),
    the graph small-segment elimination on the clump-image edges gathered
    from all stripes (once, on the first stripe's device; see the module
    docstring), and the final relabel per stripe.
    Returns (segs, stats) with stats = (maxSegId, nAfterSingle, numElim,
    elimPasses) as Python ints.
    """
    dev0 = imgs[0].device
    planes = [band_planes(img.to(torch.float32)) for img in imgs]
    segs_clump = segs
    size = _size_psum(segs, capacity)
    if pad_rows:
        size[SEGNULLVAL] -= pad_rows * imgs[0].shape[-1]
    segs = _single_pixel_sharded(planes, list(segs),
                                 _replicated(size, segs), four_connected,
                                 pad_rows)

    # per-segment state merged from the stripes' contributions
    size = _size_psum(segs, capacity)
    spect = _merged([seg_spectral_sums_planes(seg, band_planes(img),
                                              capacity)
                     for seg, img in zip(segs, imgs)], torch.add)

    # clump id -> post-single id; every stripe holding a clump's pixels
    # scatters the SAME value (a clump merges as one), so a max merges
    remap0 = _merged(
        [torch.zeros(capacity, dtype=torch.int64, device=seg.device)
         .scatter_(0, clump.reshape(-1).long(), seg.reshape(-1).long())
         for clump, seg in zip(segs_clump, segs)], torch.maximum)

    edges = [compact_edges(aa, bb, ff) for aa, bb, ff in zip(a, b, first)]
    ea = torch.cat([e[0].to(dev0, non_blocking=True) for e in edges])
    eb = torch.cat([e[1].to(dev0, non_blocking=True) for e in edges])

    n_after_single = torch.count_nonzero(size[MINSEGID:])
    remap, size_out, num_elim, elim_passes = (
        eliminate_small_segments_graph(
            ea, eb, size, spect, min_seg_size, max_spectral_diff,
            remap_init=remap0))

    # contiguous relabel composed into one gather per stripe
    # (ops/elim_small._remap_and_relabel, on each device's copy)
    segs = [_remap_and_relabel(seg, r, s) for seg, r, s in zip(
        segs, _replicated(remap, segs), _replicated(size_out, segs))]
    max_seg_id, n_after_single = to_host(torch.stack(
        [torch.count_nonzero(size_out[MINSEGID:]), n_after_single]))
    return segs, (max_seg_id, n_after_single, int(num_elim),
                  int(elim_passes))


def segment_image_sharded(img, centers, imgNullVal=None,
                          maxSpectralDiff=None, minSegmentSize=50,
                          fourConnected=True, mesh=None,
                          fullResult=False):
    """
    Host API: the full Shepherd pipeline on one image sharded by rows
    over the devices of ``mesh``: a sequence of torch.devices or their
    names, one stripe to each, in which one device may appear more than
    once; None for every visible CUDA device (raises when there is none;
    pass CPU devices to run on the CPU). Output is bit-identical to the
    single-device parallel/pipeline.segment_tile on the same inputs for
    integer imagery; see the module docstring's caveat on float imagery.

    Parameters: ``img`` (nBands, H, W) numeric; ``centers`` (K, nBands)
    fitted cluster centres (float32); ``maxSpectralDiff`` must be a
    resolved float (use shepseg.autoMaxSpectralDiff for 'auto'); None
    disables the merge limit. Rows are padded with nulls to a multiple of
    the stripe count (padding rows take no part in any stage, so padding
    cannot change results).

    Returns (seg uint32 (H, W) with contiguous scan-order IDs from 1,
    maxSegId int); with ``fullResult=True``, additionally
    (numClumps, singlePixelsEliminated, smallSegmentsEliminated,
    elimPasses) ints.
    """
    devices = _kernels.device_list(mesh)
    n_dev = len(devices)

    img = np.ascontiguousarray(img)
    nbands, h, w = img.shape
    pad = (-h) % n_dev
    hasNull = imgNullVal is not None
    if pad:
        if not hasNull:
            # padding rows must hold a recognised null value, otherwise
            # they would be segmented as data
            raise ValueError(
                "image height {} does not divide the {}-device mesh and "
                "imgNullVal is None: pad the rows yourself or supply a "
                "null value".format(h, n_dev))
        img = np.pad(img, ((0, 0), (0, pad), (0, 0)),
                     constant_values=imgNullVal)
    if maxSpectralDiff is None:
        # effectively unbounded; squaring must stay finite in float32
        maxSpectralDiff = 1e18
    nullVal = null_scalar(imgNullVal if hasNull else 0, img.dtype)

    imgs = [image_tensor(t, t.device)
            for t in row_stripes(img, n_dev, devices, axis=1)]
    centers_t = torch.as_tensor(np.asarray(centers, dtype=np.float32))

    (segs, a, b, first, num_clumps, _) = _stage1_sharded(
        imgs, centers_t, nullVal, bool(fourConnected), hasNull)
    segs, stats = _stage2_sharded(
        imgs, segs, a, b, first, float(maxSpectralDiff),
        int(minSegmentSize), bool(fourConnected), num_clumps + 1, pad)

    seg = np.concatenate(
        [s.to(torch.int32).cpu().numpy() for s in segs])[:h].view(SegIdType)
    (maxSegId, nAfterSingle, numElimSmall, elimPasses) = stats
    if fullResult:
        return (seg, maxSegId, num_clumps, num_clumps - nAfterSingle,
                numElimSmall, elimPasses)
    return seg, maxSegId


def doShepherdSegmentationSharded(img, numClusters=60,
        clusterSubsamplePcnt=1, minSegmentSize=50, maxSpectralDiff='auto',
        imgNullVal=None, fourConnected=True, verbose=False,
        fixedKMeansInit=False, kmeansObj=None, spectDistPcntile=50,
        mesh=None):
    """
    Drop-in variant of shepseg.doShepherdSegmentation (same parameters
    and SegmentationResult, reference: shepseg.py:130-249) that runs the
    whole pipeline with the image's rows sharded across the devices of
    ``mesh`` (see :func:`segment_image_sharded`), for single images too
    large for one device's memory. The k-means fit runs on the first
    device of the list, on the host subsample exactly as in the
    single-device driver, so a fitted ``kmeansObj`` is interchangeable
    between the two.
    """
    import time
    from .. import shepseg

    t0 = time.time()
    devices = _kernels.device_list(mesh)
    img = np.ascontiguousarray(img)
    km = kmeansObj
    if km is None:
        km = shepseg.fitSpectralClusters(
            img, numClusters, clusterSubsamplePcnt, imgNullVal,
            fixedKMeansInit, device=devices[0])
    maxDiff = shepseg.autoMaxSpectralDiff(km, maxSpectralDiff,
                                          spectDistPcntile)
    (seg, maxSegId, numClumps, numSingle, numSmall, elimPasses) = (
        segment_image_sharded(
            img, np.asarray(km.cluster_centers_, dtype=np.float32),
            imgNullVal=imgNullVal, maxSpectralDiff=float(maxDiff),
            minSegmentSize=minSegmentSize, fourConnected=fourConnected,
            mesh=devices, fullResult=True))
    if verbose:
        print("Sharded segmentation:", numClumps, "clumps ->", maxSegId,
              "segments (", numSingle, "single pixels,", numSmall,
              "small segments eliminated ) in",
              round(time.time() - t0, 1), "seconds")

    segResult = shepseg.SegmentationResult()
    segResult.segimg = seg
    segResult.kmeans = km
    segResult.maxSpectralDiff = maxDiff
    segResult.singlePixelsEliminated = numSingle
    segResult.smallSegmentsEliminated = numSmall
    segResult.clumpSweeps = None   # not tracked by the sharded clump
    segResult.elimPasses = elimPasses
    return segResult
