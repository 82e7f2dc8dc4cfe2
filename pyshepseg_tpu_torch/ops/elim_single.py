"""
Single-pixel elimination (counterpart: pyshepseg_tpu/ops/elim_single.py).

Whole-image masked neighbour-shift sweeps with the reference's semantics:

- a pass first *finds* all merges against frozen masks, then applies them
  (the reference's mergeSinglePixels is find-all-then-apply);
- a single pixel merges into the spectrally nearest neighbouring pixel
  whose segment has size > 1, scanning the 3x3 window in row-major order
  and keeping the first strict minimum;
- passes repeat until no pixel is eliminated.

Spectral distances are float32, summed band by band in the JAX package's
order.
"""

import numpy as np
import torch

from .. import _kernels
from .constants import SegIdType, MINSEGID
from .shifts import shift, offsets_for
from .segreduce import (seg_sizes, relabel_subtract, band_planes,
                        image_tensor)
from .sync import to_host


def _one_pass(d2s, offsets, seg, single, nbr_ok):
    """One find-all-then-apply merge pass. Returns
    (seg', single', nbr_ok', nElim tensor).

    ``single`` (my segment has exactly 1 pixel) and ``nbr_ok`` (my
    segment has size > 1) evolve in closed form: a pixel stays single until
    it is itself eliminated, and an eliminated pixel joins a size > 1
    segment (see the JAX package's _one_pass for the argument).
    """
    inf = float("inf")
    best_d = torch.full(seg.shape, inf, dtype=torch.float32,
                        device=seg.device)
    new_seg = torch.zeros_like(seg)
    for (dy, dx), d2 in zip(offsets, d2s):
        nbr_seg = shift(seg, dy, dx, 0)
        # False fill keeps out-of-image neighbours ineligible
        ok = shift(nbr_ok, dy, dx, False)
        d2m = torch.where(ok, d2, inf)
        better = d2m < best_d        # strict <: first minimum wins
        best_d = torch.where(better, d2m, best_d)
        new_seg = torch.where(better, nbr_seg, new_seg)

    elim = single & torch.isfinite(best_d)
    seg_out = torch.where(elim, new_seg, seg)
    return seg_out, single & ~elim, nbr_ok | elim, elim.sum()


def _distance_fields(planes, offsets):
    """Per-offset squared spectral distance (float32) to the shifted
    neighbour, bands added in order. They depend only on pixel values, so
    they are computed once for all passes."""
    d2s = []
    for dy, dx in offsets:
        d2 = torch.zeros(planes[0].shape, dtype=torch.float32,
                         device=planes[0].device)
        for plane in planes:
            diff = plane - shift(plane, dy, dx, 0.0)
            d2 = d2 + diff * diff
        d2s.append(d2)
    return d2s


def _singleton_masks_from_image(seg, four_connected: bool):
    """
    The initial ``single`` and ``nbr_ok`` masks from neighbour shifts
    alone: a pixel of a labelled CONNECTED component has component size
    > 1 iff a connectivity neighbour carries the same label (true for
    clump output). The null "segment" (label 0) is not a component: its
    size is the global null-pixel count, so a lone null pixel IS a
    singleton and a larger null segment IS an eligible target (the
    reference checks segSize without a null test).
    """
    has_same = None
    for dy, dx in offsets_for(four_connected):
        same = shift(seg, dy, dx, -1) == seg     # -1 matches no label
        has_same = same if has_same is None else (has_same | same)
    is_null = seg == 0
    null_count = is_null.sum()
    single = torch.where(is_null, null_count == 1, ~has_same)
    nbr_ok = torch.where(is_null, null_count > 1, has_same)
    return single, nbr_ok


def eliminate_single_pixels_device(img_f, seg, seg_size,
                                   four_connected: bool,
                                   return_sizes: bool = False,
                                   do_relabel: bool = True,
                                   capacity: int = None):
    """
    Merge passes to the fixpoint, then the contiguous relabel (the
    reference's eliminateSinglePixels, shepseg.py:572-615).
    ``img_f`` is a float32 (nBands, H, W) tensor or a tuple of (H, W)
    planes; ``seg`` int32 (H, W).

    Returns (seg, total pixels eliminated, passes); with
    ``return_sizes=True`` also the (relabelled) segment sizes.

    ``do_relabel=False`` skips the relabel and returns gappy IDs. Callers
    that feed the result into small-segment elimination may do so: the
    contiguous relabel is a monotone ID remap, small-segment elimination
    consults IDs only for smallest-ID tie-breaks (preserved by monotone
    maps), empty segments are never candidates nor targets, and its own
    final relabel composes to the same contiguous result.

    ``seg_size=None``: derive the initial masks from neighbour shifts
    (sound for clump output); ``capacity`` must then be given when sizes
    are needed.
    """
    planes = band_planes(img_f)
    offsets = offsets_for(four_connected)
    d2s = _distance_fields(planes, offsets)

    if seg_size is None:
        single, nbr_ok = _singleton_masks_from_image(seg, four_connected)
    else:
        capacity = seg_size.shape[0]
        sizes_at = seg_size[seg.long()]
        single = sizes_at == 1
        nbr_ok = sizes_at > 1

    total = 0
    passes = 0
    while True:
        seg, single, nbr_ok, n = _one_pass(d2s, offsets, seg, single, nbr_ok)
        n = to_host(n)
        total += n
        passes += 1
        if n == 0:
            break

    if not (do_relabel or return_sizes):
        return seg, total, passes
    seg_size = seg_sizes(seg, capacity)
    if do_relabel:
        sub = relabel_subtract(seg_size, MINSEGID)
        seg = (seg - sub[seg.long()]).to(seg.dtype)
        if return_sizes:
            # IDs only move down and never collide (id - sub[id] is
            # injective on non-empty ids)
            ids = torch.arange(capacity, device=seg.device)
            new_ids = torch.where(seg_size > 0, ids - sub, capacity)
            seg_size = torch.zeros(capacity + 1, dtype=seg_size.dtype,
                                   device=seg.device).index_put_(
                (new_ids,), seg_size)[:capacity]
    if return_sizes:
        return seg, total, passes, seg_size
    return seg, total, passes


def eliminateSinglePixels(img, seg, segSize, minSegId=MINSEGID,
                          maxSegId=None, fourConnected=True, device="cuda"):
    """
    Host API matching the reference signature (reference: shepseg.py:572).
    Modifies ``seg`` (numpy) in place; ``segSize`` becomes stale, as in the
    reference. ``minSegId`` sets the base of the final relabel;
    ``maxSegId`` only sized a scratch buffer there and is unused here.
    Returns the number of pixels eliminated.
    """
    device = _kernels.torch_device(device)
    seg_t = torch.from_numpy(np.asarray(seg).astype(np.int32)).to(device)
    img_f = image_tensor(img, device).to(torch.float32)
    size_t = torch.from_numpy(np.asarray(segSize).astype(np.int64)).to(device)
    seg_out, total, _, sizes = eliminate_single_pixels_device(
        img_f, seg_t, size_t, bool(fourConnected), do_relabel=False,
        return_sizes=True)
    sub = relabel_subtract(sizes, int(minSegId))
    seg_out = seg_out - sub[seg_out.long()]
    seg[...] = seg_out.cpu().numpy().astype(SegIdType)
    return int(total)
