"""
Device-resident segmentation of one tile, and of a batch of tiles
(counterpart: pyshepseg_tpu/parallel/pipeline.py).

``shepseg.doShepherdSegmentation`` fits k-means, runs the pipeline and
copies the segment image to the host. :func:`segment_tile` is the middle of
that alone: cluster assignment -> connected-component clumping ->
single-pixel elimination -> small-segment elimination -> relabel on
tensors that lie on a device already, returning tensors on that device
(``shepseg.segment_on_device`` is the one body both run). It is the unit
of work the CONC_MESH backend gives each device, and the single-device
answer the row-sharded pipeline (parallel/shardmap_seg) is held against.

The JAX package compiles the tile into one XLA program with static
capacities; here the stages are the port's ops in sequence, their
data-dependent loops decided on the host, and kernels K1 (ops/local_ccl)
and K2 (ops/lut) run inside them on a CUDA device. The ``capacity`` and
``e_cap`` arguments, which pad XLA's arrays, are accepted and ignored. The
JAX package's ``cluster_clump_edges_tiles``, ``eliminate_tiles_fused`` and
``segment_tiles_one_shot`` exist to measure and speculate those capacity
buckets and have no counterpart: the fused flow they implement (the graph
loop on the clump image's edges, seeded with the singleton remap) is what
``segment_on_device`` runs.
"""

import torch

from .. import shepseg
from ..ops.constants import SEGNULLVAL, MINSEGID
from ..ops.kmeans import assign_clusters  # noqa: F401  (re-export)
from ..ops.clump import clump_labels
from ..ops.segreduce import (seg_sizes_and_spectral_sums_planes,
                             band_planes, image_tensor)
from ..ops.elim_single import eliminate_single_pixels_device
from ..ops.elim_small import (edge_sort_keys, compact_edges,
                              eliminate_small_segments_graph,
                              _remap_and_relabel)
from ..ops.sync import to_host


def _number(x):
    """A Python number from a number, a numpy scalar or a 0-dim tensor."""
    return x.item() if hasattr(x, "item") else x


def segment_tile(img, centers, img_null_val, max_spectral_diff,
                 min_seg_size: int, four_connected: bool, has_null: bool,
                 capacity=None, clump_two_level=None):
    """
    The full Shepherd pipeline on one tile, on the device ``img`` lies on.

    Parameters
    ----------
    img : tensor (nBands, H, W), any numeric dtype (the null comparison
        runs on the native values; spectral arithmetic casts to float32)
    centers : tensor (K, nBands) float32 fitted cluster centres, same device
    img_null_val : number of the image's type (ignored when has_null is
        False)
    max_spectral_diff : number (resolve 'auto' on the host with
        shepseg.autoMaxSpectralDiff before calling)
    capacity : accepted and ignored (XLA's static segment capacity)
    clump_two_level : as ops.clump.clump_labels' ``two_level``

    Returns (seg int32 tensor (H, W), maxSegId 0-dim tensor), both on
    ``img``'s device: the segment image is not copied to the host.
    """
    seg, info = shepseg.segment_on_device(
        image_tensor(img, img.device), centers, _number(img_null_val),
        bool(has_null), _number(max_spectral_diff), int(min_seg_size),
        bool(four_connected), clump_two_level=clump_two_level)
    return seg, info["maxSegId"]


# the JAX package's jitted alias; there is nothing to compile here
segment_tile_jit = segment_tile


def default_capacity(h: int, w: int) -> int:
    """Safe segment capacity for a tile of the given shape (every pixel a
    segment, plus the null id). The port's ops size their tables from the
    data, so nothing needs it; kept for callers of the JAX package."""
    return h * w + 1


def segment_tiles_vmapped(imgs, centers, img_null_val, max_spectral_diff,
                          min_seg_size: int, four_connected: bool,
                          has_null: bool, capacity=None):
    """
    A batch of tiles (B, nBands, H, W) through :func:`segment_tile`, one
    after the other: ``torch.vmap`` cannot batch the pipeline's
    data-dependent loops. The clump stage keeps its default (the two-level
    merge); the JAX package forces the global sweeps under vmap only
    because ``lax.cond`` runs both branches there, and the labels are the
    same either way.

    Returns (segs int32 (B, H, W), maxSegIds (B,)), on the tiles' device.
    """
    out = [segment_tile(img, centers, img_null_val, max_spectral_diff,
                        min_seg_size, four_connected, has_null)
           for img in imgs]
    return (torch.stack([seg for seg, _ in out]),
            torch.stack([n for _, n in out]))


# --------------------------------------------------------------------
# The three-step decomposition of the batch: the JAX package's CONC_MESH
# measured path (cluster + clump, a sync for the segment capacity, single
# pixels + sizes + edges, a sync for the edge capacity, graph elimination
# + relabel). Here each step is a loop over the batch of the same ops
# segment_tile runs, with the unfused edge flow: the edges come from the
# image after single-pixel elimination and the graph loop starts from the
# identity remap. The result equals segment_tile's.
# --------------------------------------------------------------------


def cluster_clump_tiles(imgs, centers, img_null_val,
                        four_connected: bool, has_null: bool):
    """
    Step 1: cluster assignment + clumping for a batch of tiles
    (B, nBands, H, W). Returns (segs int32 (B, H, W), clump counts (B,)
    int64, sweep counts (B,) int64), tensors on the tiles' device.
    """
    segs, counts, sweeps = [], [], []
    for img in imgs:
        clusters = assign_clusters(image_tensor(img, img.device), centers,
                                   _number(img_null_val), bool(has_null))
        seg, count, nsweeps = clump_labels(
            clusters, SEGNULLVAL, four_connected=bool(four_connected))
        segs.append(seg)
        counts.append(count)
        sweeps.append(nsweeps)
    dev = segs[0].device
    return (torch.stack(segs), torch.tensor(counts, device=dev),
            torch.tensor(sweeps, device=dev))


def eliminate_tiles_phase1(imgs, segs, four_connected: bool,
                           capacity=None):
    """
    Step 2: single-pixel elimination + per-segment sizes and spectral sums
    + sorted adjacency edge keys, per tile.

    Returns (segs (B, H, W), sizes (B, cap) int64, spects (B, cap, nB),
    a, b, first, scalars (B, 2) = [nSegsAfterSingle, nUniqueEdges]).
    ``cap`` is ``capacity`` where given, else the batch's largest clump id
    + 1 (one host sync): every tile's tables are padded with empty ids to
    it, which no later step reads as segments. ``a``, ``b`` and ``first``
    are lists of B tensors, one per tile, of that tile's number of
    adjacent pixel pairs (they are not padded).
    """
    if capacity is None:
        capacity = max(to_host(torch.stack(
            [seg.max() for seg in segs]))) + 1
    out_segs, sizes, spects, a_l, b_l, first_l, scalars = (
        [], [], [], [], [], [], [])
    for img, seg in zip(imgs, segs):
        img_dev = image_tensor(img, img.device)
        seg, _, _ = eliminate_single_pixels_device(
            img_dev.to(torch.float32), seg, None, bool(four_connected),
            do_relabel=False)
        size, spect = seg_sizes_and_spectral_sums_planes(
            seg, band_planes(img_dev), capacity)
        a, b, first, n_unique = edge_sort_keys(seg, bool(four_connected))
        out_segs.append(seg)
        sizes.append(size)
        spects.append(spect)
        a_l.append(a)
        b_l.append(b)
        first_l.append(first)
        scalars.append(torch.stack(
            [torch.count_nonzero(size[MINSEGID:]), n_unique]))
    return (torch.stack(out_segs), torch.stack(sizes), torch.stack(spects),
            a_l, b_l, first_l, torch.stack(scalars))


def eliminate_tiles_phase2(segs, sizes, spects, a, b, first,
                           max_spectral_diff, min_seg_size: int,
                           e_cap=None):
    """
    Step 3: small-segment elimination in graph space + the final relabel,
    per tile, on step 2's outputs (``e_cap`` accepted and ignored).
    Returns (segs int32 (B, H, W), maxSegIds (B,)).
    """
    out_segs, max_ids = [], []
    for seg, size, spect, aa, bb, ff in zip(segs, sizes, spects, a, b,
                                            first):
        ea, eb = compact_edges(aa, bb, ff)
        remap, size_out, _, _ = eliminate_small_segments_graph(
            ea, eb, size, spect, int(min_seg_size),
            _number(max_spectral_diff))
        out_segs.append(_remap_and_relabel(seg, remap, size_out))
        max_ids.append(torch.count_nonzero(size_out[MINSEGID:]))
    return torch.stack(out_segs), torch.stack(max_ids)
