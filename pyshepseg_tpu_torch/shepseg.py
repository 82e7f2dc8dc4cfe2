"""
Core in-memory segmentation engine (counterpart: pyshepseg_tpu/shepseg.py).

The Shepherd et al (2019) iterative-elimination segmentation:
``doShepherdSegmentation`` runs k-means spectral clustering ->
connected-component clumping -> single-pixel elimination -> small-segment
elimination -> relabel, each stage as PyTorch tensor code on one device,
with the two hand-written CUDA kernels (ops/local_ccl.py, ops/lut.py) on
the card.

Segment ID numbers start from 1; zero is the null segment ID.
"""

import time

import numpy as np
import torch

from . import _kernels
from .ops.constants import SegIdType, SEGNULLVAL, MINSEGID  # noqa: F401
from .ops.clump import clump, clump_labels  # noqa: F401
from .ops.segreduce import (  # noqa: F401
    makeSegSize, buildSegmentSpectra, relabelSegments, seg_sizes,
    seg_spectral_sums, seg_spectral_sums_planes,
    seg_sizes_and_spectral_sums_planes, band_planes, image_tensor)
from .ops.elim_single import (  # noqa: F401
    eliminateSinglePixels, eliminate_single_pixels_device)
from .ops.elim_small import (  # noqa: F401
    eliminateSmallSegments, eliminate_small_segments_device, round_capacity,
    edge_sort_keys, compact_edges, eliminate_small_segments_graph,
    _remap_and_relabel)
from .ops.kmeans import (  # noqa: F401
    TorchKMeans, kmeansFromReference, assign_clusters, predict_labels,
    null_scalar)
from .ops.sync import to_host


class SegmentationResult(object):
    """
    Results of the segmentation process
    (reference: pyshepseg/shepseg.py:104-127).

    Attributes
    ----------
    segimg : numpy array (nRows, nCols) of uint32
        Elements are segment ID numbers (starting from 1)
    kmeans : TorchKMeans (or any object with cluster_centers_)
        Fitted clustering object
    maxSpectralDiff : float
        The value used to limit segment merging
    singlePixelsEliminated : int
        Number of single pixels merged into adjacent segments
    smallSegmentsEliminated : int
        Number of small segments merged into adjacent segments
    clumpSweeps : int
        Diagnostic (not in the reference): global label-propagation sweeps
        the clump fixpoint took
    elimPasses : int
        Diagnostic: find+apply passes the elimination graph loop executed
        across all target sizes
    """

    def __init__(self):
        self.segimg = None
        self.kmeans = None
        self.maxSpectralDiff = None
        self.singlePixelsEliminated = None
        self.smallSegmentsEliminated = None
        self.clumpSweeps = None
        self.elimPasses = None


def doShepherdSegmentation(img, numClusters=60, clusterSubsamplePcnt=1,
        minSegmentSize=50, maxSpectralDiff='auto', imgNullVal=None,
        fourConnected=True, verbose=False, fixedKMeansInit=False,
        kmeansObj=None, spectDistPcntile=50, device="cuda"):
    """
    Perform Shepherd segmentation in memory on the given multi-band img
    array of shape (nBands, nRows, nCols)
    (reference: pyshepseg/shepseg.py:130-249 — same parameters, same
    semantics), on ``device``.

    ``device`` defaults to "cuda" and raises when CUDA is absent; pass
    "cpu" to run the plain versions of the kernels on the CPU. An ``img``
    that is a ``torch.Tensor`` is used on its own device. If no fitted
    ``kmeansObj`` is supplied with a tensor image, the image is copied to
    the host once for the k-means fit.

    Returns a SegmentationResult. Segment IDs start from 1; 0 is null.
    """
    t0 = time.time()
    if isinstance(img, torch.Tensor):
        device = img.device
        img_np = None if kmeansObj is not None else img.cpu().numpy()
        np_dtype = torch.empty((), dtype=img.dtype).numpy().dtype
    else:
        img = img_np = np.ascontiguousarray(img)
        np_dtype = img.dtype
    device = _kernels.torch_device(device)
    img_dev = image_tensor(img, device)
    if kmeansObj is not None:
        km = kmeansObj
    else:
        km = fitSpectralClusters(img_np, numClusters, clusterSubsamplePcnt,
                                 imgNullVal, fixedKMeansInit, device=device)
    centers = torch.tensor(np.asarray(km.cluster_centers_,
                                      dtype=np.float32), device=device)
    hasNull = imgNullVal is not None
    nullVal = null_scalar(imgNullVal if hasNull else 0, np_dtype)
    maxSpectralDiff = autoMaxSpectralDiff(km, maxSpectralDiff,
                                          spectDistPcntile)

    # cluster and clump (the JAX package's _cluster_and_clump_device)
    clusters = assign_clusters(img_dev, centers, nullVal, hasNull)
    seg_clump, maxSegId, clumpSweeps = clump_labels(
        clusters, SEGNULLVAL, four_connected=bool(fourConnected))
    if verbose:
        print("Kmeans plus clump found", maxSegId, "clumps, in",
              round(time.time() - t0, 1), "seconds,", clumpSweeps,
              "propagation sweeps")

    # the JAX package's _elim_fused_device, as sequential calls
    t0 = time.time()
    capacity = maxSegId + 1
    img_f = img_dev.to(torch.float32)
    seg, _, _ = eliminate_single_pixels_device(
        img_f, seg_clump, None, bool(fourConnected), do_relabel=False)
    planes = band_planes(img_dev)
    size, spect = seg_sizes_and_spectral_sums_planes(seg, planes, capacity)
    nAfterSingle = to_host(torch.count_nonzero(size[MINSEGID:]))
    numElimSmall, elimPasses = 0, 0
    if minSegmentSize > 1:
        # The graph loop runs on the CLUMP image's edges, seeded with the
        # clump -> post-single-pixel id map: single-pixel merges only
        # contract the adjacency graph, and contracted duplicate pairs
        # are harmless (a pass min-reduces per pair). Every pixel of a
        # clump carries the same new id, so a scatter builds the map.
        a, b, first, _ = edge_sort_keys(seg_clump, bool(fourConnected))
        ea, eb = compact_edges(a, b, first)
        remap0 = torch.arange(capacity, device=device).scatter_(
            0, seg_clump.reshape(-1).long(), seg.reshape(-1).long())
        remap, size, numElimSmall, elimPasses = (
            eliminate_small_segments_graph(
                ea, eb, size, spect, int(minSegmentSize), maxSpectralDiff,
                remap_init=remap0))
        seg = _remap_and_relabel(seg, remap, size)
    else:
        seg = _remap_and_relabel(
            seg, torch.arange(capacity, device=device), size)
    # int32 ids are non-negative: reinterpret, no host copy
    segimg = seg.to(torch.int32).cpu().numpy().view(SegIdType)
    numElimSinglepix = maxSegId - int(nAfterSingle)
    if verbose:
        print("Eliminated", numElimSinglepix, "single pixels and",
              numElimSmall, "small segments in", elimPasses,
              "graph passes, in", round(time.time() - t0, 1), "seconds")
        print("Final result has", int(segimg.max()) if segimg.size else 0,
              "segments")

    segResult = SegmentationResult()
    segResult.segimg = segimg
    segResult.kmeans = km
    segResult.maxSpectralDiff = maxSpectralDiff
    segResult.singlePixelsEliminated = numElimSinglepix
    segResult.smallSegmentsEliminated = int(numElimSmall)
    segResult.clumpSweeps = int(clumpSweeps)
    segResult.elimPasses = int(elimPasses)
    return segResult


def fitSpectralClusters(img, numClusters, subsamplePcnt, imgNullVal,
        fixedKMeansInit, device="cuda"):
    """
    Fit the k-means spectral clustering stage on a subsample of the image
    (reference: pyshepseg/shepseg.py:252-314 — same sampling rule: drop
    null pixels, then stride-subsample with skip=round(100/pcnt)).

    Returns a fitted TorchKMeans.
    """
    (nBands, nRows, nCols) = img.shape
    xFull = np.transpose(img, axes=(1, 2, 0)).reshape(
        (nRows * nCols, nBands))

    if imgNullVal is not None:
        nonNull = (xFull != imgNullVal).all(axis=1)
        xNonNull = xFull[nonNull]
        del nonNull
    else:
        xNonNull = xFull
    skip = int(round(100. / subsamplePcnt))
    xSample = xNonNull[::skip]
    del xFull, xNonNull

    numKmeansTrials = 5
    init = 'k-means++'
    if fixedKMeansInit:
        init = diagonalClusterCentres(xSample, numClusters)
        numKmeansTrials = 1
    km = TorchKMeans(n_clusters=numClusters, n_init=numKmeansTrials,
                     init=init, device=device)
    km.fit(xSample)
    return km


def applySpectralClusters(kmeansObj, img, imgNullVal, device="cuda"):
    """
    Predict spectral clusters for every pixel
    (reference: pyshepseg/shepseg.py:317-361). Cluster IDs start from 1;
    pixels with imgNullVal in any band become SEGNULLVAL. Accepts any
    object with ``cluster_centers_``.
    """
    device = _kernels.torch_device(device)
    img = np.ascontiguousarray(img)
    centers = torch.tensor(np.asarray(kmeansObj.cluster_centers_,
                                      dtype=np.float32), device=device)
    hasNull = imgNullVal is not None
    nullVal = null_scalar(imgNullVal if hasNull else 0, img.dtype)
    clusters = assign_clusters(image_tensor(img, device), centers, nullVal,
                               hasNull)
    return clusters.cpu().numpy().astype(SegIdType)


def diagonalClusterCentres(xSample, numClusters):
    """
    Deterministic initial cluster centres, evenly spaced along the diagonal
    of the data bounding box, end points one step in from the corners
    (reference: pyshepseg/shepseg.py:364-397 — including the reference's
    behaviour of keeping the sample's integer dtype, which truncates).
    """
    (numPoints, numBands) = xSample.shape
    bandMin = xSample.min(axis=0)
    bandMax = xSample.max(axis=0)

    centres = np.empty((numClusters, numBands), dtype=xSample.dtype)
    step = (bandMax - bandMin) / (numClusters + 1)
    for i in range(numClusters):
        centres[i] = bandMin + (i + 1) * step

    return centres


def autoMaxSpectralDiff(km, maxSpectralDiff, distPcntile):
    """
    Resolve the maxSpectralDiff setting
    (reference: pyshepseg/shepseg.py:400-449): 'auto' -> the given
    percentile of pairwise distances between cluster centres; None ->
    10x the largest distance (effectively unbounded); else pass through.
    """
    centres = np.asarray(km.cluster_centers_, dtype=np.float64)
    numClusters = centres.shape[0]
    iu = np.triu_indices(numClusters, k=1)
    diffs = centres[iu[0]] - centres[iu[1]]
    clusterDist = np.sqrt((diffs ** 2).sum(axis=1)).astype(np.float32)

    if isinstance(maxSpectralDiff, str) and maxSpectralDiff == 'auto':
        maxSpectralDiff = np.percentile(clusterDist, distPcntile)
    elif maxSpectralDiff is None:
        maxSpectralDiff = 10 * clusterDist.max()

    return maxSpectralDiff
