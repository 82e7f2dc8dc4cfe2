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
from . import timinghooks
from .ops.constants import SegIdType, SEGNULLVAL, MINSEGID  # noqa: F401
from .ops.clump import clump, clump_labels  # noqa: F401
from .ops.segreduce import (  # noqa: F401
    makeSegSize, buildSegmentSpectra, relabelSegments,
    makeSegmentLocations, SegmentLocations, seg_sizes,
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
from .ops.segreduce import count_elements, seg_spectral_sums_tile
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
        the clump fixpoint took; 0 when the two-level merge's answer stood
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


def segment_on_device(img_dev, centers, nullVal, hasNull, maxSpectralDiff,
                      minSegmentSize, fourConnected, clump_two_level=None):
    """
    The device-resident body of the segmentation: cluster assignment ->
    clumping -> single-pixel elimination -> small-segment elimination ->
    contiguous relabel, on the device ``img_dev`` lies on, with no copy of
    an image to the host. ``img_dev`` is the (nBands, H, W) tensor
    :func:`image_tensor` gives, ``centers`` the (K, nBands) float32 cluster
    centres on the same device, ``nullVal`` the null value as a number of
    the image's own type (unused when ``hasNull`` is False) and
    ``maxSpectralDiff`` a resolved number (:func:`autoMaxSpectralDiff`).
    Each stage is a ``shepseg.<stage>`` span (timinghooks).

    :func:`doShepherdSegmentation` is the k-means fit, this function and
    the download of its result; ``parallel.pipeline.segment_tile`` is this
    function alone.

    Returns (seg int32 tensor (H, W), ids 1..maxSegId in scan order and 0
    for null, and a dict: ``maxSegId`` (a 0-dim tensor on the device),
    ``numClumps``, ``clumpSweeps``, ``numAfterSingle``, ``numElimSmall``
    and ``elimPasses`` (Python ints)).
    """
    device = img_dev.device
    # cluster and clump (the JAX package's _cluster_and_clump_device)
    with timinghooks.span("shepseg.assign"):
        clusters = assign_clusters(img_dev, centers, nullVal, hasNull)
    with timinghooks.span("shepseg.clump"):
        seg_clump, numClumps, clumpSweeps = clump_labels(
            clusters, SEGNULLVAL, four_connected=fourConnected,
            two_level=clump_two_level)

    # the JAX package's _elim_fused_device, as sequential calls
    capacity = numClumps + 1
    with timinghooks.span("shepseg.single_pixels"):
        img_f = img_dev.to(torch.float32)
        seg, _, _ = eliminate_single_pixels_device(
            img_f, seg_clump, None, fourConnected, do_relabel=False)
    with timinghooks.span("shepseg.sums"):
        planes = band_planes(img_dev)
        size = seg_sizes(seg, capacity)
        spect = seg_spectral_sums_tile(seg, planes, capacity)
        nAfterSingle, nNull = to_host(torch.stack(
            [torch.count_nonzero(size[MINSEGID:]), size[SEGNULLVAL]]))
        if spect.is_cuda and spect.is_floating_point():
            # K4 summed every pixel but the null segment's
            count_elements(seg.numel() - nNull, spect.shape[1], capacity)
    numElimSmall, elimPasses = 0, 0
    remap = torch.arange(capacity, device=device)
    if minSegmentSize > 1:
        # The graph loop runs on the CLUMP image's edges, seeded with the
        # clump -> post-single-pixel id map: single-pixel merges only
        # contract the adjacency graph, and contracted duplicate pairs
        # are harmless (a pass min-reduces per pair). Every pixel of a
        # clump carries the same new id, so a scatter builds the map.
        with timinghooks.span("shepseg.edges"):
            a, b, first, _ = edge_sort_keys(seg_clump, fourConnected)
            ea, eb = compact_edges(a, b, first)
            remap0 = remap.scatter_(
                0, seg_clump.reshape(-1).long(), seg.reshape(-1).long())
        remap, size, numElimSmall, elimPasses = (
            eliminate_small_segments_graph(
                ea, eb, size, spect, minSegmentSize, maxSpectralDiff,
                remap_init=remap0))
    with timinghooks.span("shepseg.relabel"):
        seg = _remap_and_relabel(seg, remap, size)
    info = dict(maxSegId=torch.count_nonzero(size[MINSEGID:]),
                numClumps=int(numClumps), clumpSweeps=int(clumpSweeps),
                numAfterSingle=int(nAfterSingle),
                numElimSmall=int(numElimSmall), elimPasses=int(elimPasses))
    return seg, info


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

    The call is a ``shepseg.call`` span (timinghooks) whose unit of work
    is an enclosing unit's (a tile's) or the call's own number.

    Returns a SegmentationResult. Segment IDs start from 1; 0 is null.
    """
    with timinghooks.unit(), timinghooks.span("shepseg.call"):
        t0 = time.perf_counter()
        if isinstance(img, torch.Tensor):
            device = img.device
            img_np = None if kmeansObj is not None else img.cpu().numpy()
            np_dtype = torch.empty((), dtype=img.dtype).numpy().dtype
        else:
            img = img_np = np.ascontiguousarray(img)
            np_dtype = img.dtype
        device = _kernels.torch_device(device)
        with timinghooks.span("shepseg.upload"):
            img_dev = image_tensor(img, device)
        if kmeansObj is not None:
            km = kmeansObj
        else:
            km = fitSpectralClusters(img_np, numClusters,
                                     clusterSubsamplePcnt, imgNullVal,
                                     fixedKMeansInit, device=device)
        centers = torch.tensor(np.asarray(km.cluster_centers_,
                                          dtype=np.float32), device=device)
        hasNull = imgNullVal is not None
        nullVal = null_scalar(imgNullVal if hasNull else 0, np_dtype)
        maxSpectralDiff = autoMaxSpectralDiff(km, maxSpectralDiff,
                                              spectDistPcntile)
        tFit = time.perf_counter()

        seg, info = segment_on_device(
            img_dev, centers, nullVal, hasNull, maxSpectralDiff,
            int(minSegmentSize), bool(fourConnected))
        maxSegId, clumpSweeps = info["numClumps"], info["clumpSweeps"]
        numElimSmall, elimPasses = info["numElimSmall"], info["elimPasses"]
        # int32 ids are non-negative: reinterpret, no host copy
        with timinghooks.span("shepseg.download"):
            segimg = seg.to(torch.int32).cpu().numpy().view(SegIdType)
        numElimSinglepix = maxSegId - info["numAfterSingle"]
        if verbose:
            print("Kmeans found", len(km.cluster_centers_), "centres, in",
                  round(tFit - t0, 1), "seconds; clump found", maxSegId,
                  "clumps,", clumpSweeps, "propagation sweeps")
            print("Eliminated", numElimSinglepix, "single pixels and",
                  numElimSmall, "small segments in", elimPasses,
                  "graph passes; clump and eliminations in",
                  round(time.perf_counter() - tFit, 1), "seconds")
            print("Final result has",
                  int(segimg.max()) if segimg.size else 0, "segments")

    segResult = SegmentationResult()
    segResult.segimg = segimg
    segResult.kmeans = km
    segResult.maxSpectralDiff = maxSpectralDiff
    segResult.singlePixelsEliminated = numElimSinglepix
    segResult.smallSegmentsEliminated = int(numElimSmall)
    segResult.clumpSweeps = int(clumpSweeps)
    segResult.elimPasses = int(elimPasses)
    return segResult


def _elapsed(fn, device):
    """Seconds taken by ``fn()``: CUDA events around it on a CUDA device
    (recorded on the current stream and waited for), time.perf_counter
    elsewhere."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0
    stream = torch.cuda.current_stream(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record(stream)
    fn()
    end.record(stream)
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def _warmSegmentation(img, kmeansObj, maxSpectralDiff, minSegmentSize,
                      fourConnected, imgNullVal, device):
    """(device, run): the image placed on ``device`` in its own dtype, and
    a call of doShepherdSegmentation on it with the fitted ``kmeansObj``,
    run once so that the kernels are built and the caches warm."""
    device = _kernels.torch_device(device)
    img_dev = torch.from_numpy(np.ascontiguousarray(img)).to(device)

    def run():
        return doShepherdSegmentation(
            img_dev, minSegmentSize=minSegmentSize,
            maxSpectralDiff=maxSpectralDiff, imgNullVal=imgNullVal,
            fourConnected=fourConnected, kmeansObj=kmeansObj, device=device)

    run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return device, run


def deviceResidentThroughput(img, kmeansObj, maxSpectralDiff,
                             minSegmentSize=50, fourConnected=True,
                             imgNullVal=None, repeats=3, device="cuda"):
    """
    Throughput (Mpix/s) of the warm segmentation pipeline, the best of
    ``repeats`` calls: the image is placed on ``device`` and the k-means
    model fitted before timing starts, so the figure excludes the image's
    upload and the clustering fit (counterpart:
    pyshepseg_tpu.shepseg.deviceResidentThroughput, same signature plus
    ``device``). Each timed call is one doShepherdSegmentation, timed with
    CUDA events on the card and time.perf_counter elsewhere. It includes
    the call's own host syncs (the graph loop decides on the host after
    every pass) and the copy of the segment image back to the host, which
    doShepherdSegmentation returns as numpy; the JAX package's figure
    times one speculative dispatch and a scalar fetch instead, and none of
    its capacity-bucket or one-shot logic exists here.
    """
    h, w = np.shape(img)[1:]
    device, run = _warmSegmentation(img, kmeansObj, maxSpectralDiff,
                                    minSegmentSize, fourConnected,
                                    imgNullVal, device)
    best = min(_elapsed(run, device) for _ in range(repeats))
    return (h * w / 1e6) / best


def deviceOnlySeconds(img, kmeansObj, maxSpectralDiff, minSegmentSize=50,
                      fourConnected=True, imgNullVal=None, k=8,
                      repeats=3, device="cuda"):
    """
    Seconds per warm segmentation run, with one sync round trip taken out
    (counterpart: pyshepseg_tpu.shepseg.deviceOnlySeconds, same signature
    plus ``device``). ``k`` doShepherdSegmentation calls on the image
    placed on ``device`` run back to back, timed as one window (CUDA
    events on the card, time.perf_counter elsewhere); the best of
    ``repeats`` windows, less the sync round trip, over ``k``.

    Unlike the JAX package's single dispatch, the port's call has host
    syncs inside it (the graph loop's passes), so the device does NOT run
    the ``k`` calls without a sync between them: the figure is the warm
    call's wall per run, the copy of its segment image to the host
    included. The sync round trip is the best of 5 launches of a tiny
    kernel followed by a synchronize.

    Returns (device_seconds_per_run, sync_rtt_seconds).
    """
    device, run = _warmSegmentation(img, kmeansObj, maxSpectralDiff,
                                    minSegmentSize, fourConnected,
                                    imgNullVal, device)
    tiny = torch.zeros((8, 128), dtype=torch.float32, device=device)

    def bump():
        tiny.add_(1.0)
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    bump()
    rtts = []
    for _ in range(5):
        t0 = time.perf_counter()
        bump()
        rtts.append(time.perf_counter() - t0)
    rtt = min(rtts)

    def window():
        for _ in range(k):
            run()

    best = min(_elapsed(window, device) for _ in range(repeats))
    return max(best - rtt, 0.0) / k, rtt


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


# ---------------------------------- reference kernel compat layer
#
# The in-memory engine above runs the whole pipeline device-resident, but
# the reference also exposes its individual elimination kernels as public
# API (reference: shepseg.py:618-736, 816-877, 1003-1123). These are
# faithful host-side equivalents on numpy arrays, for callers that drove
# the reference kernels directly. They preserve the reference's scan
# order and tie-breaks exactly (sequential greedy semantics), so they
# are per-call faithful but not device-accelerated — the public
# eliminateSinglePixels / eliminateSmallSegments drivers are the fast
# path.


class RowColArray:
    """
    Fixed-capacity list of (row, col) pixel coordinates for one segment
    (reference RowColArray jitclass: shepseg.py:816-877).
    """

    __slots__ = ('rowcols', 'idx')

    def __init__(self, length):
        self.rowcols = np.empty((int(length), 2), dtype=np.uint32)
        self.idx = 0

    def append(self, row, col):
        self.rowcols[self.idx, 0] = row
        self.rowcols[self.idx, 1] = col
        self.idx += 1

    def getSegmentIndices(self):
        """(rows, cols) arrays, usable as a fancy index into the image."""
        return (self.rowcols[:self.idx, 0], self.rowcols[:self.idx, 1])


def makeSegmentLocationsDict(seg, segSize):
    """
    Reference-style dictionary of segment ID -> :class:`RowColArray`
    holding each segment's pixel coordinates in row-major scan order
    (reference: shepseg.py:880-915 — a numba typed Dict there). The
    framework's own :func:`makeSegmentLocations` builds the CSR
    equivalent; use this dict form with :func:`findMergeSegment` /
    :func:`doMerge`, which mutate it.
    """
    seg = np.asarray(seg)
    flat = seg.ravel()
    order = np.argsort(flat, kind='stable')
    sortedIds = flat[order]
    w = seg.shape[1]
    ids, startIdx = np.unique(sortedIds, return_index=True)
    startIdx = np.append(startIdx, len(flat))
    d = {}
    for i, s in enumerate(ids.tolist()):
        if s == SEGNULLVAL:
            continue
        sl = order[startIdx[i]:startIdx[i + 1]]
        rca = RowColArray(len(sl))
        rca.rowcols[:, 0] = sl // w
        rca.rowcols[:, 1] = sl % w
        rca.idx = len(sl)
        d[s] = rca
    return d


def findNearestNeighbourPixel(img, seg, i, j, segSize, fourConnected):
    """
    The (row, col) of the spectrally-nearest 3x3 neighbour of pixel
    (i, j) that belongs to a segment of size > 1, or (-1, -1)
    (reference: shepseg.py:677-736 — same scan order and strict-<
    tie-break).

    Documented deviation (PARITY.md): distances are computed in
    float64. The reference's numba kernel subtracts in the IMAGE's
    dtype, so unsigned imagery wraps (uint8 0 - 255 -> 1) and can pick
    a spectrally-distant neighbour; here the true distance is used.
    Signed or float imagery is unaffected.
    """
    (nBands, nRows, nCols) = img.shape
    minDsqr = -1.0
    ii = jj = -1
    centre = img[:, i, j].astype(np.float64)
    for iii in range(max(i - 1, 0), min(i + 1, nRows - 1) + 1):
        for jjj in range(max(j - 1, 0), min(j + 1, nCols - 1) + 1):
            connected = (not fourConnected) or (iii == i) or (jjj == j)
            if connected and segSize[seg[iii, jjj]] > 1:
                dSqr = ((centre - img[:, iii, jjj]) ** 2).sum()
                if minDsqr < 0 or dSqr < minDsqr:
                    minDsqr = dSqr
                    ii, jj = iii, jjj
    return (ii, jj)


def mergeSinglePixels(img, seg, segSize, segToElim, fourConnected):
    """
    One find-all-then-apply pass merging single-pixel segments into
    their spectrally-nearest neighbour of size > 1; modifies seg and
    segSize in place and returns the number eliminated
    (reference: shepseg.py:618-674). The public
    :func:`eliminateSinglePixels` driver runs the same pass structure
    on-device.
    """
    numEliminated = 0
    for (i, j) in np.argwhere(segSize[seg] == 1):  # row-major scan order
        (ii, jj) = findNearestNeighbourPixel(img, seg, int(i), int(j),
                                             segSize, fourConnected)
        if ii >= 0 and jj >= 0:
            segToElim[0, numEliminated] = i
            segToElim[1, numEliminated] = j
            segToElim[2, numEliminated] = seg[ii, jj]
            numEliminated += 1
    for k in range(numEliminated):
        r = segToElim[0, k]
        c = segToElim[1, k]
        newSeg = segToElim[2, k]
        oldSeg = seg[r, c]
        seg[r, c] = newSeg
        segSize[oldSeg] = 0
        segSize[newSeg] += 1
    return numEliminated


def findMergeSegment(segId, segLoc, seg, segSize, spectSum,
                     maxSpectralDiff, fourConnected):
    """
    The neighbouring segment the given segment should merge into: the
    strictly-larger neighbour with the closest mean spectrum, SEGNULLVAL
    if none within maxSpectralDiff (reference: shepseg.py:1003-1063 —
    same pixel scan order and strict-< tie-break). ``segLoc`` is the
    dict from :func:`makeSegmentLocationsDict`.
    """
    bestNbrSeg = SEGNULLVAL
    bestDistSqr = 0.0
    (nRows, nCols) = seg.shape
    segRowcols = segLoc[segId].rowcols
    numPix = len(segRowcols)
    spect = spectSum[segId] / numPix
    for k in range(numPix):
        # python ints: uint32 pixel coords would wrap at the image edge
        i = int(segRowcols[k, 0])
        j = int(segRowcols[k, 1])
        for ii in range(max(i - 1, 0), min(i + 2, nRows)):
            for jj in range(max(j - 1, 0), min(j + 2, nCols)):
                connected = (not fourConnected) or (ii == i) or (jj == j)
                nbrSegId = seg[ii, jj]
                if (connected and nbrSegId != segId and
                        nbrSegId != SEGNULLVAL and
                        segSize[nbrSegId] > segSize[segId]):
                    nbrSpect = spectSum[nbrSegId] / segSize[nbrSegId]
                    distSqr = ((spect - nbrSpect) ** 2).sum()
                    if bestNbrSeg == SEGNULLVAL or distSqr < bestDistSqr:
                        bestDistSqr = distSqr
                        bestNbrSeg = nbrSegId
    if bestDistSqr > maxSpectralDiff ** 2:
        bestNbrSeg = SEGNULLVAL
    return bestNbrSeg


def doMerge(segId, nbrSegId, seg, segSize, segLoc, spectSum):
    """
    Merge segment segId into nbrSegId: rewrite its pixels, concatenate
    the coordinate lists (neighbour's pixels first, as the reference
    appends), add the spectral sums and sizes, zero out the merged-away
    entry. Modifies everything in place
    (reference: shepseg.py:1066-1123).
    """
    segRowcols = segLoc[segId].rowcols
    numPix = len(segRowcols)
    nbrRowcols = segLoc[nbrSegId].rowcols
    nbrNumPix = len(nbrRowcols)
    merged = RowColArray(numPix + nbrNumPix)
    merged.rowcols[:nbrNumPix] = nbrRowcols
    merged.rowcols[nbrNumPix:] = segRowcols
    merged.idx = numPix + nbrNumPix
    seg[segRowcols[:, 0], segRowcols[:, 1]] = nbrSegId
    segLoc[nbrSegId] = merged
    segLoc.pop(segId)
    spectSum[nbrSegId] += spectSum[segId]
    spectSum[segId] = 0
    segSize[nbrSegId] += segSize[segId]
    segSize[segId] = 0
