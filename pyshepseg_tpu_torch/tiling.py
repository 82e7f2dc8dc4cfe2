"""
Tiled segmentation driver for rasters too large to segment in one pass
(counterpart: pyshepseg_tpu/tiling.py; reference: pyshepseg/tiling.py).

The raster is segmented in overlapping tiles, all seeded with one k-means
model fitted to a whole-file subsample (for cross-tile consistency), then
stitched: segment IDs are recoded to be globally unique and contiguous,
with segments crossing a tile-overlap midline adopting the earlier tile's
ID (halo reconciliation). Every tile goes through the port's
``shepseg.doShepherdSegmentation`` on ``device`` (kernels K1 and K2 on a
CUDA device); the stitcher's shared-segment matching and ownership
relabelling are host numpy, as in the JAX package.

Concurrency backends (reference: tiling.py:85-109 CONC_* types):

- CONC_NONE — serial per-tile loop
- CONC_THREADS — thread pool; each worker thread queues its tiles on a
  CUDA stream of its own, so raster reads overlap device compute
- CONC_SUBPROC — local subprocess workers over the NetworkDataChannel
  (the CI-testable stand-in for true multi-host runs)
- CONC_FARGATE — elastic AWS Fargate workers (requires boto3)
- CONC_MESH — chunks of tiles dealt to a list of devices, each running the
  device-resident pipeline on its share (parallel/mesh.py)

Also provides the decomposed 3-phase API
(doTiledShepherdSegmentation_prepare / _doOne / _finalize) used by
distributed batch pipelines (reference: parallel_examples/awsbatch).

Raster I/O and the native stitch loops are the port's :mod:`.io` and
:mod:`.native`.
"""

import os
import sys
import time
import queue
import shutil
import socket
import secrets
import tempfile
import threading
import contextlib
import subprocess
import multiprocessing.managers
from concurrent import futures

import numpy
import torch

from . import _kernels
from . import io as rio
from . import native
from . import shepseg
from . import utils
from . import timinghooks

DFLT_TEMPFILES_DRIVER = 'KEA'
DFLT_TEMPFILES_EXT = 'kea'

DFLT_TILESIZE = 4096
DFLT_OVERLAPSIZE = 1024

DFLT_CHUNKSIZE = 100000

TILESIZE = 1024

# Reference-compatible alias (reference: tiling.py:109 — a numba type
# there, a plain numpy dtype here)
segIdNumbaType = shepseg.SegIdType

# Concurrency styles
CONC_NONE = "CONC_NONE"
CONC_THREADS = "CONC_THREADS"
CONC_FARGATE = "CONC_FARGATE"
CONC_SUBPROC = "CONC_SUBPROC"
CONC_MESH = "CONC_MESH"

# The two orientations of the overlap region
HORIZONTAL = 0
VERTICAL = 1
RIGHT_OVERLAP = 'right'
BOTTOM_OVERLAP = 'bottom'


class PyShepSegTilingError(Exception):
    pass


class TiledSegmentationResult(object):
    """
    Result of tiled segmentation (reference: tiling.py:112-151).

    Attributes: maxSegId, numTileRows, numTileCols, subsamplePcnt,
    maxSpectralDiff, kmeans, hasEmptySegments, timings, outDs.
    """

    def __init__(self):
        self.maxSegId = None
        self.numTileRows = None
        self.numTileCols = None
        self.subsamplePcnt = None
        self.maxSpectralDiff = None
        self.kmeans = None
        self.hasEmptySegments = None
        self.outDs = None
        self.timings = None


def getImgNullValue(inDs, bandNumbers):
    """
    Common null value of the given bands; error if bands differ
    (reference: tiling.py:229-256).
    """
    bad = [i for i in bandNumbers if i < 1 or i > inDs.RasterCount]
    if bad:
        raise PyShepSegTilingError(
            "Band number(s) {} not present: the input has {} band(s). "
            "Use the band-selection option to choose valid bands.".format(
                bad, inDs.RasterCount))
    nullValArr = numpy.array([inDs.GetRasterBand(i).GetNoDataValue()
                              for i in bandNumbers], dtype=object)
    if any(v != nullValArr[0] for v in nullValArr):
        raise PyShepSegTilingError("Different null values in some bands")
    return nullValArr[0]


def readSubsampledImageBand(bandObj, subsampleProp):
    """
    Strided subsample of a whole band, read tile-by-tile, deliberately
    ignoring any overview layers (they can't be trusted as data —
    reference: tiling.py:259-314).
    """
    skip = int(round(1. / subsampleProp))
    tileSize = TILESIZE
    (nlines, npix) = (bandObj.YSize, bandObj.XSize)
    numXtiles = int(numpy.ceil(npix / tileSize))
    numYtiles = int(numpy.ceil(nlines / tileSize))

    tileRowList = []
    for tileRow in range(numYtiles):
        ypos = tileRow * tileSize
        ysize = min(tileSize, (nlines - ypos))
        tileColList = []
        for tileCol in range(numXtiles):
            xpos = tileCol * tileSize
            xsize = min(tileSize, (npix - xpos))
            tile = bandObj.ReadAsArray(xpos, ypos, xsize, ysize)
            tileColList.append(tile[::skip, ::skip])
        tileRowList.append(numpy.concatenate(tileColList, axis=1))
    return numpy.concatenate(tileRowList, axis=0)


def fitSpectralClustersWholeFile(inDs, bandNumbers, numClusters=60,
        subsamplePcnt=None, imgNullVal=None, fixedKMeansInit=False,
        device="cuda"):
    """
    Fit the k-means model on a whole-file subsample of roughly one million
    pixels (reference: tiling.py:154-226), on ``device``.

    Returns (kmeansObj, subsamplePcnt, imgNullVal).
    """
    if subsamplePcnt is None:
        dfltTotalPixels = 1000000
        totalImagePixels = inDs.RasterXSize * inDs.RasterYSize
        subsampleProp = min(1, numpy.sqrt(
            dfltTotalPixels / totalImagePixels))
        subsamplePcnt = 100 * subsampleProp ** 2
    else:
        subsampleProp = numpy.sqrt(subsamplePcnt / 100.0)

    if imgNullVal is None:
        imgNullVal = getImgNullValue(inDs, bandNumbers)

    bandList = []
    for bandNum in bandNumbers:
        bandObj = inDs.GetRasterBand(bandNum)
        bandList.append(readSubsampledImageBand(bandObj, subsampleProp))
    img = numpy.array(bandList)

    kmeansObj = shepseg.fitSpectralClusters(
        img, numClusters=numClusters, subsamplePcnt=100,
        imgNullVal=imgNullVal, fixedKMeansInit=fixedKMeansInit,
        device=device)
    return (kmeansObj, subsamplePcnt, imgNullVal)


class TileInfo(object):
    """
    Pixel coordinates of the tiles within an image
    (reference: tiling.py:317-373).
    """

    def __init__(self):
        self.tiles = {}
        self.ncols = None
        self.nrows = None

    def addTile(self, xpos, ypos, xsize, ysize, col, row):
        self.tiles[(col, row)] = (xpos, ypos, xsize, ysize)

    def getNumTiles(self):
        return len(self.tiles)

    def getTile(self, col, row):
        return self.tiles[(col, row)]

    def pairOverlap(self, col, row, edge):
        """
        Width (in pixels) of the region this tile shares with its 'left'
        or 'top' neighbour. With the reference's grown-edge grid this is
        the constant overlapSize everywhere; with the uniform grid the
        final tile of each axis shares a wider strip with its neighbour.
        The stitcher derives all trim/strip geometry from this, so both
        grid styles stitch through one code path.
        """
        (xpos, ypos, xsize, ysize) = self.getTile(col, row)
        if edge == 'left':
            (pxpos, _, pxsize, _) = self.getTile(col - 1, row)
            return pxpos + pxsize - xpos
        elif edge == 'top':
            (_, pypos, _, pysize) = self.getTile(col, row - 1)
            return pypos + pysize - ypos
        raise ValueError(f"Unknown edge '{edge}'")


def _axisTilePositions(totalSize, tileSize, overlapSize, grow):
    """
    (start, size) of each tile along one axis.

    grow=True reproduces the reference's rule: tiles step by
    tileSize - overlapSize and the final tile absorbs the remainder,
    growing to just under 2x tileSize so no sliver tiles remain
    (reference: tiling.py:376-443).

    grow=False is the JAX package's uniform grid: every tile is exactly
    tileSize; instead of growing, the final tile SHIFTS back so it ends
    at the raster edge, sharing a wider strip with its neighbour. All
    tiles then have one shape. The mosaic depends on the grid, so both
    are kept.
    """
    step = tileSize - overlapSize
    if grow:
        positions = []
        pos = 0
        while True:
            size = tileSize
            isLast = (pos + 2 * tileSize) > totalSize
            if isLast:
                size = totalSize - pos
                if size == 0:
                    break
            positions.append((pos, size))
            if isLast:
                break
            pos += step
        return positions
    if totalSize <= tileSize:
        return [(0, totalSize)]
    starts = [0]
    while starts[-1] + tileSize < totalSize:
        starts.append(min(starts[-1] + step, totalSize - tileSize))
    return [(pos, tileSize) for pos in starts]


def getTilesForFile(ds, tileSize, overlapSize, tileGrid='uniform'):
    """
    Tile grid for the given raster. ``tileGrid='uniform'`` (default) makes
    every tile exactly tileSize x tileSize, shifting the last tile of each
    axis back to the raster edge. ``tileGrid='grow'`` reproduces the
    reference's grid, where edge tiles grow up to just under 2x to absorb
    slivers (reference: tiling.py:376-443).
    """
    if tileGrid not in ('uniform', 'grow'):
        raise PyShepSegTilingError(
            f"tileGrid must be 'uniform' or 'grow', got '{tileGrid}'")
    tileSize = int(tileSize)
    overlapSize = int(overlapSize)
    if overlapSize >= tileSize:
        raise PyShepSegTilingError("overlapSize must be less than tileSize")
    tileInfo = TileInfo()
    grow = (tileGrid == 'grow')
    xTiles = _axisTilePositions(ds.RasterXSize, tileSize, overlapSize, grow)
    yTiles = _axisTilePositions(ds.RasterYSize, tileSize, overlapSize, grow)
    for row, (ypos, ysize) in enumerate(yTiles):
        for col, (xpos, xsize) in enumerate(xTiles):
            tileInfo.addTile(xpos, ypos, xsize, ysize, col, row)
    tileInfo.ncols = len(xTiles)
    tileInfo.nrows = len(yTiles)
    return tileInfo


def doTiledShepherdSegmentation(infile, outfile, tileSize=DFLT_TILESIZE,
        overlapSize=DFLT_OVERLAPSIZE, minSegmentSize=50, numClusters=60,
        bandNumbers=None, subsamplePcnt=None, maxSpectralDiff='auto',
        imgNullVal=None, fixedKMeansInit=False, fourConnected=True,
        verbose=False, simpleTileRecode=False, outputDriver='KEA',
        creationOptions=[], spectDistPcntile=50, kmeansObj=None,
        tempfilesDriver=DFLT_TEMPFILES_DRIVER, tempfilesExt=DFLT_TEMPFILES_EXT,
        tempfilesCreationOptions=[], writeHistogram=True, returnGDALDS=False,
        concurrencyCfg=None, tileGrid='uniform', device="cuda"):
    """
    Run tiled Shepherd segmentation on a large raster and write the stitched
    segment raster to outfile (reference: tiling.py:446-571 — same
    parameters and semantics, those of pyshepseg_tpu.tiling's driver).

    ``tileGrid`` selects the tile decomposition: 'uniform' (default) keeps
    every tile exactly tileSize, while 'grow' reproduces the reference's
    grown-edge-tile grid (see getTilesForFile).

    ``device`` is where the k-means fit and every tile's segmentation run:
    "cuda" (the default) raises when CUDA is absent; "cpu" runs the plain
    versions of the kernels. Out-of-process workers get it through the
    channel.

    Returns a TiledSegmentationResult.
    """
    if concurrencyCfg is None:
        concurrencyCfg = SegmentationConcurrencyConfig()

    concurrencyMgrClass = selectConcurrencyClass(
        concurrencyCfg.concurrencyType, SegmentationConcurrencyMgr)
    concurrencyMgr = concurrencyMgrClass(infile, outfile, tileSize,
        overlapSize, minSegmentSize, numClusters, bandNumbers, subsamplePcnt,
        maxSpectralDiff, imgNullVal, fixedKMeansInit, fourConnected, verbose,
        simpleTileRecode, outputDriver, creationOptions, spectDistPcntile,
        kmeansObj, tempfilesDriver, tempfilesCreationOptions, writeHistogram,
        returnGDALDS, concurrencyCfg, device)
    concurrencyMgr.tileGrid = tileGrid

    with concurrencyMgr.timings.interval('walltime'):
        try:
            concurrencyMgr.initialize()
            concurrencyMgr.segmentAllTiles()
        finally:
            concurrencyMgr.shutdown()

    tiledSegResult = TiledSegmentationResult()
    if hasattr(concurrencyMgr, 'maxSegId'):
        tiledSegResult.maxSegId = concurrencyMgr.maxSegId
        tiledSegResult.numTileRows = concurrencyMgr.tileInfo.nrows
        tiledSegResult.numTileCols = concurrencyMgr.tileInfo.ncols
        tiledSegResult.subsamplePcnt = concurrencyMgr.subsamplePcnt
        tiledSegResult.maxSpectralDiff = concurrencyMgr.maxSpectralDiff
        tiledSegResult.kmeans = concurrencyMgr.kmeansObj
        tiledSegResult.hasEmptySegments = concurrencyMgr.hasEmptySegments
        tiledSegResult.timings = concurrencyMgr.timings
        if returnGDALDS:
            tiledSegResult.outDs = concurrencyMgr.outDs

    return tiledSegResult


def selectConcurrencyClass(concurrencyType, baseClass):
    """Choose the manager subclass for the given concurrencyType
    (reference: tiling.py:574-587)."""
    if concurrencyType == CONC_MESH:
        # registers the SegMeshMgr subclass (lazy: avoids a circular import)
        from . import parallel  # noqa: F401
    for c in baseClass.__subclasses__():
        if c.concurrencyType == concurrencyType:
            return c
    raise ValueError(f"Unknown concurrencyType '{concurrencyType}'")


class SegmentationConcurrencyConfig:
    """
    Configuration for segmentation concurrency
    (reference: tiling.py:590-634).

    ``deviceSceneCache`` controls the whole-scene cache used by the
    in-process backends (CONC_NONE / CONC_THREADS / CONC_MESH): 'auto'
    (default) copies the full scene to the device once and cuts tiles
    there when the scene fits comfortably in the device's memory, which
    avoids re-reading and re-copying the overlap regions of every tile; True
    forces it (errors if the scene cannot be read whole); False always
    streams tiles from the file as the reference does.

    ``tilesPerDevice`` (CONC_MESH only) is the number of tiles each
    device takes from a chunk: a chunk is ``nDev * tilesPerDevice`` tiles,
    read (or sliced from the scene cache) together and dealt to the devices
    in contiguous runs. Results are bit-identical for any value.

    ``workerDevices`` (CONC_THREADS only): 'default' runs every worker
    thread's tiles on the run's ``device``; 'all' assigns worker ``i`` to
    ``cuda:(i % torch.cuda.device_count())`` when that device is a CUDA
    device, so the thread pool drives every card of the host. Results
    are bit-identical either way (tile results are deterministic per
    tile; the stitcher consumes them in row-major order regardless of
    completion order).
    """

    def __init__(self, concurrencyType=CONC_NONE, numWorkers=0,
            maxConcurrentReads=20, tileCompletionTimeout=60,
            barrierTimeout=300, fargateCfg=None, deviceSceneCache='auto',
            tilesPerDevice=1, workerDevices='default'):
        self.concurrencyType = concurrencyType
        self.numWorkers = numWorkers
        self.maxConcurrentReads = maxConcurrentReads
        self.tileCompletionTimeout = tileCompletionTimeout
        self.barrierTimeout = barrierTimeout
        self.fargateCfg = fargateCfg
        self.deviceSceneCache = deviceSceneCache
        self.tilesPerDevice = tilesPerDevice
        self.workerDevices = workerDevices
        if concurrencyType == CONC_FARGATE and fargateCfg is None:
            raise PyShepSegTilingError(
                "fargateCfg is required with CONC_FARGATE")
        if concurrencyType != CONC_FARGATE and fargateCfg is not None:
            raise PyShepSegTilingError(
                "fargateCfg is only used with CONC_FARGATE")
        if deviceSceneCache not in ('auto', True, False):
            raise PyShepSegTilingError(
                "deviceSceneCache must be 'auto', True or False")
        if deviceSceneCache != 'auto':
            # Normalise truthy/falsy equivalents (1/0 pass the equality
            # check above) so downstream identity tests are reliable.
            self.deviceSceneCache = bool(deviceSceneCache)
        if not (isinstance(tilesPerDevice, int) and tilesPerDevice >= 1):
            raise PyShepSegTilingError(
                "tilesPerDevice must be a positive integer")
        if workerDevices not in ('default', 'all'):
            raise PyShepSegTilingError(
                "workerDevices must be 'default' or 'all'")


# Fraction of the device's free memory the 'auto' scene cache may
# occupy. The per-tile pipeline's working set is many tile-sized
# intermediates, so the scene itself must stay a minority share.
SCENE_CACHE_HBM_FRACTION = 0.25
# Fallback budget for a CPU device, whose tensors live in host RAM: used
# only if /proc/meminfo is unreadable. Otherwise the budget is a fraction
# of the host's currently-available memory, so 'auto' never flips a
# previously-streaming CPU run into an OOM.
SCENE_CACHE_DFLT_BUDGET = 1 * 1024 ** 3


def _hostAvailableBytes():
    """MemAvailable from /proc/meminfo, or 0 when unreadable."""
    try:
        with open('/proc/meminfo') as f:
            for line in f:
                if line.startswith('MemAvailable:'):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 0


def sceneBudgetBytes(device):
    """Bytes a whole scene may take on ``device`` (the segmentation's
    scene cache, the stats pass's scene feed): the free memory of a CUDA
    device, or the host's available memory for the CPU, times
    SCENE_CACHE_HBM_FRACTION."""
    device = torch.device(device)
    if device.type == 'cuda':
        free = torch.cuda.mem_get_info(device)[0]
    else:
        free = _hostAvailableBytes() or SCENE_CACHE_DFLT_BUDGET
    return free * SCENE_CACHE_HBM_FRACTION


class DeviceSceneCache:
    """
    Whole-scene image cache on the device for tiled segmentation.

    The reference re-reads every tile (including its overlap halo) from
    the raster and ships it to the compute separately (reference:
    tiling.py:1436-1443). Here the scene is read and copied to the device
    ONCE, as one tensor of its native dtype, and each overlapping tile is
    a slice of it: no per-tile host->device traffic and no re-copy of the
    overlap regions.
    """

    def __init__(self, inDs, bandNumbers, device, verbose=False):
        t0 = time.time()
        bands = [inDs.GetRasterBand(b).ReadAsArray() for b in bandNumbers]
        scene = numpy.ascontiguousarray(numpy.array(bands))
        self.scene = torch.from_numpy(scene).to(device)
        self.nBands = scene.shape[0]
        del bands, scene
        if verbose:
            print("Scene cached on {} ({:.1f} MB, {:.2f} s)".format(
                self.scene.device,
                self.scene.numel() * self.scene.element_size() / 2 ** 20,
                time.time() - t0))

    @staticmethod
    def fitsOnDevice(inDs, bandNumbers, device):
        """True if the scene is small enough for the 'auto' cache
        (:func:`sceneBudgetBytes`)."""
        budget = sceneBudgetBytes(device)
        itemsize = inDs.GetRasterBand(
            list(bandNumbers)[0]).ReadAsArray(0, 0, 1, 1).itemsize
        sceneBytes = (len(list(bandNumbers)) * itemsize *
                      inDs.RasterXSize * inDs.RasterYSize)
        return sceneBytes <= budget

    def getTile(self, xpos, ypos, xsize, ysize):
        """The (nBands, ysize, xsize) tile: a slice (view) of the scene
        tensor, on the scene's device."""
        return self.scene[:, ypos:ypos + ysize, xpos:xpos + xsize]


class FargateConfig:
    """
    Configuration for AWS Fargate workers (reference: tiling.py:637-697).
    """

    def __init__(self, containerImage=None, taskRoleArn=None,
            executionRoleArn=None, subnet=None, securityGroups=None,
            cpu='0.5 vCPU', memory='1GB', cpuArchitecture=None,
            cloudwatchLogGroup=None):
        self.containerImage = containerImage
        self.taskRoleArn = taskRoleArn
        self.executionRoleArn = executionRoleArn
        self.subnet = subnet
        self.securityGroups = securityGroups
        self.cpu = cpu
        self.memory = memory
        self.cpuArchitecture = cpuArchitecture
        self.logGroup = cloudwatchLogGroup


# ------------------------------------------------------------------------
# Vectorized stitch/recode primitives. These replace the reference's
# per-segment Python loops (tiling.py:1128-1306) with whole-array numpy.


def _segsCrossingMidline(overlapA, orientation):
    """
    Segment IDs in overlapA whose bounding box straddles the overlap
    midline (reference crossesMidline, tiling.py:1271-1306). A segment
    crosses iff it appears both before and at/after the midline.
    """
    (nrows, ncols) = overlapA.shape
    if orientation == HORIZONTAL:
        mid = nrows // 2
        before, after = overlapA[:mid, :], overlapA[mid:, :]
    else:
        mid = ncols // 2
        before, after = overlapA[:, :mid], overlapA[:, mid:]
    # bounded-ID set intersection via bincounts (no sorts)
    maxId = int(overlapA.max())
    cntBefore = numpy.bincount(before.ravel(), minlength=maxId + 1)
    cntAfter = numpy.bincount(after.ravel(), minlength=maxId + 1)
    crossing = numpy.flatnonzero((cntBefore > 0) & (cntAfter > 0))
    return crossing[crossing != shepseg.SEGNULLVAL]


def _modeMatch(overlapA, overlapB, crossingIds):
    """
    For each crossing segment ID in overlapA, the most common co-located
    NON-NULL value in overlapB (ties -> smallest value, matching
    scipy.stats.mode as used at reference tiling.py:1194-1200). Returns a
    dict id -> id; segments with no labelled co-located B pixels get no
    entry.

    Null B pixels are excluded — a deliberate fix of a reference defect
    (its mode runs over raw B values, reference tiling.py:1194-1200):
    when a segment pokes a sliver across the midline into a region the
    earlier tile left unclaimed, the mode can come back as the NULL id,
    recoding the entire segment to null; nulls then cascade down the
    overlap chain and can void whole regions (reproduced at the
    reference's own 8000^2 test scale with 1024/256 tiles). Only pixels
    the earlier tile actually labelled carry identity information.
    """
    if len(crossingIds) == 0:
        return {}
    # bounded-ID membership lookup table instead of numpy.isin's sort
    isCrossing = numpy.zeros(int(overlapA.max()) + 1, dtype=bool)
    isCrossing[crossingIds] = True
    mask = isCrossing[overlapA] & (overlapB != shepseg.SEGNULLVAL)
    a = overlapA[mask].astype(numpy.uint64)
    b = overlapB[mask].astype(numpy.uint64)
    if len(a) == 0:
        # nothing in the earlier tile was labelled under any crossing
        # segment: no identity information, no recode entries
        return {}
    pairKey = (a << numpy.uint64(32)) | b
    uniqPairs, counts = numpy.unique(pairKey, return_counts=True)
    ua = (uniqPairs >> numpy.uint64(32)).astype(numpy.int64)
    ub = (uniqPairs & numpy.uint64(0xFFFFFFFF)).astype(numpy.int64)
    # Order by (segment, count desc, value asc); first row per segment wins
    order = numpy.lexsort((ub, -counts, ua))
    ua, ub = ua[order], ub[order]
    first = numpy.concatenate([[True], ua[1:] != ua[:-1]])
    return dict(zip(ua[first].tolist(), ub[first].tolist()))


class SegmentationConcurrencyMgr:
    """
    Base class: holds parameters, runs the initialize / segment / stitch
    phases (reference: tiling.py:700-1404). Subclasses provide workers.
    ``device`` is where the k-means fit and the tiles' segmentation run
    (validated here: "cuda" raises when CUDA is absent).
    """
    concurrencyType = CONC_NONE

    def __init__(self, infile, outfile, tileSize, overlapSize, minSegmentSize,
            numClusters, bandNumbers, subsamplePcnt, maxSpectralDiff,
            imgNullVal, fixedKMeansInit, fourConnected, verbose,
            simpleTileRecode, outputDriver, creationOptions, spectDistPcntile,
            kmeansObj, tempfilesDriver, tempfilesCreationOptions,
            writeHistogram, returnGDALDS, concCfg, device="cuda"):
        self.device = _kernels.torch_device(device)
        self.infile = infile
        self.outfile = outfile
        self.tileSize = tileSize
        self.overlapSize = overlapSize
        self.minSegmentSize = minSegmentSize
        self.numClusters = numClusters
        self.bandNumbers = bandNumbers
        self.subsamplePcnt = subsamplePcnt
        self.maxSpectralDiff = maxSpectralDiff
        self.imgNullVal = imgNullVal
        self.fixedKMeansInit = fixedKMeansInit
        self.fourConnected = fourConnected
        self.verbose = verbose
        self.simpleTileRecode = simpleTileRecode
        self.outputDriver = outputDriver
        self.creationOptions = creationOptions
        self.spectDistPcntile = spectDistPcntile
        self.kmeansObj = kmeansObj
        self.tempfilesDriver = tempfilesDriver
        self.tempfilesCreationOptions = tempfilesCreationOptions
        self.writeHistogram = writeHistogram
        self.returnGDALDS = returnGDALDS
        self.concurrencyCfg = concCfg
        if concCfg.numWorkers > 0:
            self.readSemaphore = threading.BoundedSemaphore(
                value=concCfg.maxConcurrentReads)
        self.overlapCache = {}
        self.sceneCache = None
        self.timings = timinghooks.Timers()
        self.workerBarrier = None
        self.tileGrid = 'uniform'

        if (self.overlapSize % 2) != 0:
            raise PyShepSegTilingError("Overlap size must be an even number")

        self.specificChecks()

    def specificChecks(self):
        """Subclass-specific constructor checks."""

    def initialize(self):
        """
        Non-concurrent initial phase: fit whole-file k-means (or adopt a
        given model), build the tile grid, save geo metadata
        (reference: tiling.py:765-804).
        """
        if self.verbose:
            print("Starting tiled segmentation")

        inDs = rio.open(self.infile)

        if self.bandNumbers is None:
            self.bandNumbers = range(1, inDs.RasterCount + 1)

        t0 = time.time()
        if self.kmeansObj is None:
            with self.timings.interval('spectralclusters'):
                (self.kmeansObj, self.subsamplePcnt, self.imgNullVal) = (
                    fitSpectralClustersWholeFile(
                        inDs, self.bandNumbers, self.numClusters,
                        self.subsamplePcnt, self.imgNullVal,
                        self.fixedKMeansInit, self.device))
            if self.verbose:
                print("KMeans of whole raster {:.2f} seconds".format(
                    time.time() - t0))
                print("Subsample Percentage={:.2f}".format(
                    self.subsamplePcnt))
        elif self.imgNullVal is None:
            self.imgNullVal = getImgNullValue(inDs, self.bandNumbers)

        self.tileInfo = getTilesForFile(inDs, self.tileSize,
                                        self.overlapSize, self.tileGrid)
        if self.verbose:
            print("Found {} tiles, with {} rows and {} cols".format(
                self.tileInfo.getNumTiles(), self.tileInfo.nrows,
                self.tileInfo.ncols))

        self.inXsize = inDs.RasterXSize
        self.inYsize = inDs.RasterYSize
        self.inProj = inDs.GetProjection()
        self.inGeoTransform = inDs.GetGeoTransform()

    def shutdown(self):
        """Any explicit shutdown operations."""

    def setupNetworkComms(self):
        """
        Create the NetworkDataChannel that out-of-process workers connect to
        (reference: tiling.py:811-837).
        """
        segDataDict = {
            'infile': self.infile,
            'tileInfo': self.tileInfo,
            'minSegmentSize': self.minSegmentSize,
            'maxSpectralDiff': self.maxSpectralDiff,
            'imgNullVal': self.imgNullVal,
            'fourConnected': self.fourConnected,
            'kmeansObj': self.kmeansObj,
            'verbose': self.verbose,
            'spectDistPcntile': self.spectDistPcntile,
            'bandNumbers': list(self.bandNumbers),
            'barrierTimeout': self.concurrencyCfg.barrierTimeout,
            'device': str(self.device),
        }
        self.dataChan = NetworkDataChannel(inQue=self.inQue,
            segResultCache=self.segResultCache,
            forceExit=self.forceExit,
            exceptionQue=self.exceptionQue,
            segDataDict=segDataDict,
            readSemaphore=self.readSemaphore,
            timings=self.timings,
            workerBarrier=self.workerBarrier)

    @staticmethod
    def popFromQue(que):
        """Non-blocking pop; None when empty."""
        try:
            return que.get(block=False)
        except queue.Empty:
            return None

    def saveOverlap(self, overlapCacheKey, overlapData):
        self.overlapCache[overlapCacheKey] = overlapData

    def loadOverlap(self, overlapCacheKey):
        return self.overlapCache.pop(overlapCacheKey)

    def maybeBuildSceneCache(self, inDs=None):
        """
        Build the whole-scene cache (DeviceSceneCache) on ``self.device``
        when configured and applicable. Only the in-process backends
        (CONC_NONE / CONC_THREADS / CONC_MESH) can share a device-resident
        scene; out-of-process workers read the raster themselves.
        """
        cfg = getattr(self.concurrencyCfg, 'deviceSceneCache', False)
        supported = self.concurrencyType in (CONC_NONE, CONC_THREADS,
                                             CONC_MESH)
        if cfg is True and not supported:
            raise PyShepSegTilingError(
                "deviceSceneCache=True is only supported with the "
                "in-process backends (CONC_NONE / CONC_THREADS / "
                "CONC_MESH)")
        if cfg is False or not supported:
            return
        if inDs is None:
            inDs = rio.open(self.infile)
        if cfg == 'auto' and not DeviceSceneCache.fitsOnDevice(
                inDs, self.bandNumbers, self.device):
            return
        with self.timings.interval('reading'):
            self.sceneCache = DeviceSceneCache(inDs, self.bandNumbers,
                                               self.device, self.verbose)

    def readTileImage(self, inDs, col, row, readSemaphore=None):
        """
        The (nBands, ysize, xsize) image of one tile, ready for
        doShepherdSegmentation: a slice of the scene tensor when the scene
        cache is active (no host I/O, no transfer), else a host numpy read
        of each band (bounded by readSemaphore when given). Both give the
        same segmentation.
        """
        xpos, ypos, xsize, ysize = self.tileInfo.getTile(col, row)
        if self.sceneCache is not None:
            return self.sceneCache.getTile(xpos, ypos, xsize, ysize)
        lyrDataList = []
        for bandNum in self.bandNumbers:
            lyr = inDs.GetRasterBand(bandNum)
            if readSemaphore is not None:
                with readSemaphore:
                    lyrDataList.append(
                        lyr.ReadAsArray(xpos, ypos, xsize, ysize))
            else:
                lyrDataList.append(
                    lyr.ReadAsArray(xpos, ypos, xsize, ysize))
        return numpy.array(lyrDataList)

    def getTileSegmentation(self, col, row):
        """Pop the completed tile from the result cache (may block)."""
        segResult = self.segResultCache.waitForTile(col, row)
        return None if segResult is None else segResult.segimg

    def startWorkers(self):
        """Start segmentation workers, if required."""

    def segmentAllTiles(self):
        """
        Queue-driven segmentation: workers pull tiles from inQue, the main
        thread stitches results in row-major order as they complete
        (reference: tiling.py:882-916).
        """
        colRowList = sorted(self.tileInfo.tiles.keys(),
                            key=lambda x: (x[1], x[0]))
        self.maybeBuildSceneCache()
        self.inQue = queue.Queue()
        self.segResultCache = SegmentationResultCache(
            colRowList, timeout=self.concurrencyCfg.tileCompletionTimeout)
        self.forceExit = threading.Event()
        self.exceptionQue = queue.Queue()
        numWorkers = self.concurrencyCfg.numWorkers
        self.workerBarrier = threading.Barrier(numWorkers + 1)

        try:
            self.setupNetworkComms()
            for colRow in colRowList:
                self.inQue.put(colRow)
            with self.timings.interval('startworkers'):
                self.startWorkers()
            with self.timings.interval('stitchtiles'):
                self.stitchTiles()
        finally:
            if hasattr(self, 'dataChan'):
                self.dataChan.shutdown()

    def checkWorkerExceptions(self):
        """Raise locally if any worker shipped an exception record."""
        if self.exceptionQue.qsize() > 0:
            exceptionRecord = self.exceptionQue.get()
            utils.reportWorkerException(exceptionRecord)
            raise PyShepSegTilingError(
                "The preceding exception was raised in a worker")

    @staticmethod
    def overlapCacheKey(col, row, edge):
        return '{}_{}_{}'.format(edge, col, row)

    def tileStitchGeometry(self, col, row):
        """
        Stitch geometry of one tile, derived entirely from the tile grid's
        per-pair shared-strip widths (TileInfo.pairOverlap), so the grown
        and uniform grids stitch through the same path.

        Returns (top, bottom, left, right, xout, yout, rightWidth,
        bottomWidth): the tile-local trim window [top:bottom, left:right)
        that this tile contributes to the mosaic, the output position of
        that window, and the widths of the right/bottom strips to cache
        for the following tiles (0 on the raster edge). Between two tiles
        sharing a strip of width w, the earlier tile contributes w - w//2
        of it and the later one starts w//2 in, so contributions abut
        exactly for odd w too.
        """
        ti = self.tileInfo
        (xpos, ypos, xsize, ysize) = ti.getTile(col, row)

        topOv = ti.pairOverlap(col, row, 'top') if row > 0 else 0
        leftOv = ti.pairOverlap(col, row, 'left') if col > 0 else 0
        bottomOv = (ti.pairOverlap(col, row + 1, 'top')
                    if row < ti.nrows - 1 else 0)
        rightOv = (ti.pairOverlap(col + 1, row, 'left')
                   if col < ti.ncols - 1 else 0)

        top = topOv // 2
        left = leftOv // 2
        bottom = ysize - (bottomOv - bottomOv // 2)
        right = xsize - (rightOv - rightOv // 2)
        return (top, bottom, left, right, xpos + left, ypos + top,
                rightOv, bottomOv)

    def _createStitchOutput(self):
        """Create the output raster with geo metadata, overviews, and the
        thematic/nodata band settings; returns (outDs, outBand)."""
        outDs = rio.create(self.outfile, self.inXsize, self.inYsize, 1,
                           shepseg.SegIdType, self.outputDriver,
                           self.creationOptions)
        if self.inProj:
            outDs.SetProjection(self.inProj)
        if self.inGeoTransform is not None:
            outDs.SetGeoTransform(self.inGeoTransform)
        self.setupOverviews(outDs)
        outBand = outDs.GetRasterBand(1)
        outBand.SetMetadataItem('LAYER_TYPE', 'thematic')
        outBand.SetNoDataValue(int(shepseg.SEGNULLVAL))
        return outDs, outBand

    def stitchTiles(self):
        """
        Recombine tiles into the output raster with globally unique,
        contiguous segment IDs (reference: tiling.py:950-1064). Consumes
        tiles in strict row-major order; caches each tile's right/bottom
        shared strips for its neighbours; accumulates the histogram and
        writes overview pyramids incrementally.
        """
        outDs, outBand = self._createStitchOutput()
        colRowList = sorted(self.tileInfo.tiles.keys(),
                            key=lambda x: (x[1], x[0]))
        maxSegId = 0
        histAccum = HistogramAccumulator()

        if self.verbose:
            print("Stitching tiles together")
        reportedRow = -1
        for (col, row) in colRowList:
            if self.verbose and row != reportedRow:
                print("Stitching tile row {}".format(row))
                reportedRow = row

            # 'stitchwait' separates time spent WAITING for the tile
            # (worker compute/transfer, or the temp-file load) from the
            # stitcher's own recode/write work, so timing reports show
            # whether the pipelined stitch is the bottleneck
            with self.timings.interval('stitchwait'):
                tileData = self.getTileSegmentation(col, row)
            if tileData is None:
                self.checkWorkerExceptions()
                raise PyShepSegTilingError(
                    "Gave up waiting for tile ({}, {}) after {} seconds "
                    "with no worker error reported; raise "
                    "tileCompletionTimeout if workers are just slow".format(
                        col, row,
                        self.concurrencyCfg.tileCompletionTimeout))

            (top, bottom, left, right, xout, yout, rightOv, bottomOv) = (
                self.tileStitchGeometry(col, row))

            winHist = None
            if self.simpleTileRecode:
                nullmask = (tileData == shepseg.SEGNULLVAL)
                tileData = tileData + shepseg.SegIdType(maxSegId)
                tileData[nullmask] = shepseg.SEGNULLVAL
                tileDataTrimmed = tileData[top:bottom, left:right]
                rightStrip = tileData[:, -rightOv:] if rightOv > 0 else None
                bottomStrip = (tileData[-bottomOv:, :] if bottomOv > 0
                               else None)
                updateMaxFromTile = True
            else:
                # The relabel's assignment counter is authoritative (it
                # covers every ID it issued or preserved), so no
                # per-tile max() scan is needed on this path. Only the
                # regions the stitcher consumes are gathered through the
                # mapping — the trimmed window and the cached strips —
                # never a full relabelled tile (the stitch leg is
                # host-memory-bandwidth-bound; see relabelMapping).
                recodeDict = self._buildRecodeDict(tileData, row, col)
                (mapping, maxSegId, winHist) = self.relabelMapping(
                    tileData, recodeDict, maxSegId, top, bottom, left,
                    right)
                tileDataTrimmed = mapping[tileData[top:bottom,
                                                   left:right]]
                rightStrip = (mapping[tileData[:, -rightOv:]]
                              if rightOv > 0 else None)
                bottomStrip = (mapping[tileData[-bottomOv:, :]]
                               if bottomOv > 0 else None)
                updateMaxFromTile = False

            outBand.WriteArray(tileDataTrimmed, xout, yout)
            self.writeOverviews(outBand, tileDataTrimmed, xout, yout)
            if winHist is not None:
                # derived by the relabel from counts it already had —
                # skips a second full-window bincount per tile
                histAccum.updateHist(winHist)
            else:
                histAccum.doHistAccum(tileDataTrimmed)

            if rightStrip is not None:
                self.saveOverlap(
                    self.overlapCacheKey(col, row, RIGHT_OVERLAP),
                    rightStrip)
            if bottomStrip is not None:
                self.saveOverlap(
                    self.overlapCacheKey(col, row, BOTTOM_OVERLAP),
                    bottomStrip)

            if updateMaxFromTile:
                maxSegId = max(maxSegId, int(tileDataTrimmed.max()))

        # One-off epilogue — the histogram RAT write, the empty-segment
        # check, the GDAL stats metadata, and the output flush (an msync
        # of the whole band for the npseg driver). Timed separately from
        # the per-tile stitch loop: the loop is what races the device
        # tile loop in a pipelined run, while this tail runs once after
        # both finish (like the k-means fit before them).
        with self.timings.interval('stitchfinalize'):
            self.writeHistogramToFile(outBand, histAccum)
            self.hasEmptySegments = self.checkForEmptySegments(
                histAccum.hist, self.overlapSize)
            utils.estimateStatsFromHisto(outBand, histAccum.hist)
            self.maxSegId = maxSegId
            outDs.FlushCache()
        if self.returnGDALDS:
            self.outDs = outDs
        else:
            del outDs

    def recodeTile(self, tileData, maxSegId, tileRow, tileCol,
            top, bottom, left, right):
        """
        Make tile segment IDs globally unique: segments shared with the
        tiles above/left keep those tiles' IDs; the rest get fresh
        sequential IDs if this tile owns them (reference: tiling.py:
        1066-1126). The shared-strip widths come from the tile grid
        (TileInfo.pairOverlap) so they match what the neighbour cached.

        Returns (newTileData, newMaxSegId, winHist) — see
        relabelSegments. The caller must advance its
        running maxSegId to newMaxSegId (the assignment counter), NOT to
        the maximum of the trimmed output: a tile can own a segment whose
        bounding-box corner is inside the trim window while every actual
        pixel is outside it (the corner is not necessarily a pixel), and
        taking the max of the trimmed data — as the reference does,
        tiling.py:1042-1043 — then reissues that segment's ID to the next
        tile, silently merging two unrelated segments.
        """
        recodeDict = self._buildRecodeDict(tileData, tileRow, tileCol)
        (newTileData, newMaxSegId, winHist) = self.relabelSegments(
            tileData, recodeDict, maxSegId, top, bottom, left, right)
        return (newTileData, newMaxSegId, winHist)

    def _buildRecodeDict(self, tileData, tileRow, tileCol):
        """Shared-strip reconciliation for one tile: segments crossing
        the stitch midline adopt the earlier tile's IDs (consumes the
        neighbour strips from the overlap cache)."""
        recodeDict = {}
        # a zero-width pair overlap shares no pixels and the neighbour
        # never cached a strip (stitchTiles guards saves on width > 0)
        if tileRow > 0:
            topOv = self.tileInfo.pairOverlap(tileCol, tileRow, 'top')
            if topOv > 0:
                topOverlapB = self.loadOverlap(
                    self.overlapCacheKey(tileCol, tileRow - 1,
                                         BOTTOM_OVERLAP))
                self.recodeSharedSegments(tileData, tileData[:topOv, :],
                                          topOverlapB, HORIZONTAL,
                                          recodeDict)
        if tileCol > 0:
            leftOv = self.tileInfo.pairOverlap(tileCol, tileRow, 'left')
            if leftOv > 0:
                leftOverlapB = self.loadOverlap(
                    self.overlapCacheKey(tileCol - 1, tileRow,
                                         RIGHT_OVERLAP))
                self.recodeSharedSegments(tileData, tileData[:, :leftOv],
                                          leftOverlapB, VERTICAL,
                                          recodeDict)
        return recodeDict

    @staticmethod
    def recodeSharedSegments(tileData, overlapA, overlapB, orientation,
            recodeDict):
        """
        Map segments of the current tile which cross the overlap midline to
        the earlier tile's ID, matched by the most common co-located B
        value (reference: tiling.py:1128-1203, vectorized).
        """
        crossing = _segsCrossingMidline(overlapA, orientation)
        recodeDict.update(_modeMatch(overlapA, overlapB, crossing))

    @staticmethod
    def relabelSegments(tileData, recodeDict, maxSegId,
            top, bottom, left, right):
        """
        Apply recodeDict; every other segment with at least one pixel in
        the trimmed window [top:bottom, left:right) gets a sequential new
        ID starting at maxSegId+1 (ascending original-ID order, matching
        the reference's iteration order); segments entirely outside the
        window become SEGNULLVAL (their pixels are written by the
        neighbouring tiles that own them).

        Window-presence ownership deliberately replaces the reference's
        bounding-box-corner rule (reference tiling.py:1255-1267): each
        tile is the ONLY writer of its trimmed window, so an un-recoded
        segment with window pixels MUST be claimed here or those pixels
        stay null in the mosaic forever. The two rules coincide except
        exactly when a segment crosses a strip midline but could not be
        matched to a labelled earlier-tile segment (see _modeMatch) —
        where the reference's rule voids real pixels.

        Returns ``(newTileData, newMaxSegId, winHist)``. winHist is the
        trimmed window's pixel-count histogram in NEW-id space (null bin
        zeroed), derived from the per-old-id window counts the relabel
        already computes — so stitchTiles accumulates the output
        histogram without a second full-window bincount per tile.

        The hot loops (window count, ascending assignment) run in native
        C++ when the library is available (native/ccl.cpp); the numpy
        path is the fallback and the parity oracle (test_tiling.py pins
        native == numpy).
        """
        Mgr = SegmentationConcurrencyMgr
        (mapping, newMaxSegId, winHist) = Mgr.relabelMapping(
            tileData, recodeDict, maxSegId, top, bottom, left, right)
        return (mapping[tileData], newMaxSegId, winHist)

    @staticmethod
    def relabelMapping(tileData, recodeDict, maxSegId,
            top, bottom, left, right):
        """
        relabelSegments WITHOUT materialising the relabelled tile:
        returns ``(mapping, newMaxSegId, winHist)`` where
        ``mapping[oldId]`` is the tile's old->new id table. The stitcher
        gathers only the regions it actually consumes (the trimmed
        window it writes, the right/bottom overlap strips it caches) —
        the stitch leg is host-memory-bandwidth-bound, and a full-tile
        materialise + trim copy re-touches ~2.3x the bytes of the
        targeted gathers.
        """
        tileMax = int(tileData.max())
        mapping = numpy.zeros(tileMax + 1, dtype=shepseg.SegIdType)
        recoded = numpy.zeros(tileMax + 1, dtype=numpy.uint8)
        for k, v in recodeDict.items():
            mapping[k] = v
            recoded[k] = 1

        res = native.stitch_mapping(tileData, mapping, recoded, maxSegId,
                                    top, bottom, left, right)
        if res is not None:
            (newMaxSegId, winCounts) = res
            winCounts[shepseg.SEGNULLVAL] = 0
        else:
            window = tileData[top:bottom, left:right]
            # bounded-ID unique: O(n) bincount + flatnonzero instead of
            # a 1-Mpix sort (numpy.unique) per tile — ascending order,
            # same result
            winCounts = numpy.bincount(window.ravel(),
                                       minlength=tileMax + 1)
            winCounts[shepseg.SEGNULLVAL] = 0
            inWindow = numpy.flatnonzero(winCounts)

            ownedIds = inWindow[recoded[inWindow] == 0]  # ascending
            newIds = maxSegId + 1 + numpy.arange(len(ownedIds),
                                                 dtype=numpy.int64)
            mapping[ownedIds] = newIds.astype(shepseg.SegIdType)
            newMaxSegId = maxSegId + len(ownedIds)

        # new-id window histogram from the old-id counts: a scatter over
        # the few hundred ids present, not another pass over the pixels
        present = numpy.flatnonzero(winCounts)
        winHist = numpy.zeros(
            (int(mapping[present].max()) + 1) if len(present) else 1,
            dtype=numpy.int64)
        numpy.add.at(winHist, mapping[present].astype(numpy.int64),
                     winCounts[present].astype(numpy.int64))
        winHist[shepseg.SEGNULLVAL] = 0
        return (mapping, newMaxSegId, winHist)

    @staticmethod
    def crossesMidline(overlap, segLoc, orientation):
        """
        Does the segment (given by its RowColArray-style location object)
        cross the overlap midline? (reference: tiling.py:1271-1306; kept
        for API parity — the stitcher uses the vectorized form.)
        """
        (nrows, ncols) = overlap.shape
        n = 0 if orientation == HORIZONTAL else 1
        mid = int(nrows / 2) if orientation == HORIZONTAL else int(ncols / 2)
        rowcols = (segLoc.rowcols if hasattr(segLoc, 'rowcols')
                   else numpy.asarray(segLoc))
        minN = rowcols[:, n].min()
        maxN = rowcols[:, n].max()
        return ((minN < mid) & (maxN >= mid))

    def checkForEmptySegments(self, hist, overlapSize):
        """
        Warn about zero-count segment IDs (tile-join inconsistency;
        reference: tiling.py:1308-1341).
        """
        emptySegIds = numpy.where(hist[1:] == 0)[0] + 1
        hasEmptySegments = len(emptySegIds) > 0
        if hasEmptySegments:
            print(
                "\nWARNING: {} segment ID(s) ended up with zero pixels "
                "in the mosaic: {}\n"
                "    The tile-join reconciliation could not match these "
                "segments across a shared strip — usually the overlap "
                "({} px here) is too small for the segment sizes this "
                "scene produces. Re-running with a larger overlapSize "
                "(and, if needed, a larger tileSize) normally resolves "
                "it.\n".format(len(emptySegIds), emptySegIds,
                               overlapSize),
                file=sys.stderr)
        return hasEmptySegments

    @staticmethod
    def writeHistogramToFile(outBand, histAccum):
        """Write the accumulated histogram as the RAT 'Histogram' column
        (reference: tiling.py:1343-1358)."""
        attrTbl = outBand.GetDefaultRAT()
        numTableRows = len(histAccum.hist)
        if attrTbl.GetRowCount() != numTableRows:
            attrTbl.SetRowCount(numTableRows)
        colNum = attrTbl.GetColOfUsage(rio.GFU_PixelCount)
        if colNum == -1:
            attrTbl.CreateColumn('Histogram', rio.GFT_Real,
                                 rio.GFU_PixelCount)
            colNum = attrTbl.GetColumnCount() - 1
        attrTbl.WriteArray(histAccum.hist, colNum)

    def writeOverviews(self, outBand, arr, xOff, yOff):
        """Incrementally write overview pyramids for the tile
        (reference: tiling.py:1360-1381)."""
        for j, lvl in enumerate(self.overviewLevels):
            band_ov = outBand.GetOverview(j)
            o = lvl // 2
            arr_sub = arr[o::lvl, o::lvl]
            xOff_sub = xOff // lvl
            yOff_sub = yOff // lvl
            nc = band_ov.XSize - xOff_sub
            nr = band_ov.YSize - yOff_sub
            arr_sub = arr_sub[:nr, :nc]
            if arr_sub.size > 0:
                band_ov.WriteArray(arr_sub, xOff_sub, yOff_sub)

    def setupOverviews(self, outDs):
        """Create overview levels 4, 8, ... down to ~1024 px
        (reference: tiling.py:1383-1404). The loop is deliberately
        LAGGED like the reference's: level 2^i is included whenever
        2^(i-1) still left the image >= 1024, so the list runs one
        level past the size test (e.g. 8192 -> [4, 8, 16])."""
        outSize = max(self.inXsize, self.inYsize)
        finalOutSize = 1024
        self.overviewLevels = []
        i = 2
        sizeOK = (outSize // (2 ** i)) >= finalOutSize
        while sizeOK:
            self.overviewLevels.append(2 ** i)
            sizeOK = (outSize // (2 ** i)) >= finalOutSize
            i += 1
        outDs.BuildOverviews("NEAREST", self.overviewLevels)


class SegNoConcurrencyMgr(SegmentationConcurrencyMgr):
    """
    Serial tiled segmentation: per-tile read -> segment (on ``device``)
    -> temp file, then stitch (reference: tiling.py:1407-1528). Temp tiles
    and overlaps are .npy files.
    """
    concurrencyType = CONC_NONE

    def segmentAllTiles(self):
        self.tempDir = tempfile.mkdtemp()
        self.tileFilenames = {}
        inDs = rio.open(self.infile)

        self.maybeBuildSceneCache(inDs)
        colRowList = sorted(self.tileInfo.tiles.keys(),
                            key=lambda x: (x[1], x[0]))
        tileNum = 1
        segResult = None
        for col, row in colRowList:
            if self.verbose:
                print("\nDoing tile {} of {}: row={}, col={}".format(
                    tileNum, len(colRowList), row, col))

            with self.timings.interval('reading'):
                img = self.readTileImage(inDs, col, row)

            with self.timings.interval('segmentation'):
                segResult = shepseg.doShepherdSegmentation(
                    img, minSegmentSize=self.minSegmentSize,
                    maxSpectralDiff=self.maxSpectralDiff,
                    imgNullVal=self.imgNullVal,
                    fourConnected=self.fourConnected,
                    kmeansObj=self.kmeansObj,
                    verbose=self.verbose,
                    spectDistPcntile=self.spectDistPcntile,
                    device=self.device)

            filename = os.path.join(self.tempDir,
                                    'tile_{}_{}.npy'.format(col, row))
            numpy.save(filename, segResult.segimg)
            self.tileFilenames[(col, row)] = filename
            tileNum += 1

        with self.timings.interval('stitchtiles'):
            self.stitchTiles()

        shutil.rmtree(self.tempDir)
        if segResult is not None:
            self.maxSpectralDiff = segResult.maxSpectralDiff

    def overlapCacheFilename(self, overlapCacheKey):
        return os.path.join(self.tempDir, f"{overlapCacheKey}.npy")

    def saveOverlap(self, overlapCacheKey, overlapData):
        numpy.save(self.overlapCacheFilename(overlapCacheKey), overlapData)

    def loadOverlap(self, overlapCacheKey):
        return numpy.load(self.overlapCacheFilename(overlapCacheKey))

    def getTileSegmentation(self, col, row):
        return numpy.load(self.tileFilenames[(col, row)])

    def checkWorkerExceptions(self):
        """No workers, so no worker exceptions."""


@contextlib.contextmanager
def _workerStream(device, sceneCache):
    """
    Make the block's work on a CUDA ``device`` run on a stream of its own
    (the K1/K2 wrappers launch on the current stream), so one worker's
    host syncs wait only for its own tile, not for the other workers'
    queued kernels. The stream first waits for the scene cache's upload,
    which ran on the default stream. A CPU device runs the block as is.
    """
    if device.type != 'cuda':
        yield
        return
    stream = torch.cuda.Stream(device)
    if sceneCache is not None and sceneCache.scene.is_cuda:
        stream.wait_stream(torch.cuda.default_stream(
            sceneCache.scene.device))
    with torch.cuda.stream(stream):
        yield


class SegThreadsMgr(SegmentationConcurrencyMgr):
    """
    Thread-pool workers in-process (reference: tiling.py:1531-1613). Each
    worker thread queues its tiles on a CUDA stream of its own, so worker
    threads overlap raster reads and host syncs with device compute;
    concurrent reads are bounded by a semaphore.
    """
    concurrencyType = CONC_THREADS

    def specificChecks(self):
        # The reference requires numWorkers < numCpus because its workers
        # compute on the CPU (reference: tiling.py:1538-1546). Here worker
        # threads mostly read tiles and queue device work, so they are not
        # CPU-bound; just require a sane worker count.
        numWorkers = self.concurrencyCfg.numWorkers
        if numWorkers < 1 or numWorkers > 256:
            raise PyShepSegTilingError(
                "numWorkers ({}) must be in 1..256".format(numWorkers))

    def startWorkers(self):
        numWorkers = self.concurrencyCfg.numWorkers
        if (self.device.type == 'cuda' and getattr(
                self.concurrencyCfg, 'workerDevices', 'default') == 'all'):
            # worker i drives card i % count: the pipelined per-tile flow
            # covers every card of the host
            nDev = torch.cuda.device_count()
            self.workerDeviceList = [torch.device('cuda', i % nDev)
                                     for i in range(numWorkers)]
        else:
            self.workerDeviceList = [self.device] * numWorkers
        self.threadPool = futures.ThreadPoolExecutor(
            max_workers=numWorkers)
        self.workerList = [self.threadPool.submit(self.worker, i)
                           for i in range(numWorkers)]

    def worker(self, workerIdx=0):
        try:
            # Each worker opens the input independently (GDAL datasets are
            # not thread-safe; the numpy driver memmaps per read anyway)
            inDs = rio.open(self.infile)
            device = self.workerDeviceList[workerIdx]

            with _workerStream(device, self.sceneCache):
                colRow = self.popFromQue(self.inQue)
                while colRow is not None and not self.forceExit.is_set():
                    (col, row) = colRow

                    with self.timings.interval('reading'):
                        img = self.readTileImage(inDs, col, row,
                                                 self.readSemaphore)
                        if isinstance(img, torch.Tensor):
                            # a scene-cache slice, to this worker's card
                            img = img.to(device)

                    with self.timings.interval('segmentation'):
                        segResult = shepseg.doShepherdSegmentation(
                            img, minSegmentSize=self.minSegmentSize,
                            maxSpectralDiff=self.maxSpectralDiff,
                            imgNullVal=self.imgNullVal,
                            fourConnected=self.fourConnected,
                            kmeansObj=self.kmeansObj,
                            verbose=self.verbose,
                            spectDistPcntile=self.spectDistPcntile,
                            device=device)

                    self.segResultCache.addResult(col, row, segResult)
                    colRow = self.popFromQue(self.inQue)
        except Exception as e:
            self.exceptionQue.put(utils.WorkerErrorRecord(e, 'segmentation'))

    def shutdown(self):
        if hasattr(self, 'workerList'):
            self.forceExit.set()
            futures.wait(self.workerList)
            self.threadPool.shutdown()

    def setupNetworkComms(self):
        """No network communications required."""


class SegSubprocMgr(SegmentationConcurrencyMgr):
    """
    Local subprocess workers over the NetworkDataChannel — the test bed for
    the remote-worker protocol (reference: tiling.py:1773-1796). This is
    the CI-testable fake of a multi-host deployment.
    """
    concurrencyType = CONC_SUBPROC

    def startWorkers(self):
        self.processes = {}
        for workerID in range(self.concurrencyCfg.numWorkers):
            cmdWords = [sys.executable, "-m",
                        "pyshepseg_tpu_torch.cmdline.segmentationworkercmd",
                        "--idnum", str(workerID),
                        "--channaddr", self.dataChan.addressStr()]
            self.processes[workerID] = subprocess.Popen(
                cmdWords, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                universal_newlines=True)
        self.workerBarrier.wait(
            timeout=self.concurrencyCfg.barrierTimeout)

    def shutdown(self):
        if hasattr(self, 'processes'):
            for proc in self.processes.values():
                try:
                    proc.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    proc.kill()


class SegFargateMgr(SegmentationConcurrencyMgr):
    """
    AWS Fargate workers, one container per worker, connected over the
    NetworkDataChannel (reference: tiling.py:1616-1770). Requires boto3.
    """
    concurrencyType = CONC_FARGATE

    def specificChecks(self):
        try:
            import boto3  # noqa: F401
        except ImportError:
            raise PyShepSegTilingError(
                "CONC_FARGATE requires boto3 to be installed")

    def startWorkers(self):
        import boto3
        fargateCfg = self.concurrencyCfg.fargateCfg
        self.ecs = boto3.client('ecs')
        self.clusterName = "pyshepseg_tpu_torch_{}".format(
            secrets.token_hex(4))
        self.ecs.create_cluster(clusterName=self.clusterName)

        containerDefs = [{
            'name': 'pyshepseg_tpu_torch_worker',
            'image': fargateCfg.containerImage,
            'entryPoint': ['pyshepseg_tpu_torch_segmentationworkercmd'],
        }]
        if fargateCfg.logGroup is not None:
            containerDefs[0]['logConfiguration'] = {
                'logDriver': 'awslogs',
                'options': {
                    'awslogs-group': fargateCfg.logGroup,
                    'awslogs-region':
                        self.ecs.meta.region_name,
                    'awslogs-stream-prefix': 'pyshepseg_tpu_torch',
                }
            }
        runtimePlatform = {'operatingSystemFamily': 'LINUX'}
        if fargateCfg.cpuArchitecture is not None:
            runtimePlatform['cpuArchitecture'] = fargateCfg.cpuArchitecture

        taskDef = self.ecs.register_task_definition(
            family=self.clusterName,
            networkMode='awsvpc',
            requiresCompatibilities=['FARGATE'],
            cpu=fargateCfg.cpu, memory=fargateCfg.memory,
            runtimePlatform=runtimePlatform,
            taskRoleArn=fargateCfg.taskRoleArn,
            executionRoleArn=fargateCfg.executionRoleArn,
            containerDefinitions=containerDefs)
        self.taskDefArn = (
            taskDef['taskDefinition']['taskDefinitionArn'])

        networkConf = {'awsvpcConfiguration': {
            'subnets': [fargateCfg.subnet],
            'securityGroups': fargateCfg.securityGroups or [],
            'assignPublicIp': 'ENABLED'}}
        self.taskArns = []
        for workerID in range(self.concurrencyCfg.numWorkers):
            overrides = {'containerOverrides': [{
                'name': 'pyshepseg_tpu_torch_worker',
                'command': ["--idnum", str(workerID),
                            "--channaddr", self.dataChan.addressStr()],
            }]}
            resp = self.ecs.run_task(cluster=self.clusterName,
                taskDefinition=self.taskDefArn, launchType='FARGATE',
                networkConfiguration=networkConf, overrides=overrides)
            self.taskArns.extend(t['taskArn'] for t in resp['tasks'])

        self.workerBarrier.wait(
            timeout=self.concurrencyCfg.barrierTimeout)

    def shutdown(self):
        if not hasattr(self, 'ecs'):
            return
        # Wait for tasks to drain, then remove the task def and cluster
        deadline = time.time() + 600
        while time.time() < deadline:
            resp = self.ecs.describe_tasks(cluster=self.clusterName,
                                           tasks=self.taskArns)
            still = [t for t in resp['tasks']
                     if t['lastStatus'] != 'STOPPED']
            if not still:
                for t in resp['tasks']:
                    for c in t.get('containers', []):
                        rc = c.get('exitCode')
                        if rc is not None and rc != 0:
                            print("Fargate container exited with",
                                  rc, file=sys.stderr)
                break
            time.sleep(5)
        self.ecs.deregister_task_definition(taskDefinition=self.taskDefArn)
        self.ecs.delete_cluster(cluster=self.clusterName)


class NetworkDataChannel:
    """
    Authenticated-TCP channel carrying the shared coordination objects
    between the coordinator and out-of-process workers, built on
    multiprocessing.managers (reference: tiling.py:1799-1912). The
    object set — work queue, result cache, exit event, error queue,
    pickled job data, read semaphore, timings, start barrier — is
    declared once in OBJECT_NAMES and exposed as get_<name> proxies.

    Construct with keyword data objects to create the server end, or
    with (hostname, portnum, authkey) to connect as a client.
    """

    # attribute name -> proxy registration name
    OBJECT_NAMES = ("inQue", "segResultCache", "forceExit", "exceptionQue",
                    "segDataDict", "readSemaphore", "timings",
                    "workerBarrier")

    def __init__(self, hostname=None, portnum=None, authkey=None,
                 **dataObjects):
        class DataChannelMgr(multiprocessing.managers.BaseManager):
            pass

        asServer = dataObjects.get("inQue") is not None
        if asServer:
            unknown = set(dataObjects) - set(self.OBJECT_NAMES)
            if unknown:
                raise ValueError(f"Unknown channel objects: {unknown}")
            self.hostname = socket.gethostname()
            self.authkey = secrets.token_hex()
            for name in self.OBJECT_NAMES:
                obj = dataObjects.get(name)
                setattr(self, name, obj)
                DataChannelMgr.register("get_" + name.lower(),
                                        callable=(lambda o=obj: o))
            self.mgr = DataChannelMgr(address=(self.hostname, 0),
                                      authkey=bytes(self.authkey, 'utf-8'))
            self.server = self.mgr.get_server()
            self.portnum = self.server.address[1]
            self.threadPool = futures.ThreadPoolExecutor(max_workers=1)
            self.serverThread = self.threadPool.submit(
                self.server.serve_forever)
        elif None not in (hostname, portnum, authkey):
            for name in self.OBJECT_NAMES:
                DataChannelMgr.register("get_" + name.lower())
            self.mgr = DataChannelMgr(address=(hostname, int(portnum)),
                                      authkey=authkey)
            self.hostname = hostname
            self.portnum = int(portnum)
            self.authkey = authkey
            self.mgr.connect()
            for name in self.OBJECT_NAMES:
                setattr(self, name,
                        getattr(self.mgr, "get_" + name.lower())())
        else:
            raise ValueError(
                "Must supply either the channel data objects (server end) "
                "or all of hostname, portnum and authkey (client end)")

    def shutdown(self):
        """
        Shut down in the right order; must be called explicitly by the
        creating process (see reference: tiling.py:1884-1905).
        """
        if hasattr(self, 'server'):
            self.server.stop_event.set()
            futures.wait([self.serverThread])
            self.threadPool.shutdown()

    def addressStr(self):
        """'host,port,authkey' string for worker command lines."""
        return "{},{},{}".format(self.hostname, self.portnum, self.authkey)


class HistogramAccumulator:
    """
    Incremental histogram accumulation with length-growing add; the null
    segment's count is forced to zero (reference: tiling.py:1915-1963).
    """

    def __init__(self):
        self.hist = None

    def doHistAccum(self, arr):
        counts = numpy.bincount(arr.flatten())
        if len(counts) > 0:
            counts[shepseg.SEGNULLVAL] = 0
        self.updateHist(counts)

    @staticmethod
    def addTwoHistograms(hist1, hist2):
        if hist1 is None:
            return hist2
        if len(hist1) > len(hist2):
            hist1[:len(hist2)] += hist2
            return hist1
        hist2[:len(hist1)] += hist1
        return hist2

    def updateHist(self, newCounts):
        if len(newCounts) > 0:
            self.hist = self.addTwoHistograms(self.hist, newCounts)


class SegmentationResultCache:
    """
    Thread-safe per-tile result cache keyed (col, row), with one completion
    event per tile so the stitcher can wait with a timeout
    (reference: tiling.py:1966-2001).
    """

    def __init__(self, colRowList, timeout=None):
        self.timeout = timeout
        self.lock = threading.Lock()
        self.cache = {}
        self.completionEvent = {
            (col, row): threading.Event() for (col, row) in colRowList}

    def addResult(self, col, row, segResult):
        with self.lock:
            key = (col, row)
            self.cache[key] = segResult
            self.completionEvent[key].set()

    def waitForTile(self, col, row):
        key = (col, row)
        completed = self.completionEvent[key].wait(timeout=self.timeout)
        if not completed:
            return None
        segResult = self.cache.pop(key)
        self.completionEvent[key].clear()
        return segResult


# ------------------------------------------------------------------------
# Decomposed 3-phase API, as used by distributed batch pipelines
# (reference: parallel_examples/awsbatch/do_prepare.py:116,
#  do_tile.py:101, do_stitch.py:103 — the monolithic driver above is
#  built from the same pieces).


def doTiledShepherdSegmentation_prepare(infile, tileSize=DFLT_TILESIZE,
        overlapSize=DFLT_OVERLAPSIZE, numClusters=60, bandNumbers=None,
        subsamplePcnt=None, imgNullVal=None, fixedKMeansInit=False,
        kmeansObj=None, verbose=False, tileGrid='uniform', device="cuda"):
    """
    Phase 1: fit the whole-file k-means model on ``device`` and build the
    tile grid (``tileGrid`` as in getTilesForFile).

    Returns (inDs, bandNumbers, kmeansObj, subsamplePcnt, imgNullVal,
    tileInfo).
    """
    device = _kernels.torch_device(device)
    if verbose:
        print("Starting tiled segmentation")
    if (overlapSize % 2) != 0:
        raise PyShepSegTilingError("Overlap size must be an even number")

    inDs = rio.open(infile)
    if bandNumbers is None:
        bandNumbers = range(1, inDs.RasterCount + 1)

    if kmeansObj is None:
        (kmeansObj, subsamplePcnt, imgNullVal) = (
            fitSpectralClustersWholeFile(inDs, bandNumbers, numClusters,
                                         subsamplePcnt, imgNullVal,
                                         fixedKMeansInit, device))
    elif imgNullVal is None:
        imgNullVal = getImgNullValue(inDs, bandNumbers)

    tileInfo = getTilesForFile(inDs, tileSize, overlapSize, tileGrid)
    if verbose:
        print("Found {} tiles, with {} rows and {} cols".format(
            tileInfo.getNumTiles(), tileInfo.nrows, tileInfo.ncols))

    return (inDs, bandNumbers, kmeansObj, subsamplePcnt, imgNullVal,
            tileInfo)


def doTiledShepherdSegmentation_doOne(inDs, filename, tileInfo, col, row,
        bandNumbers, imgNullVal, kmeansObj, minSegmentSize=50,
        maxSpectralDiff='auto', fourConnected=True, verbose=False,
        spectDistPcntile=50, tempfilesDriver=DFLT_TEMPFILES_DRIVER,
        tempfilesCreationOptions=[], device="cuda"):
    """
    Phase 2: segment one tile on ``device`` and write it to ``filename``
    (a standalone raster, so decoupled workers can ship tiles via object
    storage).

    Returns the SegmentationResult.
    """
    device = _kernels.torch_device(device)
    if isinstance(inDs, str):
        inDs = rio.open(inDs)
    (xpos, ypos, xsize, ysize) = tileInfo.getTile(col, row)
    lyrDataList = []
    for bandNum in bandNumbers:
        lyr = inDs.GetRasterBand(bandNum)
        lyrDataList.append(lyr.ReadAsArray(xpos, ypos, xsize, ysize))
    img = numpy.array(lyrDataList)

    segResult = shepseg.doShepherdSegmentation(
        img, minSegmentSize=minSegmentSize,
        maxSpectralDiff=maxSpectralDiff, imgNullVal=imgNullVal,
        fourConnected=fourConnected, kmeansObj=kmeansObj,
        verbose=verbose, spectDistPcntile=spectDistPcntile, device=device)

    driverName = tempfilesDriver if rio.HAVE_GDAL else None
    outDs = rio.create(filename, xsize, ysize, 1, shepseg.SegIdType,
                       driverName, tempfilesCreationOptions)
    proj = inDs.GetProjection()
    if proj:
        outDs.SetProjection(proj)
    transform = inDs.GetGeoTransform()
    if transform is not None:
        subsetTransform = list(transform)
        subsetTransform[0] = transform[0] + xpos * transform[1]
        subsetTransform[3] = transform[3] + ypos * transform[5]
        outDs.SetGeoTransform(tuple(subsetTransform))
    b = outDs.GetRasterBand(1)
    b.WriteArray(segResult.segimg)
    b.SetMetadataItem('LAYER_TYPE', 'thematic')
    b.SetNoDataValue(int(shepseg.SEGNULLVAL))
    outDs.FlushCache()
    del outDs
    return segResult


class _FinalizeStitcher(SegNoConcurrencyMgr):
    """Internal: stitcher wired to pre-segmented tile files on disk."""

    def __init__(self, tileFilenames, tileInfo, overlapSize, tempDir,
                 inDs, outfile, outputDriver, creationOptions, verbose,
                 simpleTileRecode, writeHistogram):
        # Deliberately not calling super().__init__ — this object is only
        # used for the stitching phase.
        self.tileFilenames = tileFilenames
        self.tileInfo = tileInfo
        self.overlapSize = overlapSize
        self.tempDir = tempDir
        self.outfile = outfile
        self.outputDriver = outputDriver
        self.creationOptions = creationOptions
        self.verbose = verbose
        self.simpleTileRecode = simpleTileRecode
        self.writeHistogram = writeHistogram
        self.returnGDALDS = True
        self.timings = timinghooks.Timers()
        self.inXsize = inDs.RasterXSize
        self.inYsize = inDs.RasterYSize
        self.inProj = inDs.GetProjection()
        self.inGeoTransform = inDs.GetGeoTransform()

    def getTileSegmentation(self, col, row):
        filename = self.tileFilenames[(col, row)]
        if filename.endswith('.npy'):
            return numpy.load(filename)
        ds = rio.open(filename)
        return ds.GetRasterBand(1).ReadAsArray()


def doTiledShepherdSegmentation_finalize(inDs, outfile, tileFilenames,
        tileInfo, overlapSize, tempDir, simpleTileRecode=False,
        outputDriver='KEA', creationOptions=[], verbose=False,
        writeHistogram=True):
    """
    Phase 3: stitch pre-segmented tile rasters into the final output
    (host numpy only, so it takes no ``device``).

    Returns (maxSegId, hasEmptySegments, localDs).
    """
    if isinstance(inDs, str):
        inDs = rio.open(inDs)
    stitcher = _FinalizeStitcher(tileFilenames, tileInfo, overlapSize,
                                 tempDir, inDs, outfile, outputDriver,
                                 creationOptions, verbose, simpleTileRecode,
                                 writeHistogram)
    stitcher.stitchTiles()
    return (stitcher.maxSegId, stitcher.hasEmptySegments, stitcher.outDs)


# ------------------------------------------------------------------------
# Deprecated, kept for API parity (reference: tiling.py:2012-2116)


def updateCounts(tileData, hist):
    """
    Add the tile's per-segment-ID pixel counts into ``hist`` in place
    (reference: tiling.py:2106-2116 — a numba per-pixel loop there, a
    vectorized bincount here). IDs beyond len(hist)-1 are ignored.
    """
    counts = numpy.bincount(tileData.ravel(), minlength=len(hist))
    hist += counts[:len(hist)].astype(hist.dtype)


def calcHistogramTiled(segfile, maxSegId, writeToRat=True):
    """
    Deprecated: tile-wise histogram of a segmentation raster, optionally
    written to the RAT (the histogram is now accumulated during stitching).
    """
    utils.deprecationWarning(
        "The calcHistogramTiled function is obsolete, as histogram of "
        "segmentation raster is now calculated as tiles are written.")

    hist = numpy.zeros((maxSegId + 1), dtype=numpy.uint32)
    ds = rio.open(segfile, rio.GA_Update)
    segband = ds.GetRasterBand(1)

    tileSize = TILESIZE
    (nlines, npix) = (segband.YSize, segband.XSize)
    for topLine in range(0, nlines, tileSize):
        for leftPix in range(0, npix, tileSize):
            xsize = min(tileSize, npix - leftPix)
            ysize = min(tileSize, nlines - topLine)
            tileData = segband.ReadAsArray(leftPix, topLine, xsize, ysize)
            updateCounts(tileData, hist)

    hist[shepseg.SEGNULLVAL] = 0

    if writeToRat:
        attrTbl = segband.GetDefaultRAT()
        if attrTbl.GetRowCount() != int(maxSegId + 1):
            attrTbl.SetRowCount(int(maxSegId + 1))
        colNum = attrTbl.GetColOfUsage(rio.GFU_PixelCount)
        if colNum == -1:
            attrTbl.CreateColumn('Histogram', rio.GFT_Real,
                                 rio.GFU_PixelCount)
            colNum = attrTbl.GetColumnCount() - 1
        attrTbl.WriteArray(hist, colNum)

    return hist
