"""
Multi-host tiled segmentation, one process per host
(counterpart: pyshepseg_tpu/parallel/dcn.py).

The control plane rides a ``torch.distributed.TCPStore`` that process 0
serves: named barriers, and a key-value store for broadcast (the fitted
k-means model, the tile grid) and for shipping worker status/error records
and timing merges. No process group and no NCCL are needed, because the
data plane is per host: every process segments its round-robin shard of
tiles on its own local devices (dealt across them with the CONC_MESH batch
path when there is more than one) and writes the results to shared storage
(an NFS mount, or any path-addressable store); process 0 stitches.

Launch the SAME program on every host, each with its process id, e.g.
through ``pyshepseg_tpu_torch_dcnworkercmd`` or by calling
:func:`doTiledShepherdSegmentationDistributed` from a script. The same
code runs N processes on one host (tests/test_torch_dcn.py), where every
process of a one-card job uses ``cuda:0``.
"""

import os
import time
import pickle
import hashlib
import datetime
import traceback

import numpy as np
import torch

from .. import _kernels
from .. import tiling as _tiling
from .. import shepseg
from .. import timinghooks


class PyShepSegDCNError(Exception):
    pass


_STATUS_OK = "ok"


class DistributedContext:
    """
    Thin wrapper over a ``torch.distributed.TCPStore``: named barriers and
    a pickled-object key-value store. ``coordinatorAddress`` is
    ``host:port`` of process 0, which serves the store; every process
    gives the same ``numProcesses`` and its own ``processId``.
    """

    def __init__(self, coordinatorAddress=None, numProcesses=None,
                 processId=None, timeoutMs=None):
        import torch.distributed as dist

        if None in (coordinatorAddress, numProcesses, processId):
            raise ValueError(
                "coordinatorAddress (host:port), numProcesses and "
                "processId are required: nothing discovers them here")
        if timeoutMs is None:
            timeoutMs = 300000
        # Env floor: N processes on one loaded host (a test suite running
        # beside them) can miss the startup barrier purely from load.
        # PYSHEPSEG_TPU_DCN_TIMEOUT_MS lets a loaded runner raise every
        # barrier/KV deadline at once without touching call sites (it
        # never lowers an explicit timeout).
        envFloor = int(os.environ.get("PYSHEPSEG_TPU_DCN_TIMEOUT_MS", "0"))
        self.timeoutMs = max(int(timeoutMs), envFloor)
        self.timeout = datetime.timedelta(milliseconds=self.timeoutMs)
        self.jobTag = "job"
        self.processId = int(processId)
        self.numProcesses = int(numProcesses)
        host, _, port = str(coordinatorAddress).rpartition(":")
        # the constructor returns once every process has connected
        self.store = dist.TCPStore(
            host, int(port), self.numProcesses, self.processId == 0,
            timeout=self.timeout, wait_for_workers=True)

    def barrier(self, name):
        """Return once every process has called barrier(name): each adds
        one to the barrier's counter, the last one in sets its release
        key, the others wait for that key (up to the timeout)."""
        if self.store.add(name + "/count", 1) == self.numProcesses:
            self.store.set(name + "/release", b"1")
        else:
            self.store.wait([name + "/release"], self.timeout)

    def putObj(self, key, obj):
        self.store.set(key, pickle.dumps(obj))

    def getObj(self, key):
        self.store.wait([key], self.timeout)
        return pickle.loads(self.store.get(key))

    def shutdown(self):
        """Close the store this context opened. Every other process signs
        off first; process 0, whose store serves them, waits for that (up
        to the timeout), so no process loses the server mid-request."""
        if self.store is None:
            return
        key = "pyshepseg/%s/signedoff" % self.jobTag
        try:
            if self.processId != 0:
                self.store.add(key, 1)
            else:
                deadline = time.time() + self.timeoutMs / 1e3
                while (self.store.add(key, 0) < self.numProcesses - 1 and
                       time.time() < deadline):
                    time.sleep(0.01)
        finally:
            self.store = None


def _localDevices(device, localDevices):
    """The devices this process segments on: ``localDevices`` where given;
    else every visible CUDA device for ``device`` "cuda" (no index), and
    ``device`` alone for a CPU device or a card named by its index."""
    if localDevices is not None:
        return _kernels.device_list(localDevices)
    device = _kernels.torch_device(device)
    if device.type == 'cuda' and device.index is None:
        return _kernels.cuda_devices()
    return [device]


def _segmentTileShard(ctx, inDs, tileInfo, myTiles, bandNumbers,
                      imgNullVal, kmeansObj, minSegmentSize,
                      maxSpectralDiff, fourConnected, spectDistPcntile,
                      workDir, verbose, timings, tilesPerDevice=1,
                      device="cuda", localDevices=None):
    """
    Segment this process's tiles on its local devices and write each as
    workDir/tile_<col>_<row>.npy. With more than one local device (and
    more than one tile), tiles are dealt across them with the CONC_MESH
    batch path (``tilesPerDevice`` tiles per device per step, see
    SegmentationConcurrencyConfig); otherwise the per-tile
    doShepherdSegmentation runs on the one device. ``localDevices`` is
    the list of this host's devices (see :func:`_localDevices`; one may
    appear more than once). Returns {(col, row): filename}.
    """
    filenames = {}
    localDevices = _localDevices(device, localDevices)

    def writeTile(colRow, seg):
        fn = os.path.join(workDir,
                          "tile_{}_{}.npy".format(colRow[0], colRow[1]))
        np.save(fn, np.asarray(seg).astype(shepseg.SegIdType))
        filenames[colRow] = fn

    def readTile(colRow):
        (xpos, ypos, xsize, ysize) = tileInfo.getTile(*colRow)
        return np.array([
            inDs.GetRasterBand(b).ReadAsArray(xpos, ypos, xsize, ysize)
            for b in bandNumbers])

    if len(localDevices) <= 1 or len(myTiles) <= 1:
        for colRow in myTiles:
            with timings.interval('reading'):
                img = readTile(colRow)
            with timings.interval('segmentation'):
                segResult = shepseg.doShepherdSegmentation(
                    img, minSegmentSize=minSegmentSize,
                    maxSpectralDiff=maxSpectralDiff,
                    imgNullVal=imgNullVal, fourConnected=fourConnected,
                    kmeansObj=kmeansObj, verbose=verbose,
                    spectDistPcntile=spectDistPcntile,
                    device=localDevices[0])
            writeTile(colRow, segResult.segimg)
        return filenames

    # deal tiles over the local devices with the CONC_MESH batch path
    from .mesh import segment_tile_batch
    from ..ops.kmeans import null_scalar

    tilesPerDevice = max(1, int(tilesPerDevice))
    chunkSize = len(localDevices) * tilesPerDevice
    hasNull = imgNullVal is not None
    # native-dtype null scalar: a float32 round trip aliases large
    # integer null values (ops/kmeans null_scalar)
    imgDtype = inDs.GetRasterBand(
        bandNumbers[0]).ReadAsArray(0, 0, 1, 1).dtype
    nullVal = null_scalar(imgNullVal if hasNull else 0, imgDtype)
    maxDiff = shepseg.autoMaxSpectralDiff(
        kmeansObj, maxSpectralDiff, spectDistPcntile)
    centers = np.asarray(kmeansObj.cluster_centers_, dtype=np.float32)

    groups = {}
    for colRow in myTiles:
        (_, _, xsize, ysize) = tileInfo.getTile(*colRow)
        groups.setdefault((ysize, xsize), []).append(colRow)

    for members in groups.values():
        for startNdx in range(0, len(members), chunkSize):
            chunk = members[startNdx:startNdx + chunkSize]
            with timings.interval('reading'):
                batch = [torch.from_numpy(readTile(colRow)).to(
                    localDevices[j // tilesPerDevice])
                    for j, colRow in enumerate(chunk)]
            with timings.interval('segmentation'):
                segs, _ = segment_tile_batch(
                    batch, centers, nullVal, maxDiff, minSegmentSize,
                    fourConnected, hasNull)
            for i, colRow in enumerate(chunk):
                writeTile(colRow, segs[i])
    return filenames


def doTiledShepherdSegmentationDistributed(infile, outfile, workDir,
        tileSize=_tiling.DFLT_TILESIZE,
        overlapSize=_tiling.DFLT_OVERLAPSIZE, minSegmentSize=50,
        numClusters=60, bandNumbers=None, subsamplePcnt=None,
        maxSpectralDiff='auto', imgNullVal=None, fixedKMeansInit=False,
        fourConnected=True, verbose=False, simpleTileRecode=False,
        outputDriver='KEA', creationOptions=[], spectDistPcntile=50,
        kmeansObj=None, writeHistogram=True, tileGrid='uniform',
        coordinatorAddress=None, numProcesses=None, processId=None,
        barrierTimeout=600, tilesPerDevice=1, device="cuda",
        localDevices=None):
    """
    Multi-process tiled segmentation across hosts. Run this function in
    every process of the job (one per host). ``workDir`` must be shared
    storage visible to all hosts; temp tiles are written there and
    stitched by process 0.

    Control plane: a TCPStore served by process 0 at
    ``coordinatorAddress`` (barriers + KV broadcast of the fitted k-means
    model and tile grid, worker status and error records, timing merge):
    the reference protocol's queue / barrier / exception semantics
    (reference: pyshepseg/tiling.py:1799-1912). Compute: each host's
    local devices: ``device`` "cuda" (the default; raises when CUDA is
    absent) is every visible card of the host, "cuda:N" that one card,
    "cpu" the CPU; ``localDevices`` names them explicitly.

    Returns a TiledSegmentationResult on process 0; None elsewhere.
    """
    device = _kernels.torch_device(device)
    ctx = DistributedContext(coordinatorAddress, numProcesses, processId,
                             timeoutMs=barrierTimeout * 1000)
    # Distinct KV/barrier names per job, so several segmentations can run
    # through one long-lived store without key collisions (re-running the
    # IDENTICAL job in one store's lifetime still collides: use a fresh
    # workDir per run).
    ctx.jobTag = hashlib.md5(
        f"{infile}|{outfile}|{workDir}".encode()).hexdigest()[:12]
    timings = timinghooks.Timers()
    try:
        with timings.interval('walltime'):
            return _runDistributed(
                ctx, infile, outfile, workDir, tileSize, overlapSize,
                minSegmentSize, numClusters, bandNumbers, subsamplePcnt,
                maxSpectralDiff, imgNullVal, fixedKMeansInit,
                fourConnected, verbose, simpleTileRecode, outputDriver,
                creationOptions, spectDistPcntile, kmeansObj,
                writeHistogram, tileGrid, timings, tilesPerDevice, device,
                localDevices)
    finally:
        ctx.shutdown()


def _runDistributed(ctx, infile, outfile, workDir, tileSize, overlapSize,
                    minSegmentSize, numClusters, bandNumbers,
                    subsamplePcnt, maxSpectralDiff, imgNullVal,
                    fixedKMeansInit, fourConnected, verbose,
                    simpleTileRecode, outputDriver, creationOptions,
                    spectDistPcntile, kmeansObj, writeHistogram, tileGrid,
                    timings, tilesPerDevice=1, device="cuda",
                    localDevices=None):
    from .. import io as rio

    pid = ctx.processId
    nproc = ctx.numProcesses

    # ---- prepare phase on process 0, broadcast over the KV store ----
    if pid == 0:
        with timings.interval('spectralclusters'):
            (inDs, bandNumbers, kmeansObj, subsamplePcnt, imgNullVal,
             tileInfo) = _tiling.doTiledShepherdSegmentation_prepare(
                infile, tileSize, overlapSize, numClusters, bandNumbers,
                subsamplePcnt, imgNullVal, fixedKMeansInit, kmeansObj,
                verbose, tileGrid,
                device=_localDevices(device, localDevices)[0])
        ctx.putObj(f"pyshepseg/{ctx.jobTag}/prepare", {
            'bandNumbers': list(bandNumbers), 'kmeansObj': kmeansObj,
            'imgNullVal': imgNullVal, 'tileInfo': tileInfo,
            'maxSpectralDiff': maxSpectralDiff})
    ctx.barrier(f"pyshepseg_{ctx.jobTag}_prepared")
    if pid != 0:
        prep = ctx.getObj(f"pyshepseg/{ctx.jobTag}/prepare")
        bandNumbers = prep['bandNumbers']
        kmeansObj = prep['kmeansObj']
        imgNullVal = prep['imgNullVal']
        tileInfo = prep['tileInfo']
        maxSpectralDiff = prep['maxSpectralDiff']
        inDs = rio.open(infile)

    # ---- segment this process's round-robin tile shard ----
    colRowList = sorted(tileInfo.tiles.keys(), key=lambda x: (x[1], x[0]))
    myTiles = [cr for i, cr in enumerate(colRowList) if i % nproc == pid]
    status = _STATUS_OK
    filenames = {}
    try:
        filenames = _segmentTileShard(
            ctx, inDs, tileInfo, myTiles, bandNumbers, imgNullVal,
            kmeansObj, minSegmentSize, maxSpectralDiff, fourConnected,
            spectDistPcntile, workDir, verbose, timings, tilesPerDevice,
            device, localDevices)
    except Exception:
        status = "error:" + traceback.format_exc()
    ctx.putObj(f"pyshepseg/{ctx.jobTag}/worker_{pid}", {
        'status': status, 'filenames': filenames, 'timings': timings})
    ctx.barrier(f"pyshepseg_{ctx.jobTag}_segmented")

    if pid != 0:
        # hold workers until the stitch completes, so a launcher that
        # tears down shared storage on job exit cannot race it
        ctx.barrier(f"pyshepseg_{ctx.jobTag}_done")
        return None

    # ---- stitch on process 0 ----
    tileFilenames = {}
    for i in range(nproc):
        record = ctx.getObj(f"pyshepseg/{ctx.jobTag}/worker_{i}")
        if record['status'] != _STATUS_OK:
            ctx.barrier(f"pyshepseg_{ctx.jobTag}_done")
            raise PyShepSegDCNError(
                "Worker process {} failed:\n{}".format(
                    i, record['status'][len('error:'):]))
        tileFilenames.update(record['filenames'])
        if i != 0:
            timings.merge(record['timings'])

    with timings.interval('stitchtiles'):
        (maxSegId, hasEmptySegments, outDs) = (
            _tiling.doTiledShepherdSegmentation_finalize(
                inDs, outfile, tileFilenames, tileInfo, overlapSize,
                workDir, simpleTileRecode, outputDriver, creationOptions,
                verbose, writeHistogram))
    ctx.barrier(f"pyshepseg_{ctx.jobTag}_done")

    result = _tiling.TiledSegmentationResult()
    result.maxSegId = maxSegId
    result.numTileRows = tileInfo.nrows
    result.numTileCols = tileInfo.ncols
    result.subsamplePcnt = subsamplePcnt
    # resolve 'auto'/None to the numeric value the workers actually used
    # (the serial/mesh drivers store the resolved float too)
    result.maxSpectralDiff = shepseg.autoMaxSpectralDiff(
        kmeansObj, maxSpectralDiff, spectDistPcntile)
    result.kmeans = kmeansObj
    result.hasEmptySegments = hasEmptySegments
    result.timings = timings
    result.outDs = outDs
    return result
