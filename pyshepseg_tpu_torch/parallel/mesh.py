"""
CONC_MESH: tile-parallel segmentation across the devices of one host
(counterpart: pyshepseg_tpu/parallel/mesh.py).

Instead of scheduling Python workers, the tiles of a scene are taken in
chunks of ``nDev * tilesPerDevice`` and dealt to an explicit list of
``torch.device``s, contiguous runs of ``tilesPerDevice`` tiles to each,
and every device runs the device-resident pipeline
(parallel.pipeline.segment_tile, kernels K1 and K2 inside it) on its
share. Tiles are independent, so nothing is exchanged between devices
while they segment; the stitch consumes the results in row-major order
exactly as the serial backend does.

The JAX package shards one stacked batch over a ``jax.sharding.Mesh`` and
runs one SPMD program; here a batch is a list of tile tensors, each on its
device. Where the list holds more than one distinct device, one host
thread per device runs that device's share on a CUDA stream of its own
(the per-tile pipeline waits for its device at every loop decision, so a
single thread would run the cards one after the other). The list may name
one device more than once, which deals that device several shares.
"""

import contextlib
import os
import shutil
import tempfile
import threading

import numpy as np
import torch

from .. import _kernels
from .. import tiling as _tiling
from .. import shepseg
from .pipeline import segment_tile


@contextlib.contextmanager
def _shareStream(device, inputs):
    """Run the block's work on a CUDA ``device`` on a stream of its own,
    which first waits for the work queued on the device's current stream
    (the copies that placed ``inputs`` there); ``inputs`` are marked as in
    use on it for the caching allocator. A CPU device runs the block as
    is."""
    if device.type != 'cuda':
        yield
        return
    stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    for t in inputs:
        t.record_stream(stream)
    with torch.cuda.stream(stream):
        yield
        stream.synchronize()


def _runShares(shares, runShare):
    """Call ``runShare(device, indices)`` for every item of ``shares``: in
    this thread where there is one share, else each in a thread of its
    own, all joined. The first exception of a share is raised here."""
    if len(shares) == 1:
        (device, indices), = shares.items()
        runShare(device, indices)
        return
    errors = []

    def guarded(device, indices):
        try:
            runShare(device, indices)
        except Exception as e:
            errors.append(e)

    threads = [threading.Thread(target=guarded, args=item)
               for item in shares.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]


def segment_tile_batch(batch, centers, nullVal, maxDiff, minSegmentSize,
                       fourConnected, hasNull, segCapacity=None,
                       specBuckets=None):
    """
    Segment one batch of tiles: ``batch`` is a list of (nBands, H, W)
    tile tensors, each on the device that is to segment it; ``centers``
    the (K, nBands) cluster centres (numpy or a tensor), ``nullVal`` the
    null value in the imagery's type and ``maxDiff`` the resolved spectral
    limit. Tiles on one device run in their order in the list; where the
    batch lies on more than one device, each device's share runs in a
    thread and on a stream of its own. ``segCapacity`` and ``specBuckets``
    (XLA capacity buckets in the JAX package) are accepted and ignored.

    Returns (segs numpy uint32 (B, H, W), None); the JAX package's second
    value is the buckets to speculate with on the next batch.

    Shared by the CONC_MESH backend and the per-host shard path of the
    DCN backend.
    """
    centers = torch.as_tensor(np.asarray(
        centers.cpu() if isinstance(centers, torch.Tensor) else centers,
        dtype=np.float32))
    shares = {}
    for i, img in enumerate(batch):
        shares.setdefault(img.device, []).append(i)
    # every tile's labels are copied from its device straight into the
    # batch's array (int32 ids are non-negative: reinterpreted at the end)
    segs = np.empty((len(batch),) + tuple(batch[0].shape[1:]), np.int32)

    def runShare(device, indices):
        ctx = (_shareStream(device, [batch[i] for i in indices])
               if len(shares) > 1 else contextlib.nullcontext())
        with ctx:
            centersDev = centers.to(device)
            for i in indices:
                seg, _ = segment_tile(
                    batch[i], centersDev, nullVal, maxDiff,
                    int(minSegmentSize), bool(fourConnected), bool(hasNull))
                torch.from_numpy(segs[i]).copy_(seg)

    _runShares(shares, runShare)
    return segs.view(shepseg.SegIdType), None


class SegMeshMgr(_tiling.SegmentationConcurrencyMgr):
    """
    Segment tiles in batches across a list of devices.

    Extra knobs (set as attributes after construction, or on the class, or
    leave the defaults):
    - ``meshDevices``: the devices to use, a sequence of torch.devices or
      their names, in which one device may appear more than once (default:
      every visible CUDA device when the run's ``device`` is a CUDA
      device, else that ``device`` alone)
    - ``segCapacity``: accepted and ignored (XLA's static per-tile segment
      capacity in the JAX package)
    """
    concurrencyType = _tiling.CONC_MESH

    meshDevices = None
    segCapacity = None

    def specificChecks(self):
        # numWorkers is meaningless here; the device count rules
        pass

    def _resolveMaxSpectralDiff(self):
        self.maxSpectralDiff = shepseg.autoMaxSpectralDiff(
            self.kmeansObj, self.maxSpectralDiff, self.spectDistPcntile)

    def _devices(self):
        if self.meshDevices is not None:
            return _kernels.device_list(self.meshDevices)
        if self.device.type == 'cuda':
            return _kernels.cuda_devices()
        return [self.device]

    def segmentAllTiles(self):
        from .. import io as rio
        from ..ops.kmeans import null_scalar

        devices = self._devices()
        tilesPerDevice = getattr(self.concurrencyCfg, 'tilesPerDevice', 1)
        chunkSize = len(devices) * tilesPerDevice

        self._resolveMaxSpectralDiff()
        hasNull = self.imgNullVal is not None
        centers = np.asarray(self.kmeansObj.cluster_centers_,
                             dtype=np.float32)

        self.tempDir = tempfile.mkdtemp()
        self.tileFilenames = {}
        inDs = rio.open(self.infile)
        # null scalar in the imagery's native dtype (a float32 round
        # trip would alias large integer null values)
        imgDtype = inDs.GetRasterBand(
            self.bandNumbers[0]).ReadAsArray(0, 0, 1, 1).dtype
        nullVal = null_scalar(self.imgNullVal if hasNull else 0, imgDtype)
        # whole-scene cache on the run's device: read and copied once,
        # each overlapping tile then a slice that goes to its device
        self.maybeBuildSceneCache(inDs)

        colRowList = sorted(self.tileInfo.tiles.keys(),
                            key=lambda x: (x[1], x[0]))

        # tiles grouped by shape, as the JAX package's compiled groups
        groups = {}
        for colRow in colRowList:
            (xpos, ypos, xsize, ysize) = self.tileInfo.getTile(*colRow)
            groups.setdefault((ysize, xsize), []).append(colRow)

        for members in groups.values():
            for start in range(0, len(members), chunkSize):
                chunk = members[start:start + chunkSize]
                with self.timings.interval('reading'):
                    # tile j of the chunk goes to device j // tilesPerDevice
                    # (the contiguous split of a batch over the mesh); a
                    # short last chunk is not padded
                    batch = []
                    for j, (col, row) in enumerate(chunk):
                        img = self.readTileImage(inDs, col, row)
                        if not isinstance(img, torch.Tensor):
                            img = torch.from_numpy(img)
                        batch.append(img.to(devices[j // tilesPerDevice]))

                with self.timings.interval('segmentation'):
                    segs, _ = segment_tile_batch(
                        batch, centers, nullVal, self.maxSpectralDiff,
                        self.minSegmentSize, self.fourConnected, hasNull,
                        self.segCapacity)
                del batch

                for i, (col, row) in enumerate(chunk):
                    filename = os.path.join(
                        self.tempDir, 'tile_{}_{}.npy'.format(col, row))
                    np.save(filename, segs[i])
                    self.tileFilenames[(col, row)] = filename

        with self.timings.interval('stitchtiles'):
            self.stitchTiles()

        shutil.rmtree(self.tempDir)

    # temp-file plumbing (same shape as the serial manager's)
    def overlapCacheFilename(self, overlapCacheKey):
        return os.path.join(self.tempDir, f"{overlapCacheKey}.npy")

    def saveOverlap(self, overlapCacheKey, overlapData):
        np.save(self.overlapCacheFilename(overlapCacheKey), overlapData)

    def loadOverlap(self, overlapCacheKey):
        return np.load(self.overlapCacheFilename(overlapCacheKey))

    def getTileSegmentation(self, col, row):
        return np.load(self.tileFilenames[(col, row)])

    def checkWorkerExceptions(self):
        """No async workers; exceptions raise inline."""
