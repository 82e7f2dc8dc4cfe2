"""
Device run compaction for the per-segment statistics engine
(counterpart: pyshepseg_tpu/ops/segstats.py).

The stats pass compacts each tile's (segment id, pixel value) pairs into
runs sorted by (segId, value) with their pixel counts: the format of the
host ``tilingstats.compactTile``, so the streaming accumulator and every
statistic downstream are bit-for-bit the same whichever engine produced
the runs.

Here that is one int64 key and one sort. Null-segment pixels are dropped
first; every other pixel becomes ``key = segId * 2**32 + (value -
INT32_MIN)``, which orders the pairs as the two-key sort does for every
supported imagery dtype (all values fit int32) and every segment id below
2**31. ``torch.sort`` sorts the keys, and the run starts (where a key
differs from the one before it) give the runs and their counts. The
multi-band forms sort a (nBands, n) key array along its last axis and
find every band's runs at once, so the bands of a window share their host
syncs. NoData runs are split out on the host, as in the JAX package.

The JAX package's power-of-two pixel and run buckets, its two-dispatch
run slice and its packed 16-bit sort have no counterpart: they exist for
XLA's static shapes.
"""

import numpy as np
import torch

from .. import _kernels
from .constants import SEGNULLVAL

# imagery dtypes whose values always fit the int32 half of the sort key
_DEVICE_OK_DTYPES = (np.int8, np.uint8, np.int16, np.uint16, np.int32)
_INT32_MIN = -2 ** 31
# segment ids fill the key's upper 31 bits
MAX_NUM_SEG = 2 ** 31


def deviceCompactSupported(dtype):
    """Can tiles of this imagery dtype be compacted on the device? (int64
    and uint32 rasters may hold values outside int32: use the host
    path.)"""
    return any(np.issubdtype(dtype, d) for d in _DEVICE_OK_DTYPES)


def uploadInt32(arr, device):
    """A numpy integer array (imagery of a supported dtype, or segment
    ids) as an int32 tensor on ``device`` with the same values. The
    array's own bytes cross to the device and widen there; uint16 goes as
    its int16 view and is masked back (torch has few ops for uint16),
    uint32 as its int32 view (segment ids, below 2**31)."""
    a = np.ascontiguousarray(arr)
    if a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16)).to(device).int() & 0xFFFF
    if a.dtype == np.uint32:
        return torch.from_numpy(a.view(np.int32)).to(device)
    return torch.from_numpy(a).to(device).int()


def windowRuns(seg, vals, imgNullVals, numSeg, imageValueType=np.int64):
    """
    Compact one window on the device of its tensors: ``seg`` (h, w) and
    ``vals`` (nBands, h, w) integer tensors (segment ids below 2**31,
    values in int32). Returns a list aligned with the bands whose entries
    are compactTile's ``(seen, noData, runSeg, runVal, runCnt)`` tuples,
    or None for an all-null window. ``windowRuns.cuda_calls`` counts the
    calls on a CUDA device.
    """
    if numSeg > MAX_NUM_SEG:
        raise ValueError("device compaction takes segment ids below 2**31")
    if seg.is_cuda:
        _kernels.count(windowRuns, "cuda_calls")
    nb = vals.shape[0]
    s = seg.reshape(-1)
    keep = torch.nonzero(s != SEGNULLVAL).squeeze(1)
    m = keep.numel()
    if m == 0:
        return [None] * nb
    s = s[keep].long()
    v = vals.reshape(nb, -1)[:, keep].long()
    key = torch.sort((s << 32) + (v - _INT32_MIN), dim=-1).values.reshape(-1)
    first = torch.ones_like(key, dtype=torch.bool)
    first[1:] = key[1:] != key[:-1]
    first[::m] = True               # every band's runs start afresh
    starts = torch.nonzero(first).squeeze(1)
    counts = torch.diff(starts, append=starts.new_tensor([key.numel()]))
    runKey, runCnt, runBand = torch.stack(
        [key[starts], counts, starts // m]).cpu().numpy()
    bounds = np.searchsorted(runBand, np.arange(nb + 1))
    out = []
    for i in range(nb):
        k = runKey[bounds[i]:bounds[i + 1]]
        out.append(_splitRuns(k >> 32, (k & 0xFFFFFFFF) + _INT32_MIN,
                              runCnt[bounds[i]:bounds[i + 1]],
                              imgNullVals[i], numSeg, imageValueType))
    return out


windowRuns.cuda_calls = 0


def _splitRuns(runSeg, runVal, runCnt, imgNullVal, numSeg, imageValueType):
    """Host tail for one band: seen and nodata counts per segment, and
    the runs without the nodata value."""
    runVal = runVal.astype(imageValueType)
    seen = np.bincount(runSeg, weights=runCnt,
                       minlength=numSeg).astype(np.int64)[:numSeg]
    noData = None
    if imgNullVal is not None:
        isNull = runVal == imageValueType(imgNullVal)
        if isNull.any():
            noData = np.bincount(
                runSeg[isNull], weights=runCnt[isNull],
                minlength=numSeg).astype(np.int64)[:numSeg]
        keep = ~isNull
        runSeg, runVal, runCnt = runSeg[keep], runVal[keep], runCnt[keep]
    return (seen, noData, runSeg, runVal, runCnt)


def compactTileDevice(tileSegments, tileImageData, imgNullVal, numSeg,
                      imageValueType=np.int64, device="cuda"):
    """
    Device equivalent of tilingstats.compactTile: returns
    (seenCounts, noDataCounts-or-None, runSegIds, runValues, runCounts)
    with runs sorted by (segId, value), or None for an all-null tile —
    identical output to the host path for any imagery whose dtype passes
    deviceCompactSupported. The numpy tile goes to ``device`` ("cuda"
    raises where CUDA is absent).
    """
    return compactTileDeviceMultiBand(
        tileSegments, [tileImageData], [imgNullVal], numSeg,
        imageValueType, device)[0]


def compactTileDeviceMultiBand(tileSegments, tileImageList, imgNullVals,
                               numSeg, imageValueType=np.int64,
                               device="cuda"):
    """
    Compact every band of one tile window in one sort: returns a list
    aligned with ``tileImageList`` whose entries equal compactTileDevice's
    (None for an all-null tile).
    """
    device = _kernels.torch_device(device)
    seg = uploadInt32(tileSegments, device)
    vals = torch.stack([uploadInt32(t, device) for t in tileImageList])
    return windowRuns(seg, vals, imgNullVals, numSeg, imageValueType)


def compactSceneWindowDevice(segDev, valDev, window, imgNullVal, numSeg,
                             imageValueType=np.int64):
    """compactTileDevice, fed from whole-scene tensors on the device
    (``segDev`` (H, W) segment ids and ``valDev`` (H, W) values, as
    :func:`uploadInt32` makes them); ``window`` is the stats grid's
    (xsize, ysize, leftPix, topLine)."""
    return compactSceneWindowDeviceMultiBand(
        segDev, valDev[None], window, [imgNullVal], numSeg,
        imageValueType)[0]


def compactSceneWindowDeviceMultiBand(segDev, valsDev, window,
                                      imgNullVals, numSeg,
                                      imageValueType=np.int64):
    """Multi-band window compaction from a (nBands, H, W) scene tensor on
    the device: the window is sliced out there, and its entries equal
    compactTileDevice's."""
    (xsize, ysize, leftPix, topLine) = window
    rows = slice(topLine, topLine + ysize)
    cols = slice(leftPix, leftPix + xsize)
    return windowRuns(segDev[rows, cols], valsDev[:, rows, cols],
                      imgNullVals, numSeg, imageValueType)
