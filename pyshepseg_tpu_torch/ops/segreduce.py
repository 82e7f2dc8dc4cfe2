"""
Segment reductions and relabelling
(counterpart: pyshepseg_tpu/ops/segreduce.py).

Per-segment sums of integer imagery are accumulated in int64: exact and
independent of the order of the additions, atomics on the card included.
They become float32 only where a mean is taken. While a segment's sum is
below 2^24 this equals the JAX package's float32 sums bit for bit; above
it, it is the exact value where float32 accumulation rounds. Float imagery
is summed in float32, in an order that may differ from run to run on the
card.

The JAX package's run-length variants stand in for the TPU's serial
scatters and are not ported.
"""

import numpy as np
import torch

from .. import _kernels
from .constants import SegIdType, MINSEGID


def seg_sizes(seg, capacity: int):
    """Histogram of segment IDs: seg int (H, W) -> (capacity,) int64."""
    flat = seg.reshape(-1).long()
    return torch.zeros(capacity, dtype=torch.int64,
                       device=seg.device).index_add_(
        0, flat, torch.ones_like(flat))


# dtypes torch computes little on, widened losslessly (on the device)
_WIDEN = {torch.uint16: torch.int32, torch.uint32: torch.int64}


def image_tensor(img, device):
    """
    A (nBands, H, W) image as a tensor on ``device`` holding the native
    values. It crosses to the device in its own dtype; uint16 and uint32
    are then widened losslessly to int32 and int64 (torch implements few
    ops on them); other dtypes are kept. A tensor stays on its own device.
    """
    if not isinstance(img, torch.Tensor):
        img = torch.from_numpy(np.ascontiguousarray(img)).to(device)
    return img.to(_WIDEN.get(img.dtype, img.dtype))


def band_planes(img):
    """
    Split a (nBands, H, W) tensor into a tuple of (H, W) planes, or pass a
    tuple through unchanged.
    """
    if isinstance(img, tuple):
        return img
    return tuple(img[b] for b in range(img.shape[0]))


def _sum_dtype(plane):
    return torch.float32 if plane.is_floating_point() else torch.int64


def seg_spectral_sums(seg, img, capacity: int):
    """
    Per-segment per-band sums of pixel values: img (nBands, H, W) ->
    (capacity, nBands), int64 for integer imagery, float32 otherwise. Row
    0 (the null segment) is computed but unused, as in the reference.
    """
    return seg_spectral_sums_planes(seg, band_planes(img), capacity)


def seg_spectral_sums_planes(seg, band_planes, capacity: int):
    """Per-segment per-band sums from a tuple of (H, W) band planes."""
    flat = seg.reshape(-1).long()
    dtype = _sum_dtype(band_planes[0])
    vals = torch.stack([p.reshape(-1).to(dtype) for p in band_planes], dim=1)
    return torch.zeros((capacity, len(band_planes)), dtype=dtype,
                       device=seg.device).index_add_(0, flat, vals)


def seg_sizes_and_spectral_sums_planes(seg, band_planes, capacity: int):
    """
    Per-segment pixel counts (int64 (capacity,)) and per-band sums
    ((capacity, nBands), see :func:`seg_spectral_sums`).
    """
    return (seg_sizes(seg, capacity),
            seg_spectral_sums_planes(seg, band_planes, capacity))


def relabel_subtract(seg_size, min_seg_id: int = MINSEGID):
    """
    Per-ID decrement making labels contiguous: for each ID k, the number
    of unused (zero-count) IDs in [min_seg_id, k-1]
    (reference: shepseg.py:739-777).
    """
    ids = torch.arange(seg_size.shape[0], device=seg_size.device)
    z = ((seg_size == 0) & (ids >= min_seg_id)).long()
    sub = torch.cumsum(z, 0)
    return torch.cat([sub.new_zeros(1), sub[:-1]])


def relabel(seg, seg_size, min_seg_id: int = MINSEGID):
    """Apply :func:`relabel_subtract` to a segment image (same dtype)."""
    subtract = relabel_subtract(seg_size, min_seg_id)
    return (seg - subtract[seg.long()]).to(seg.dtype)


# ---------------------------------------------------------------- host API


def makeSegSize(seg, maxSegId=None):
    """
    Host API matching the reference (reference: shepseg.py:544-569):
    array of pixel counts indexed by segment ID, length maxSegId+1.
    """
    seg = np.asarray(seg)
    if maxSegId is None:
        maxSegId = int(seg.max()) if seg.size else 0
    counts = np.bincount(seg.ravel().astype(np.int64),
                         minlength=maxSegId + 1)
    return counts.astype(np.uint32)


def buildSegmentSpectra(seg, img, maxSegId, device="cuda"):
    """
    Host API matching the reference (reference: shepseg.py:780-813):
    (maxSegId+1, nBands) float32 per-segment band sums.
    """
    device = _kernels.torch_device(device)
    seg_t = torch.from_numpy(np.asarray(seg).astype(np.int64)).to(device)
    out = seg_spectral_sums(seg_t, image_tensor(img, device),
                            int(maxSegId) + 1)
    return out.cpu().numpy().astype(np.float32)


def relabelSegments(seg, segSize, minSegId, device="cuda"):
    """
    Host API matching the reference (reference: shepseg.py:739-777).
    Modifies ``seg`` in place (numpy array) to have contiguous labels.
    """
    device = _kernels.torch_device(device)
    size_t = torch.from_numpy(np.asarray(segSize).astype(np.int64)).to(device)
    sub = relabel_subtract(size_t, int(minSegId)).cpu().numpy()
    seg[...] = (seg - sub[seg]).astype(SegIdType)


class SegmentLocations:
    """
    CSR index of per-segment pixel locations — the static-shape TPU-era
    replacement for the reference's ``RowColArray`` typed dict
    (reference: shepseg.py:816-915). Built once with a stable sort; lookup
    is O(1) slicing. Pixel order within a segment is row-major scan order,
    matching the order the reference's ``makeSegmentLocations`` appends in.
    """

    def __init__(self, seg):
        seg = np.asarray(seg)
        self.shape = seg.shape
        flat = seg.ravel()
        order = np.argsort(flat, kind="stable")
        sorted_ids = flat[order]
        self.maxSegId = int(flat.max()) if flat.size else 0
        # starts[k] .. starts[k+1] are the sorted positions of segment k
        self.starts = np.searchsorted(
            sorted_ids, np.arange(self.maxSegId + 2, dtype=np.int64))
        self.order = order

    def __contains__(self, segId):
        segId = int(segId)
        return (0 <= segId <= self.maxSegId and
                self.starts[segId + 1] > self.starts[segId])

    def getSegmentIndices(self, segId):
        """Return (rows, cols) arrays for the given segment ID."""
        segId = int(segId)
        sl = self.order[self.starts[segId]:self.starts[segId + 1]]
        w = self.shape[1]
        return (sl // w).astype(np.uint32), (sl % w).astype(np.uint32)

    def rowcols(self, segId):
        """Return an (n, 2) array of (row, col) pixel coordinates."""
        r, c = self.getSegmentIndices(segId)
        return np.stack([r, c], axis=1)


def makeSegmentLocations(seg, segSize=None):
    """
    Host API matching the reference name (reference: shepseg.py:880-915).
    ``segSize`` is accepted for signature compatibility but not needed.
    """
    return SegmentLocations(seg)
