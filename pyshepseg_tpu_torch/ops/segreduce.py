"""
Segment reductions and relabelling
(counterpart: pyshepseg_tpu/ops/segreduce.py).

Per-segment sums of integer imagery are accumulated in int64: exact and
independent of the order of the additions, atomics on the card included.
They become float32 only where a mean is taken. While a segment's sum is
below 2^24 this equals the JAX package's float32 sums bit for bit; above
it, it is the exact value where float32 accumulation rounds. Float imagery
is summed in float32 through :func:`index_sum` in serial order: each bin
from +0.0, its elements added one at a time in increasing position order,
which is the CPU's ``index_add_`` and, on the card, kernel K4
(:func:`ordered_sum`, csrc/ordered_sum.cu). A float tile therefore gives
the same bits on the card as on the CPU.

The JAX package's run-length variants stand in for the TPU's serial
scatters and are not ported.
"""

import numpy as np
import torch

from .. import _kernels
from .. import timinghooks
from .constants import SegIdType, MINSEGID


def index_sum(size: int, index, source, dim: int = 0):
    """
    ``torch.zeros(...).index_add_(dim, index, source)`` into ``size`` bins
    along ``dim``, whose float result does not depend on the order of the
    card's atomics. Integer sums (exact in any order) and every sum on the
    CPU (a serial add in index order) are that call; a float sum on the
    card is :func:`ordered_sum`, which gives the CPU's bits.
    """
    if source.device.type == "cuda" and source.is_floating_point():
        return ordered_sum(size, index, source, dim)
    return ordered_sum_reference(size, index, source, dim)


def ordered_sum_reference(size: int, index, source, dim: int = 0,
                          skip_bin0=False):
    """Plain version of :func:`ordered_sum`: ``index_add_`` into zeros,
    which on the CPU adds each bin's elements serially in position order;
    with ``skip_bin0``, bin 0 is then set to +0.0."""
    shape = list(source.shape)
    shape[dim] = size
    out = torch.zeros(shape, dtype=source.dtype,
                      device=source.device).index_add_(dim, index, source)
    if skip_bin0 and size:
        out.select(dim, 0).zero_()
    return out


def ordered_sum(size: int, index, source, dim: int = 0, skip_bin0=False):
    """
    Float32 sums of the slices of a 1-D or 2-D ``source`` along ``dim``
    into ``size`` bins by ``index`` (in [0, size)), with the bits of the
    CPU's ``torch.zeros(...).index_add_(dim, index, source)``: every bin
    from +0.0, its elements added in increasing position order. With
    ``skip_bin0`` the elements of bin 0 are not summed and bin 0 is +0.0
    (a bin's elements are one serial run of K4, and bin 0, a tile's null
    segment, may hold most of its pixels; the caller then counts the
    summed elements' bytes, :func:`count_elements`). On the card, kernel
    K4 over the keys ``index << 32 | position`` sorted by the library; on
    the CPU the plain version. Raises for a CUDA tensor that is not
    float32, and for more than 2^32 elements or 2^31 bins.
    """
    if source.device.type == "cpu":
        return ordered_sum_reference(size, index, source, dim, skip_bin0)
    if (source.device.type != "cuda" or index.device != source.device or
            source.dtype != torch.float32 or source.dim() > 2 or
            index.dim() != 1 or index.shape[0] != source.shape[dim]):
        raise ValueError(
            "ordered_sum: float32 source of 1 or 2 dims and a 1-D index of "
            "its length along dim on one CUDA device, got %s %s on %s, "
            "index %s on %s" % (source.dtype, tuple(source.shape),
                                source.device, tuple(index.shape),
                                index.device))
    n = index.shape[0]
    if n >= 2 ** 32 or size >= 2 ** 31:
        raise ValueError("ordered_sum: %d elements into %d bins (at most "
                         "2^32 - 1 and 2^31 - 1)" % (n, size))
    shape = list(source.shape)
    shape[dim] = size
    out = torch.zeros(shape, dtype=torch.float32, device=source.device)
    bins = index.long()
    if skip_bin0:
        # past the last bin: K4 skips the run
        bins = bins.masked_fill(bins == 0, size)
    keys = torch.sort((bins << 32) | torch.arange(
        n, device=source.device)).values
    ordered_sum_keys(keys, source, out, dim,
                     elements=0 if skip_bin0 else None)
    return out


def _rows(t, dim):
    """(row stride, column stride, columns) of ``t`` as rows along dim."""
    if t.dim() == 1:
        return t.stride(0), 0, 1
    other = 1 - dim
    return t.stride(dim), t.stride(other), t.shape[other]


def ordered_sum_keys(keys, source, out, dim: int = 0, zero_source=False,
                     elements=None):
    """
    Launch K4: for each run of equal bin in the sorted int64 ``keys``
    (``bin << 32 | position``), add its elements' slices of ``source``
    along ``dim`` serially in key order from +0.0, and add that total onto
    the bin's slice of ``out`` (float32, same layout); keys whose bin lies
    outside ``out`` are skipped. With ``zero_source`` each element's slice
    is zeroed after it is read (``source`` may then be ``out`` itself, the
    positions never being bins). One ``segreduce.ordered_sum`` span; the
    counts ``ordered_sum.launches`` and ``ordered_sum.bytes``: each key
    read once and, for ``elements`` (all the keys by default; a caller
    that knows the count only later passes 0 and counts them itself), each
    element's slice read once and at most one bin's slice written.
    """
    dev = keys.device
    if (dev.type != "cuda" or source.device != dev or out.device != dev or
            keys.dtype != torch.int64 or keys.dim() != 1 or
            source.dtype != torch.float32 or out.dtype != torch.float32 or
            source.dim() != out.dim()):
        raise ValueError("ordered_sum_keys: int64 keys and float32 source "
                         "and out on one CUDA device, got %s, %s, %s" % (
                             keys.dtype, source.dtype, out.dtype))
    rs, cs, ncols = _rows(source, dim)
    ors, ocs, ocols = _rows(out, dim)
    if ocols != ncols:
        raise ValueError("ordered_sum_keys: %d source columns, %d in out"
                         % (ncols, ocols))
    n, nbins = keys.shape[0], out.shape[dim]
    with timinghooks.span("segreduce.ordered_sum"):
        with torch.cuda.device(dev):
            code = _kernels.lib().ordered_sum_launch(
                keys.data_ptr(), n, source.data_ptr(), rs, cs, ncols,
                out.data_ptr(), ors, ocs, nbins, int(bool(zero_source)),
                _kernels.stream_ptr(keys))
        _kernels.check(code, "ordered_sum")
    _kernels.count(ordered_sum)
    _kernels.count(ordered_sum, "bytes", n * 8)
    count_elements(n if elements is None else elements, ncols, nbins)


def count_elements(elements: int, ncols: int, nbins: int):
    """Add to ``ordered_sum.bytes`` what K4 moves for ``elements`` summed
    elements of ``ncols`` columns: each read once, and at most one of the
    ``nbins`` bins written an element."""
    _kernels.count(ordered_sum, "bytes",
                   (elements + min(elements, nbins)) * ncols * 4)


ordered_sum.launches = 0
ordered_sum.bytes = 0


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


def _stacked(seg, band_planes):
    flat = seg.reshape(-1).long()
    dtype = _sum_dtype(band_planes[0])
    vals = torch.stack([p.reshape(-1).to(dtype) for p in band_planes], dim=1)
    return flat, vals


def seg_spectral_sums_planes(seg, band_planes, capacity: int):
    """Per-segment per-band sums from a tuple of (H, W) band planes."""
    flat, vals = _stacked(seg, band_planes)
    return index_sum(capacity, flat, vals)


def seg_spectral_sums_tile(seg, band_planes, capacity: int):
    """
    The sums a segmentation reads: :func:`seg_spectral_sums_planes`, but
    float sums leave row 0 (the null segment, which no merge reads) at
    +0.0 and do not sum its pixels: on the card a tile's fill would
    otherwise be one serial run of K4. The caller counts the summed
    pixels' bytes (:func:`count_elements`). Integer sums are
    :func:`seg_spectral_sums_planes`'.
    """
    flat, vals = _stacked(seg, band_planes)
    if vals.is_floating_point():
        return ordered_sum(capacity, flat, vals, skip_bin0=True)
    return index_sum(capacity, flat, vals)


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
