"""
Per-segment statistics written into a raster attribute table (RAT)
(counterpart: pyshepseg_tpu/tilingstats.py; reference:
pyshepseg/tilingstats.py).

Works tile-by-tile over (segmentation raster, imagery raster) with bounded
memory: per-segment value histograms are accumulated as segments stream
past, each segment's statistics are computed and its state dropped the
moment all of its pixels have been seen (completeness = accumulated count
equals the 'Histogram' RAT column), and the RAT is written in fixed-size
pages which are flushed as soon as every row in them is complete.

The reference's numba dict-of-dicts histogram (tilingstats.py:466-515) is
replaced by a sorted compact (segment, value, count) accumulator merged
with vectorized numpy per tile, and the per-segment SegmentStats jitclass
(tilingstats.py:906-1008) by batched grouped reductions over all segments
completing in a tile at once. Statistic definitions (including the
percentile cumulative-count walk and its p=0 quirk) match the reference
exactly.

Spatial statistics (coordinate-list user functions) follow the same
completeness scheme, accumulating per-segment pixel coordinate lists and
invoking a user callback with a points recarray (fields x, y, val).

The engine is host numpy; with ``engine='device'`` the per-tile run
compaction (:mod:`.ops.segstats`) and the built-in spatial box functions
(:mod:`.ops.spatialstats`) run as torch ops on the computing entry
points' ``device`` ("cuda" by default, which raises where CUDA is
absent). Either engine writes the same RAT columns.
"""

import numpy
import torch

from . import _kernels
from . import shepseg
from . import tiling
from . import timinghooks
from . import io as rio


class PyShepSegStatsError(Exception):
    pass


class TiledStatsResult(object):
    """Result of per-segment stats calculations. Holds .timings."""

    def __init__(self):
        self.timings = None


# Image values are handled as int64 throughout (float imagery is rejected,
# matching reference: tilingstats.py:63-68, 450-452)
imageValueType = numpy.int64
# Reference-compatible aliases (reference: tilingstats.py:66-68 — there
# they are numba types; here plain numpy dtypes, usable the same way in
# user code that sizes arrays for the spatial-stats callbacks)
numbaTypeForImageType = imageValueType
segIdNumbaType = shepseg.SegIdType

# Is the optional RIOS package available (reference: tilingstats.py:48-57)?
# Checked without importing it, so merely loading this module stays cheap.
import importlib.util as _ilu  # noqa: E402
HAVE_RIOS = _ilu.find_spec("rios") is not None


def equalProjection(proj1, proj2):
    """
    Are the two projections equal? Uses OSR IsSame when GDAL is available,
    else string comparison (reference: tilingstats.py:1011-1034).
    """
    if proj1 == proj2:
        return True
    try:
        from osgeo import osr
    except ImportError:
        return (proj1 or "") == (proj2 or "")
    sr1 = osr.SpatialReference(wkt=proj1)
    sr2 = osr.SpatialReference(wkt=proj2)
    return bool(sr1.IsSame(sr2))


def doImageAlignmentChecks(segfile, imgfile, imgbandnum, update=True):
    """
    Check the segmentation and imagery rasters align (same size, transform,
    projection) and that the imagery is not float
    (reference: tilingstats.py:409-463).

    Returns (segds, segband, imgds, imgband).
    """
    segds = rio.open(segfile, rio.GA_Update if update else rio.GA_ReadOnly)
    segband = segds.GetRasterBand(1)

    imgds = rio.open(imgfile, rio.GA_ReadOnly)
    imgband = imgds.GetRasterBand(imgbandnum)
    if imgband.DataType in (rio.GDT_Float32, rio.GDT_Float64):
        raise PyShepSegStatsError("Float image types not supported")

    if segband.XSize != imgband.XSize or segband.YSize != imgband.YSize:
        raise PyShepSegStatsError("Images must be same size")

    if segds.GetGeoTransform() != imgds.GetGeoTransform():
        raise PyShepSegStatsError(
            "Images must have same spatial extent and pixel size")

    if not equalProjection(segds.GetProjection(), imgds.GetProjection()):
        raise PyShepSegStatsError("Images must be in the same projection")

    return segds, segband, imgds, imgband


# ------------------------------------------------------------- stat codes

STATID_MIN = 0
STATID_MAX = 1
STATID_MEAN = 2
STATID_STDDEV = 3
STATID_MEDIAN = 4
STATID_MODE = 5
STATID_PERCENTILE = 6
STATID_PIXCOUNT = 7
statIDdict = {
    'min': STATID_MIN, 'max': STATID_MAX, 'mean': STATID_MEAN,
    'stddev': STATID_STDDEV, 'median': STATID_MEDIAN, 'mode': STATID_MODE,
    'percentile': STATID_PERCENTILE, 'pixcount': STATID_PIXCOUNT,
}

STAT_DTYPE_INT = 0
STAT_DTYPE_FLOAT = 1

STATSSELFAST_DTYPE = numpy.uint32
STATSSELFAST_NULLVAL = numpy.iinfo(STATSSELFAST_DTYPE).max
NOPARAM = STATSSELFAST_NULLVAL

STATSEL_GLOBALCOLINDEX = 0
STATSEL_STATID = 1
STATSEL_COLTYPE = 2
STATSEL_COLARRAYINDEX = 3
STATSEL_PARAM = 4

RAT_PAGE_SIZE = 100000


def checkHistColumn(existingColNames):
    """Index of the 'Histogram' column; error if absent
    (reference: tilingstats.py:656-679)."""
    if 'Histogram' not in existingColNames:
        raise PyShepSegStatsError(
            "Histogram column must exist before calculating stats")
    return existingColNames.index('Histogram')


def createStatColumns(statsSelection, attrTbl, existingColNames):
    """
    Create requested columns in the RAT if not present: mean/stddev are
    float, everything else integer (reference: tilingstats.py:682-721).
    Returns the list of column indexes.
    """
    colIndexList = []
    for selection in statsSelection:
        (colName, statName) = selection[:2]
        if colName not in existingColNames:
            colType = rio.GFT_Integer
            if statName in ('mean', 'stddev'):
                colType = rio.GFT_Real
            attrTbl.CreateColumn(colName, colType, rio.GFU_Generic)
            colNdx = attrTbl.GetColumnCount() - 1
            existingColNames.append(colName)
        else:
            colNdx = existingColNames.index(colName)
        colIndexList.append(colNdx)
    return colIndexList


def makeFastStatsSelection(colIndexList, statsSelection):
    """
    Encode the stats selection as a (numStats, 5) integer array
    (reference: tilingstats.py:798-863). Returns
    (statsSelection_fast, numIntCols, numFloatCols).
    """
    numStats = len(colIndexList)
    sel = numpy.empty((numStats, 5), dtype=STATSSELFAST_DTYPE)
    intCount = floatCount = 0
    for i in range(numStats):
        sel[i, STATSEL_GLOBALCOLINDEX] = colIndexList[i]
        statName = statsSelection[i][1]
        sel[i, STATSEL_STATID] = statIDdict[statName]
        statType = STAT_DTYPE_INT
        if statName in ('mean', 'stddev'):
            statType = STAT_DTYPE_FLOAT
        sel[i, STATSEL_COLTYPE] = statType
        if statType == STAT_DTYPE_INT:
            sel[i, STATSEL_COLARRAYINDEX] = intCount
            intCount += 1
        else:
            sel[i, STATSEL_COLARRAYINDEX] = floatCount
            floatCount += 1
        sel[i, STATSEL_PARAM] = NOPARAM
        if statName == 'percentile':
            sel[i, STATSEL_PARAM] = statsSelection[i][2]
    return (sel, intCount, floatCount)


# ------------------------------------------------------------- paged RAT


def getRatPageId(segId):
    """First segment ID of the page containing segId
    (reference: tilingstats.py:1949-1962)."""
    return (segId // RAT_PAGE_SIZE) * RAT_PAGE_SIZE


class RatPage:
    """
    One page of RAT values: int64 + float32 column blocks with per-row
    completeness flags; the null row completes automatically
    (reference RatPage jitclass: tilingstats.py:1971-2045).
    """

    def __init__(self, numIntCols, numFloatCols, startSegId, numSeg):
        self.startSegId = startSegId
        self.intcols = numpy.empty((numIntCols, numSeg), dtype=numpy.int64)
        self.floatcols = numpy.empty((numFloatCols, numSeg),
                                     dtype=numpy.float32)
        self.complete = numpy.zeros(numSeg, dtype=bool)
        if startSegId == shepseg.SEGNULLVAL:
            # nothing will ever be written for the null segment
            self.intcols[:, 0] = 0
            self.floatcols[:, 0] = 0
            self.complete[0] = True

    def getIndexInPage(self, segId):
        return segId - self.startSegId

    def setRatVal(self, segId, colType, colArrayNdx, val):
        i = self.getIndexInPage(segId)
        if colType == STAT_DTYPE_INT:
            self.intcols[colArrayNdx, i] = val
        else:
            self.floatcols[colArrayNdx, i] = val

    def getRatVal(self, segId, colType, colArrayNdx):
        i = self.getIndexInPage(segId)
        if colType == STAT_DTYPE_INT:
            return self.intcols[colArrayNdx, i]
        return self.floatcols[colArrayNdx, i]

    def setSegmentComplete(self, segId):
        self.complete[self.getIndexInPage(segId)] = True

    def getSegmentComplete(self, segId):
        return self.complete[self.getIndexInPage(segId)]

    def pageComplete(self):
        return bool(self.complete.all())


def createPagedRat():
    """Dict of RatPage keyed by page start segment ID
    (reference: tilingstats.py:1935-1946)."""
    return {}


def writeCompletePages(pagedRat, attrTbl, statsSelection_fast):
    """Flush every complete page to the RAT and drop it
    (reference: tilingstats.py:723-764)."""
    numStat = statsSelection_fast.shape[0]
    for pageId in list(pagedRat.keys()):
        ratPage = pagedRat[pageId]
        if not ratPage.pageComplete():
            continue
        startSegId = ratPage.startSegId
        numRows = ratPage.intcols.shape[1] or ratPage.floatcols.shape[1]
        endSegId = startSegId + numRows
        if attrTbl.GetRowCount() < endSegId:
            attrTbl.SetRowCount(endSegId)
        for i in range(numStat):
            globalColNum = int(statsSelection_fast[i, STATSEL_GLOBALCOLINDEX])
            colType = int(statsSelection_fast[i, STATSEL_COLTYPE])
            colArrayNdx = int(statsSelection_fast[i, STATSEL_COLARRAYINDEX])
            if colType == STAT_DTYPE_INT:
                colArr = ratPage.intcols[colArrayNdx]
            else:
                colArr = ratPage.floatcols[colArrayNdx]
            attrTbl.WriteArray(colArr, globalColNum, start=int(startSegId))
        pagedRat.pop(pageId)


def _getRatPage(pagedRat, segId, numIntCols, numFloatCols, segSizeLen):
    pageId = getRatPageId(segId)
    if pageId not in pagedRat:
        numSegThisPage = min(RAT_PAGE_SIZE, segSizeLen - pageId)
        pagedRat[pageId] = RatPage(numIntCols, numFloatCols, pageId,
                                   numSegThisPage)
    return pagedRat[pageId]


# ------------------------------------------------- streaming accumulator


def compactTile(tileSegments, tileImageData, imgNullVal, numSeg,
                nbinsBudget=(1 << 25)):
    """
    RLE-compact one tile of (segment, value) pixels: returns
    (seenCounts, noDataCounts-or-None, runSegIds, runValues, runCounts)
    with runs sorted by (segId, value), or None for an all-null tile.
    Pure function of the tile — safe to run on worker threads.

    ``nbinsBudget`` caps the dense fast path's transient bincount array
    (int64 bins); callers running several compactions concurrently should
    divide the default by the worker count to bound total memory.
    """
    seg = tileSegments.ravel().astype(numpy.int64)
    val = tileImageData.ravel().astype(imageValueType)
    keep = seg != shepseg.SEGNULLVAL
    seg, val = seg[keep], val[keep]
    if seg.size == 0:
        return None
    seen = numpy.bincount(seg, minlength=numSeg
                          ).astype(numpy.int64)[:numSeg]
    noData = None
    if imgNullVal is not None:
        isNull = val == imageValueType(imgNullVal)
        if isNull.any():
            noData = numpy.bincount(
                seg[isNull], minlength=numSeg
            ).astype(numpy.int64)[:numSeg]
        seg, val = seg[~isNull], val[~isNull]
    if seg.size == 0:
        empty = numpy.empty(0, numpy.int64)
        return (seen, noData, empty, empty.astype(imageValueType), empty)

    # Fast path: when (segments present) * (value range) is modest —
    # always true for byte/uint16 imagery — count (seg, value) pairs
    # with ONE dense bincount instead of an O(n log n) lexsort of every
    # pixel (the lexsort dominated the whole stats pass). The packed key
    # enumerates (local segment rank, value) in lexicographic order, so
    # the nonzero scan below yields runs already sorted by (segId, value).
    vmin = int(val.min())
    vmax = int(val.max())
    vrange = vmax - vmin + 1
    localSegs = numpy.nonzero(seen)[0]          # ascending segment IDs
    nbins = len(localSegs) * vrange
    if 0 < nbins <= nbinsBudget:
        lut = numpy.zeros(numSeg, dtype=numpy.int64)
        lut[localSegs] = numpy.arange(len(localSegs), dtype=numpy.int64)
        key = lut[seg] * vrange + (val.astype(numpy.int64) - vmin)
        cnt = numpy.bincount(key, minlength=nbins)
        runKey = numpy.nonzero(cnt)[0]
        runSeg = localSegs[runKey // vrange]
        runVal = (runKey % vrange + vmin).astype(imageValueType)
        return (seen, noData, runSeg, runVal,
                cnt[runKey].astype(numpy.int64))

    order = numpy.lexsort((val, seg))
    seg, val = seg[order], val[order]
    boundary = numpy.concatenate(
        [[True], (seg[1:] != seg[:-1]) | (val[1:] != val[:-1])])
    groupIdx = numpy.cumsum(boundary) - 1
    runCounts = numpy.bincount(groupIdx).astype(numpy.int64)
    return (seen, noData, seg[boundary], val[boundary], runCounts)


class SegmentHistAccumulator:
    """
    Streaming per-segment value-histogram accumulator: a compact array
    triple (segId, value, count) sorted by (segId, value), merged with each
    tile's run-length-encoded pairs, plus dense per-segment nodata and
    seen-pixel counters. Replaces the reference's numba dict-of-dicts
    (tilingstats.py:466-553) with vectorized numpy; completed segments'
    entries are dropped to keep memory bounded.
    """

    def __init__(self, numSeg, imgNullVal):
        self.numSeg = numSeg
        self.imgNullVal = imgNullVal
        self.segIds = numpy.empty(0, dtype=numpy.int64)
        self.values = numpy.empty(0, dtype=imageValueType)
        self.counts = numpy.empty(0, dtype=numpy.int64)
        self.noData = numpy.zeros(numSeg, dtype=numpy.int64)
        self.seen = numpy.zeros(numSeg, dtype=numpy.int64)
        # segments touched at some point (matches the reference's "always
        # create an entry" behaviour so all-nodata segments still complete)
        self.touched = numpy.zeros(numSeg, dtype=bool)
        self.done = numpy.zeros(numSeg, dtype=bool)

    def accumulate(self, tileSegments, tileImageData):
        """Merge one tile of (segment, value) pixels."""
        self.merge(compactTile(tileSegments, tileImageData,
                               self.imgNullVal, self.numSeg))

    def merge(self, compacted):
        """
        Merge one tile's pre-compacted runs (from :func:`compactTile`).
        Splitting compaction from merging lets the driver compact tiles
        on worker threads (the per-tile lexsort is the stats pass's
        dominant cost) while this cheap sequential merge keeps the
        streaming completeness semantics.
        """
        if compacted is None:
            return
        seen, noData, newSeg, newVal, newCounts = compacted
        self.touched |= seen > 0
        self.seen += seen
        if noData is not None:
            self.noData += noData
        if newSeg.size == 0:
            return

        # merge two sorted run lists
        allSeg = numpy.concatenate([self.segIds, newSeg])
        allVal = numpy.concatenate([self.values, newVal])
        allCnt = numpy.concatenate([self.counts, newCounts])
        order = numpy.lexsort((allVal, allSeg))
        allSeg, allVal, allCnt = allSeg[order], allVal[order], allCnt[order]
        boundary = numpy.concatenate(
            [[True], (allSeg[1:] != allSeg[:-1]) | (allVal[1:] != allVal[:-1])])
        groupIdx = numpy.cumsum(boundary) - 1
        self.counts = numpy.bincount(
            groupIdx, weights=allCnt).astype(numpy.int64)
        self.segIds = allSeg[boundary]
        self.values = allVal[boundary]

    def completedSegments(self, segSize):
        """Segment IDs that are now complete and not yet finalized."""
        complete = (self.touched & ~self.done &
                    (self.seen == segSize[:self.numSeg]))
        complete[shepseg.SEGNULLVAL] = False
        return numpy.nonzero(complete)[0]

    def extractSegments(self, segIdList):
        """
        Pull out (and drop) the runs for the given segment IDs. Returns
        (vals, counts, groupStart, groupEnd, noData) where groupStart/End
        index vals/counts per segment in segIdList order.
        """
        take = numpy.isin(self.segIds, segIdList)
        segTaken = self.segIds[take]
        vals = self.values[take]
        counts = self.counts[take]
        # runs are sorted by segId; order groups to match segIdList
        sortedUniq, startIdx = numpy.unique(segTaken, return_index=True)
        endIdx = numpy.append(startIdx[1:], len(segTaken))
        lookup = {s: i for i, s in enumerate(sortedUniq)}
        groupStart = numpy.zeros(len(segIdList), dtype=numpy.int64)
        groupEnd = numpy.zeros(len(segIdList), dtype=numpy.int64)
        for i, s in enumerate(segIdList):
            if s in lookup:
                j = lookup[s]
                groupStart[i] = startIdx[j]
                groupEnd[i] = endIdx[j]
        noData = self.noData[segIdList]
        # drop state
        self.segIds = self.segIds[~take]
        self.values = self.values[~take]
        self.counts = self.counts[~take]
        self.done[segIdList] = True
        return vals, counts, groupStart, groupEnd, noData

    def anyPending(self):
        return bool((self.touched & ~self.done).any())


def _segmentStatsFromRuns(vals, counts, start, end, statID, param,
                          missingStatsValue):
    """
    One statistic for each segment whose (value, count) runs occupy
    vals/counts[start:end]. Matches the reference SegmentStats semantics
    (tilingstats.py:906-1008) including the percentile walk and its
    p<=0 quirk, float32 mean/stddev, and first-max mode — but computed
    for all segments at once with grouped vector reductions instead of
    a per-segment Python loop (which scales badly past ~1e5 segments).
    """
    n = len(start)
    lengths = (end - start).astype(numpy.int64)
    groupIdx = numpy.repeat(numpy.arange(n, dtype=numpy.int64), lengths)
    gvals = _concatRuns(vals, start, end, lengths)
    gcounts = _concatRuns(counts, start, end, lengths)

    pixCount = numpy.bincount(groupIdx, weights=gcounts,
                              minlength=n).astype(numpy.int64)
    if statID == STATID_PIXCOUNT:
        return pixCount.astype(numpy.float64)

    out = numpy.full(n, missingStatsValue, dtype=numpy.float64)
    nonEmpty = pixCount > 0
    if len(gvals) == 0:
        # every completing segment is all-nodata (zero runs): nothing to
        # reduce, and the percentile branch would index an empty cumsum
        return out
    # first/last run index per group (runs are sorted by value)
    gstart = numpy.zeros(n, dtype=numpy.int64)
    gstart[1:] = numpy.cumsum(lengths)[:-1]
    gend = gstart + lengths  # indices into gvals/gcounts

    if statID == STATID_MIN:
        out[nonEmpty] = gvals[gstart[nonEmpty]]
    elif statID == STATID_MAX:
        out[nonEmpty] = gvals[gend[nonEmpty] - 1]
    elif statID in (STATID_MEAN, STATID_STDDEV):
        sums = numpy.bincount(groupIdx, weights=gvals * gcounts,
                              minlength=n)
        mean32 = numpy.float32(
            sums[nonEmpty] / pixCount[nonEmpty]).astype(numpy.float64)
        if statID == STATID_MEAN:
            out[nonEmpty] = mean32
        else:
            meanPerRun = numpy.zeros(n, dtype=numpy.float64)
            meanPerRun[nonEmpty] = mean32
            sq = gcounts * (gvals - meanPerRun[groupIdx]) ** 2
            var = numpy.bincount(groupIdx, weights=sq,
                                 minlength=n)[nonEmpty] / pixCount[nonEmpty]
            out[nonEmpty] = numpy.float32(numpy.sqrt(var))
    elif statID == STATID_MODE:
        # first run achieving the group's max count (first-max tie-break)
        cmax = numpy.full(n, -1, dtype=numpy.int64)
        numpy.maximum.at(cmax, groupIdx, gcounts)
        isMax = gcounts == cmax[groupIdx]
        cand = numpy.where(isMax, numpy.arange(len(gcounts)),
                           len(gcounts))
        firstMax = numpy.full(n, len(gcounts), dtype=numpy.int64)
        numpy.minimum.at(firstMax, groupIdx, cand)
        out[nonEmpty] = gvals[firstMax[nonEmpty]]
    elif statID in (STATID_MEDIAN, STATID_PERCENTILE):
        p = 50 if statID == STATID_MEDIAN else param
        target = pixCount * (p / 100)
        # global cumsum is strictly increasing (counts >= 1), so one
        # global searchsorted does every group's cumulative-count walk
        cum = numpy.cumsum(gcounts)
        cumBefore = numpy.where(gstart > 0, cum[gstart - 1], 0)
        k = numpy.searchsorted(cum, target + cumBefore, side='left')
        k = numpy.minimum(k, gend - 1)
        # reference quirk: a p<=0 target exits the walk immediately and
        # indexes pixVals[-1] (tilingstats.py:983-993)
        k = numpy.where(target <= 0, gend - 1, k)
        out[nonEmpty] = gvals[k[nonEmpty]]
    else:
        raise PyShepSegStatsError(f"Unknown statID {statID}")
    return out


def _concatRuns(arr, start, end, lengths):
    """arr's [start:end) slices concatenated (the groups are usually
    already contiguous and in order, making this a cheap view-copy)."""
    if len(start) == 0:
        return arr[:0]
    if (start[0] == 0 and (start[1:] == end[:-1]).all()):
        return arr[:end[-1]]
    idx = numpy.repeat(start - numpy.concatenate(
        [[0], numpy.cumsum(lengths)[:-1]]), lengths)
    idx += numpy.arange(int(lengths.sum()), dtype=numpy.int64)
    return arr[idx]


def _compactedTileStream(nlines, npix, tileSize, segfile, imgfile,
                         imgbandnum, serialBands, compactFn,
                         numReadWorkers, timings,
                         batchedCompactFn=None, haloPixels=0):
    """
    Yield ``compactFn(segTile, imgTile, window)`` per 1024^2 tile in
    strict row-major order. With numReadWorkers > 0 the read+compact
    runs ahead on worker threads (bounded lookahead, per-thread dataset
    handles — GDAL handles are not thread-safe, and Band handles dangle
    if their parent Dataset is garbage-collected); consumed results are
    dropped immediately so memory stays bounded. Serial otherwise.

    ``imgbandnum`` and ``compactFn`` may each be aligned LISTS: the seg
    tile is then read once per window and compacted against every band,
    and each yield is the list of per-band results (the one-pass
    multi-band mode). Scalars yield one result per tile as before.
    """
    multi = isinstance(imgbandnum, (list, tuple))
    bandNums = list(imgbandnum) if multi else [imgbandnum]
    compactFns = list(compactFn) if multi else [compactFn]

    windows = _statsWindows(nlines, npix, tileSize)

    # Worker threads need their OWN dataset handles; rio.open passes an
    # already-open Dataset object straight through, so when the caller
    # gave us objects rather than paths the threads would all share one
    # non-thread-safe handle — fall back to serial in that case.
    if not (isinstance(segfile, str) and isinstance(imgfile, str)):
        numReadWorkers = 0

    segb0, imgb0 = serialBands
    serialBands = (segb0, list(imgb0) if multi else [imgb0])

    def readAndCompact(window, bands):
        (xsize, ysize, leftPix, topLine) = window
        (segb, imgbs) = bands
        if haloPixels > 0:
            # Expanded clamped read: the tile plus up to haloPixels of
            # real neighbour context on each side (clamped at the image
            # edges — the accumulator pads the short sides itself, so
            # the hook always sees the full halo). The extra IO is two
            # strips per tile, ~0.2% at 1024^2/halo 1.
            h = haloPixels
            ex0, ey0 = max(0, leftPix - h), max(0, topLine - h)
            ex1 = min(npix, leftPix + xsize + h)
            ey1 = min(nlines, topLine + ysize + h)
            segEx = segb.ReadAsArray(ex0, ey0, ex1 - ex0, ey1 - ey0)
            out = [fn(segEx,
                      imgb.ReadAsArray(ex0, ey0, ex1 - ex0, ey1 - ey0),
                      window)
                   for fn, imgb in zip(compactFns, imgbs)]
            return out if multi else out[0]
        tileSegments = segb.ReadAsArray(leftPix, topLine, xsize, ysize)
        if batchedCompactFn is not None and multi:
            # all bands in one device sort
            tiles = [imgb.ReadAsArray(leftPix, topLine, xsize, ysize)
                     for imgb in imgbs]
            return batchedCompactFn(tileSegments, tiles, window)
        out = [fn(tileSegments,
                  imgb.ReadAsArray(leftPix, topLine, xsize, ysize),
                  window)
               for fn, imgb in zip(compactFns, imgbs)]
        return out if multi else out[0]

    if numReadWorkers <= 0:
        for window in windows:
            with timings.interval('reading'):
                compacted = readAndCompact(window, serialBands)
            yield compacted
        return

    import threading
    from concurrent import futures
    tlocal = threading.local()

    def worker(window):
        bands = getattr(tlocal, 'bands', None)
        if bands is None:
            segdsW = rio.open(segfile)
            imgdsW = rio.open(imgfile)
            tlocal.datasets = (segdsW, imgdsW)
            tlocal.bands = bands = (
                segdsW.GetRasterBand(1),
                [imgdsW.GetRasterBand(b) for b in bandNums])
        return readAndCompact(window, bands)

    pool = futures.ThreadPoolExecutor(max_workers=numReadWorkers)
    try:
        lookahead = numReadWorkers + 2
        pending = [pool.submit(worker, w) for w in windows[:lookahead]]
        for i in range(len(windows)):
            with timings.interval('reading'):
                compacted = pending[i].result()
            # drop the Future so its retained result (a whole tile's
            # runs) can be freed — otherwise memory grows with the
            # raster instead of staying bounded
            pending[i] = None
            nxt = i + lookahead
            if nxt < len(windows):
                pending.append(pool.submit(worker, windows[nxt]))
            yield compacted
    finally:
        # Cancel queued reads and WAIT for in-flight ones (reads are
        # tile-sized, so short): if the consumer aborts mid-stream the
        # rasters may be closed or deleted right after this returns, and
        # a still-running worker read would race on the files.
        pool.shutdown(wait=True, cancel_futures=True)


def _defaultReadWorkers(numReadWorkers, segfile=None):
    """None -> min(4, cpu_count - 1): serial on single-core hosts,
    where threads only add overhead. The auto default also stays serial
    for GDAL-backed segfiles: worker threads read the seg band through
    fresh handles while the coordinator writes RAT pages to the SAME
    file through its update handle, which HDF5-backed drivers (KEA) do
    not make safe across handles (the reference's RIOS variant avoids
    it by writing to a temp RAT). The numpy driver keeps band data and
    RAT columns in separate files, so concurrent reads are safe there.
    An EXPLICIT numReadWorkers is honoured as given.
    """
    if numReadWorkers is None:
        import os
        from . import io as rio
        if isinstance(segfile, str) and not rio.isNumpyDriverPath(
                segfile):
            return 0
        numReadWorkers = min(4, max(0, (os.cpu_count() or 1) - 1))
    return numReadWorkers


def _resolveStatsEngine(engine, imgband, device):
    """
    Resolve the stats compaction engine: 'host' (vectorized numpy),
    'device' (the torch sort-based run compaction of ops/segstats.py on
    ``device``, a CPU device included), or 'auto' (the device engine when
    ``device`` is a CUDA device and the imagery dtype's values fit the
    sort key; host otherwise).
    """
    if engine not in ('auto', 'host', 'device'):
        raise PyShepSegStatsError(
            f"engine must be 'auto', 'host' or 'device', got '{engine}'")
    if engine == 'host':
        return False
    from .ops.segstats import deviceCompactSupported
    sampleDtype = imgband.ReadAsArray(0, 0, 1, 1).dtype
    supported = deviceCompactSupported(sampleDtype)
    if engine == 'device':
        if not supported:
            raise PyShepSegStatsError(
                "engine='device' does not support imagery dtype "
                f"{sampleDtype} (values may not fit int32)")
        return True
    return supported and device.type == 'cuda'


def _sceneFitsDeviceStats(nlines, npix, nBands, device):
    """Can the whole scene (int32 segment ids + int32 bands) sit on
    ``device`` for the scene-resident feed? Its bytes against the
    budget the segmentation's scene cache has there
    (``tiling.sceneBudgetBytes``: a share of the free device memory)."""
    return (4 + 4 * nBands) * nlines * npix <= tiling.sceneBudgetBytes(
        device)


def _statsWindows(nlines, npix, tileSize):
    """The stats grid: (xsize, ysize, leftPix, topLine) of every tile, in
    row-major order."""
    return [(min(tileSize, npix - leftPix),
             min(tileSize, nlines - topLine), leftPix, topLine)
            for topLine in range(0, nlines, tileSize)
            for leftPix in range(0, npix, tileSize)]


def _deviceSceneStream(segband, imgbands, nullVals, numSeg, tileSize,
                       nlines, npix, timings, device):
    """Yield per-window lists of compacted band results, feeding the
    device compaction from ONE upload of the whole scene to ``device``
    (no per-tile host->device transfers): each window is a slice of the
    scene tensors."""
    from .ops.segstats import (compactSceneWindowDeviceMultiBand,
                               uploadInt32)

    with timings.interval('reading'):
        segDev = uploadInt32(segband.ReadAsArray(0, 0, npix, nlines),
                             device)
        # each band crosses in its own dtype and widens on the device
        valsDev = torch.empty((len(imgbands), nlines, npix),
                              dtype=torch.int32, device=device)
        for i, b in enumerate(imgbands):
            valsDev[i] = uploadInt32(b.ReadAsArray(0, 0, npix, nlines),
                                     device)

    for window in _statsWindows(nlines, npix, tileSize):
        # device compute, not I/O: charged to its own interval so the
        # timing report separates the scene upload ('reading') from the
        # per-window compaction
        with timings.interval('compaction'):
            out = compactSceneWindowDeviceMultiBand(
                segDev, valsDev, window, nullVals, numSeg)
        yield out


def calcPerSegmentStatsTiled(imgfile, imgbandnum, segfile,
        statsSelection, missingStatsValue=-9999, numReadWorkers=None,
        engine='auto', device="cuda"):
    """
    Calculate selected per-segment statistics of one image band against a
    segmentation raster, writing results into the segmentation file's RAT
    (reference: tilingstats.py:85-216 — same parameters, semantics, and
    bounded-memory streaming behaviour).

    statsSelection is a list of (columnName, statName[, param]) tuples;
    statName in {'min','max','mean','stddev','median','mode','percentile',
    'pixcount'}; 'percentile' takes the percentile as third element.

    numReadWorkers > 0 reads and RLE-compacts upcoming tiles on worker
    threads (bounded lookahead, per-thread dataset handles) while the
    main thread merges strictly in row-major tile order — the analogue
    of the reference's RIOS read-worker concurrency
    (reference: tilingstats.py:373-377), extended to cover the per-tile
    sort that dominates this pass. Results are identical to serial.
    Default (None): min(4, cpu_count - 1) — stays serial on single-core
    hosts, where threads only add overhead.

    ``engine`` selects where tiles are compacted into per-segment value
    runs: 'host', 'device' (one int64-key torch sort on ``device`` —
    identical runs, so identical statistics), or 'auto' (see
    _resolveStatsEngine). ``device`` ("cuda" by default, which raises
    where CUDA is absent) is the torch device of the device engine.
    """
    return calcPerSegmentStatsTiledMultiBand(
        imgfile, [imgbandnum], segfile, [statsSelection],
        missingStatsValue=missingStatsValue,
        numReadWorkers=numReadWorkers, engine=engine, device=device)


def calcPerSegmentStatsTiledMultiBand(imgfile, bandNumbers, segfile,
        statsSelectionList, missingStatsValue=-9999, numReadWorkers=None,
        engine='auto', device="cuda"):
    """
    Per-segment statistics for SEVERAL image bands in ONE pass over the
    segmentation raster. The reference computes one band per call
    (reference: tilingstats.py:85-216), re-reading and re-streaming the
    entire segmentation for every band; for the common multi-band
    workload (e.g. mean/stddev per band of an 8-band scene) this
    variant reads each segmentation tile once and accumulates every
    requested band against it, so the segmentation I/O, the tile loop,
    and the RAT paging are paid once instead of once per band.

    ``bandNumbers`` is a list of 1-based image band numbers and
    ``statsSelectionList`` an aligned list of per-band statsSelection
    lists (column names must be unique across bands). Column contents
    are identical to the corresponding single-band calls. Per-band
    nodata values are honoured individually. ``engine`` and ``device``
    work as in :func:`calcPerSegmentStatsTiled`.

    On the device engine the whole scene (segmentation and every band)
    goes to the device once when it fits the scene budget there
    (``tiling.sceneBudgetBytes``), and each window is a slice of it;
    otherwise each window's tiles are read and sent on their own.
    """
    device = _kernels.torch_device(device)
    if len(bandNumbers) != len(statsSelectionList):
        raise PyShepSegStatsError(
            "bandNumbers and statsSelectionList must align")
    if len(bandNumbers) == 0:
        raise PyShepSegStatsError("no bands requested")
    numReadWorkers = _defaultReadWorkers(numReadWorkers, segfile)
    timings = timinghooks.Timers()

    segds, segband, imgds, _ = doImageAlignmentChecks(
        segfile, imgfile, bandNumbers[0])

    attrTbl = segband.GetDefaultRAT()
    existingColNames = [attrTbl.GetNameOfCol(i)
                        for i in range(attrTbl.GetColumnCount())]

    histColNdx = checkHistColumn(existingColNames)
    segSize = attrTbl.ReadAsArray(histColNdx).astype(numpy.int64)
    numSeg = len(segSize)

    # Several compactions run concurrently with read workers; split
    # the dense-bincount memory budget between them so transient
    # memory stays bounded on multi-core hosts.
    nbinsBudget = (1 << 25) // max(1, numReadWorkers)

    perBand = []        # one accumulation context per requested band
    compactFns = []
    deviceFlags = []
    nullVals = []
    for bandNum, statsSelection in zip(bandNumbers, statsSelectionList):
        imgband = imgds.GetRasterBand(bandNum)
        if imgband.DataType in (rio.GDT_Float32, rio.GDT_Float64):
            raise PyShepSegStatsError("Float image types not supported")
        imgNullVal = imgband.GetNoDataValue()
        if imgNullVal is not None:
            imgNullVal = imageValueType(imgNullVal)

        colIndexList = createStatColumns(statsSelection, attrTbl,
                                         existingColNames)
        (fastSel, numIntCols, numFloatCols) = (
            makeFastStatsSelection(colIndexList, statsSelection))
        acc = SegmentHistAccumulator(numSeg, imgNullVal)
        pagedRat = createPagedRat()
        perBand.append((acc, pagedRat, fastSel, numIntCols, numFloatCols))

        useDevice = _resolveStatsEngine(engine, imgband, device)
        deviceFlags.append(useDevice)
        nullVals.append(imgNullVal)
        if useDevice:
            from .ops.segstats import compactTileDevice

            def compactFn(tileSegments, tileImageData, window,
                          _null=imgNullVal):
                return compactTileDevice(tileSegments, tileImageData,
                                         _null, numSeg, device=device)
        else:
            def compactFn(tileSegments, tileImageData, window,
                          _null=imgNullVal):
                return compactTile(tileSegments, tileImageData, _null,
                                   numSeg, nbinsBudget)

        compactFns.append(compactFn)

    batchedCompactFn = None
    if len(bandNumbers) > 1 and all(deviceFlags):
        # every band on the device: one sort (and one set of host
        # syncs) compacts the whole window's band set
        from .ops.segstats import compactTileDeviceMultiBand

        def batchedCompactFn(tileSegments, tileImageList, window):
            return compactTileDeviceMultiBand(
                tileSegments, tileImageList, nullVals, numSeg,
                device=device)

    tileSize = tiling.TILESIZE
    (nlines, npix) = (segband.YSize, segband.XSize)
    serialImgBands = [imgds.GetRasterBand(b) for b in bandNumbers]

    if all(deviceFlags) and _sceneFitsDeviceStats(
            nlines, npix, len(bandNumbers), device):
        # Scene-resident device feed: the segmentation and every
        # requested band go to the device ONCE and each stats window is
        # a slice there, so no window pays a host->device transfer.
        stream = _deviceSceneStream(
            segband, serialImgBands, nullVals, numSeg, tileSize,
            nlines, npix, timings, device)
    else:
        stream = _compactedTileStream(
            nlines, npix, tileSize, segfile, imgfile, list(bandNumbers),
            (segband, serialImgBands), compactFns, numReadWorkers,
            timings, batchedCompactFn=batchedCompactFn)
    for compactedList in stream:
        for compacted, (acc, pagedRat, fastSel, numIntCols,
                        numFloatCols) in zip(compactedList, perBand):
            with timings.interval('accumulation'):
                acc.merge(compacted)

            with timings.interval('statscompletion'):
                _calcStatsForCompletedSegs(acc, segSize,
                                           missingStatsValue, pagedRat,
                                           fastSel, numIntCols,
                                           numFloatCols)

            with timings.interval('writing'):
                writeCompletePages(pagedRat, attrTbl, fastSel)

    with timings.interval('writing'):
        segds.FlushCache()

    if any(len(pagedRat) > 0 for (_, pagedRat, _, _, _) in perBand):
        raise PyShepSegStatsError('Not all pixels found during processing')

    rtn = TiledStatsResult()
    rtn.timings = timings
    return rtn


def _calcStatsForCompletedSegs(acc, segSize, missingStatsValue, pagedRat,
                               statsSelection_fast, numIntCols,
                               numFloatCols):
    """Finalize every segment that completed this tile
    (reference: tilingstats.py:556-617, batched)."""
    segIdList = acc.completedSegments(segSize)
    if len(segIdList) == 0:
        return
    vals, counts, start, end, noData = acc.extractSegments(segIdList)

    numStats = statsSelection_fast.shape[0]
    statVals = []
    for i in range(numStats):
        statID = int(statsSelection_fast[i, STATSEL_STATID])
        param = int(statsSelection_fast[i, STATSEL_PARAM])
        statVals.append(_segmentStatsFromRuns(
            vals, counts, start, end, statID, param, missingStatsValue))

    numSeg = len(segSize)
    for j, segId in enumerate(segIdList):
        ratPage = _getRatPage(pagedRat, int(segId), numIntCols,
                              numFloatCols, numSeg)
        for i in range(numStats):
            colType = int(statsSelection_fast[i, STATSEL_COLTYPE])
            colArrayNdx = int(statsSelection_fast[i, STATSEL_COLARRAYINDEX])
            ratPage.setRatVal(int(segId), colType, colArrayNdx,
                              statVals[i][j])
        ratPage.setSegmentComplete(int(segId))


# ---------------------------------- reference dict-kernel compat layer
#
# The streaming engine above replaces the reference's numba typed-dict
# accumulation pipeline with sorted-run compaction, but the reference's
# dict-based kernels are public API. These are drop-in equivalents on
# plain Python dicts (vectorized where it matters), for callers that
# drove the reference kernels directly
# (reference: tilingstats.py:466-617, 620-653, 866-1008).


def createSegDict():
    """Dictionary of segments keyed on segment ID; values are {pixel
    value: count} histograms (reference: tilingstats.py:620-640 — a
    numba typed Dict there, a plain dict here)."""
    return {}


def createNoDataDict():
    """Dictionary of per-segment nodata pixel counts
    (reference: tilingstats.py:643-653)."""
    return {}


def accumulateSegDict(segDict, noDataDict, imgNullVal, tileSegments,
                      tileImageData):
    """
    Accumulate per-segment histogram counts for all pixels in the given
    tile, updating segDict/noDataDict in place
    (reference: tilingstats.py:466-515, vectorized over unique
    (segment, value) pairs).
    """
    seg = tileSegments.ravel().astype(numpy.int64)
    val = tileImageData.ravel().astype(imageValueType)
    keep = seg != shepseg.SEGNULLVAL
    seg = seg[keep]
    val = val[keep]
    # every touched segment gets a histogram entry, even if all-nodata
    for s in numpy.unique(seg).tolist():
        if s not in segDict:
            segDict[s] = {}
    if imgNullVal is not None:
        isNull = val == imageValueType(imgNullVal)
        if isNull.any():
            nullSegs, nullCounts = numpy.unique(seg[isNull],
                                                return_counts=True)
            for s, c in zip(nullSegs.tolist(), nullCounts.tolist()):
                noDataDict[s] = noDataDict.get(s, 0) + c
        seg = seg[~isNull]
        val = val[~isNull]
    if len(seg) == 0:
        return
    pairs = numpy.stack([seg, val.astype(numpy.int64)], axis=1)
    uniq, counts = numpy.unique(pairs, axis=0, return_counts=True)
    for (s, v), c in zip(uniq.tolist(), counts.tolist()):
        d = segDict[s]
        d[v] = d.get(v, 0) + c


def checkSegComplete(segDict, noDataDict, segSize, segId):
    """True when all of the segment's pixels have been seen: histogram
    counts plus nodata count equal the segment size
    (reference: tilingstats.py:518-553)."""
    count = 0
    if segId in segDict:
        count += sum(segDict[segId].values())
    count += noDataDict.get(segId, 0)
    return count == segSize[segId]


def getSortedKeysAndValuesForDict(d):
    """The histogram dictionary's (pixel values, counts) as a pair of
    arrays sorted by pixel value (reference: tilingstats.py:866-903)."""
    size = len(d)
    keys = numpy.fromiter(d.keys(), dtype=numbaTypeForImageType,
                          count=size)
    vals = numpy.fromiter(d.values(), dtype=numpy.uint32, count=size)
    order = numpy.argsort(keys)
    return keys[order], vals[order]


class SegmentStats:
    """
    Statistics of a single segment, computed from a {pixel value: count}
    histogram dictionary (reference SegmentStats jitclass:
    tilingstats.py:906-1008 — same attributes, same semantics, including
    float32 mean/stddev and the percentile walk's p<=0 quirk). With no
    valid pixels every statistic is ``missingStatsValue``.
    """

    def __init__(self, segmentHistDict, missingStatsValue):
        self.pixVals, self.counts = getSortedKeysAndValuesForDict(
            segmentHistDict)
        self.pixCount = int(self.counts.sum())
        self.missingStatsValue = missingStatsValue
        if self.pixCount == 0:
            self.min = missingStatsValue
            self.max = missingStatsValue
            self.mean = missingStatsValue
            self.stddev = missingStatsValue
            self.mode = missingStatsValue
            self.median = missingStatsValue
        else:
            self.min = self.pixVals[0]
            self.max = self.pixVals[-1]
            self.mean = numpy.float32(
                (self.pixVals * self.counts).sum() / self.pixCount)
            variance = (self.counts *
                        (self.pixVals - self.mean) ** 2).sum() / self.pixCount
            self.stddev = numpy.float32(numpy.sqrt(variance))
            self.mode = self.pixVals[numpy.argmax(self.counts)]
            self.median = self.getPercentile(50)

    def getPercentile(self, percentile):
        """Pixel value at the given percentile, by the reference's
        cumulative-count walk (a p<=0 target exits the walk immediately
        and indexes pixVals[-1] — reference: tilingstats.py:970-993)."""
        if self.pixCount == 0:
            return self.missingStatsValue
        countAtPcntile = self.pixCount * (percentile / 100)
        if countAtPcntile <= 0:
            return self.pixVals[-1]
        cum = numpy.cumsum(self.counts)
        k = int(numpy.searchsorted(cum, countAtPcntile, side='left'))
        return self.pixVals[k]

    def getStat(self, statID, param):
        """The requested statistic (reference: tilingstats.py:988-1008)."""
        if statID == STATID_MIN:
            return self.min
        elif statID == STATID_MAX:
            return self.max
        elif statID == STATID_MEAN:
            return self.mean
        elif statID == STATID_STDDEV:
            return self.stddev
        elif statID == STATID_MEDIAN:
            return self.median
        elif statID == STATID_MODE:
            return self.mode
        elif statID == STATID_PERCENTILE:
            return self.getPercentile(param)
        elif statID == STATID_PIXCOUNT:
            return self.pixCount
        raise PyShepSegStatsError(f"Unknown statID {statID}")


def calcStatsForCompletedSegs(segDict, noDataDict, missingStatsValue,
                              pagedRat, statsSelection_fast, segSize,
                              numIntCols, numFloatCols):
    """
    Calculate statistics for all complete segments in segDict, write
    them into the paged RAT, and drop each completed segment's histogram
    (bounded memory — reference: tilingstats.py:556-617).
    """
    numStats = len(statsSelection_fast)
    maxSegId = len(segSize) - 1
    for segId in list(segDict.keys()):
        if not checkSegComplete(segDict, noDataDict, segSize, segId):
            continue
        segStats = SegmentStats(segDict[segId], missingStatsValue)
        ratPageId = getRatPageId(segId)
        if ratPageId not in pagedRat:
            numSegThisPage = min(RAT_PAGE_SIZE, maxSegId - ratPageId + 1)
            pagedRat[ratPageId] = RatPage(numIntCols, numFloatCols,
                                          ratPageId, numSegThisPage)
        ratPage = pagedRat[ratPageId]
        for i in range(numStats):
            statId = int(statsSelection_fast[i, STATSEL_STATID])
            param = int(statsSelection_fast[i, STATSEL_PARAM])
            val = segStats.getStat(statId, param)
            colType = int(statsSelection_fast[i, STATSEL_COLTYPE])
            colArrayNdx = int(statsSelection_fast[i,
                                                  STATSEL_COLARRAYINDEX])
            ratPage.setRatVal(segId, colType, colArrayNdx, val)
        ratPage.setSegmentComplete(segId)
        segDict.pop(segId)
        noDataDict.pop(segId, None)


# -------------------------------------------------------- spatial stats


def userFuncVariogram(pts, imgNullVal, intArr, floatArr, maxDist):
    """
    Per-segment variograms at integer distances 1..maxDist, written into
    floatArr (reference: tilingstats.py:1037-1094, vectorized over
    offsets). Pass maxDist as the userParam.
    """
    tile = convertPtsInto2DArray(pts, imgNullVal)
    maxDist = int(maxDist)
    counts = numpy.zeros(maxDist, dtype=numpy.int64)
    sumDifSqs = numpy.zeros(maxDist, dtype=numpy.float64)
    valid = tile != imgNullVal
    ysize, xsize = tile.shape
    for yoffset in range(1, maxDist + 1):
        for xoffset in range(1, maxDist + 1):
            dist = int(numpy.sqrt(yoffset * yoffset + xoffset * xoffset))
            if dist < 1 or dist > maxDist:
                continue
            if yoffset >= ysize or xoffset >= xsize:
                continue
            a = tile[:ysize - yoffset, :xsize - xoffset]
            b = tile[yoffset:, xoffset:]
            ok = valid[:ysize - yoffset, :xsize - xoffset] & valid[yoffset:,
                                                                   xoffset:]
            counts[dist - 1] += int(ok.sum())
            d = (a[ok].astype(numpy.float64) - b[ok]) ** 2
            sumDifSqs[dist - 1] += d.sum()
    for n in range(maxDist):
        if counts[n] > 0:
            floatArr[n] = numpy.sqrt(sumDifSqs[n] / counts[n])


def userFuncMeanCoord(pts, imgNullVal, intArr, floatArr, transform):
    """
    Mean easting/northing of the segment via the geotransform, written to
    floatArr[0:2] (reference: tilingstats.py:1097-1142).
    """
    x = pts['x'].astype(numpy.float64)
    y = pts['y'].astype(numpy.float64)
    geox = transform[0] + transform[1] * x + transform[2] * y
    geoy = transform[3] + transform[4] * x + transform[5] * y
    floatArr[0] = geox.mean()
    floatArr[1] = geoy.mean()


def userFuncNumEdgePixels(pts, imgNullVal, intArr, floatArr, fourConnected):
    """
    Count of segment pixels touching another segment or the image edge
    (4- or 8-connected), written to intArr[0]
    (reference: tilingstats.py:1145-1216, vectorized).
    """
    mask = convertPtsInto2DMaskArray(pts, imgNullVal)
    inner = numpy.ones_like(mask, dtype=bool)
    padded = numpy.pad(mask, 1, constant_values=0)
    if fourConnected:
        offsets = ((-1, 0), (1, 0), (0, -1), (0, 1))
    else:
        offsets = ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1),
                   (1, -1), (1, 0), (1, 1))
    for dy, dx in offsets:
        nbr = padded[1 + dy:1 + dy + mask.shape[0],
                     1 + dx:1 + dx + mask.shape[1]]
        inner &= nbr == 1
    edge = (mask == 1) & ~inner
    intArr[0] = int(edge.sum())


def makePtsArray(x, y, val):
    """Build a points recarray with fields x, y, val (the array-of-structs
    replacement for the reference's SegPoint list)."""
    pts = numpy.recarray(len(x), dtype=[('x', numpy.uint32),
                                        ('y', numpy.uint32),
                                        ('val', imageValueType)])
    pts['x'] = x
    pts['y'] = y
    pts['val'] = val
    return pts


def convertPtsInto2DArray(pts, imgNullVal):
    """Points list -> minimal bounding-box 2D value tile, null-filled
    (reference: tilingstats.py:1743-1792)."""
    xmin, ymin = pts['x'].min(), pts['y'].min()
    xs = (pts['x'] - xmin).astype(numpy.int64)
    ys = (pts['y'] - ymin).astype(numpy.int64)
    tile = numpy.full((ys.max() + 1, xs.max() + 1), imgNullVal,
                      dtype=imageValueType)
    tile[ys, xs] = pts['val']
    return tile


def convertPtsInto2DMaskArray(pts, imgNullVal):
    """Points list -> minimal bounding-box 0/1 mask tile
    (reference: tilingstats.py:1795-1843)."""
    xmin, ymin = pts['x'].min(), pts['y'].min()
    xs = (pts['x'] - xmin).astype(numpy.int64)
    ys = (pts['y'] - ymin).astype(numpy.int64)
    mask = numpy.zeros((ys.max() + 1, xs.max() + 1), dtype=numpy.uint8)
    mask[ys, xs] = 1
    return mask


def _spatialTilePixels(tileSegments, tileImageData, leftPix, topLine,
                       imgNullVal, numSeg):
    """
    Shared per-tile prologue of every spatial accumulation route:
    whole-image pixel coordinates, null-segment filtering, seen/noData
    completeness bincounts, and nodata-pixel exclusion (values compared
    in imageValueType). Returns
    ``(seen, noData, seg, xx, yy, val)`` over the non-null non-nodata
    pixels, or None for an all-null tile. ONE implementation so the
    point-list and streaming accumulators can never drift in their
    completeness accounting.
    """
    seg = tileSegments.ravel().astype(numpy.int64)
    val = tileImageData.ravel().astype(imageValueType)
    w = tileSegments.shape[1]
    yy, xx = numpy.divmod(numpy.arange(seg.size), w)
    xx = (xx + leftPix).astype(numpy.uint32)
    yy = (yy + topLine).astype(numpy.uint32)

    keep = seg != shepseg.SEGNULLVAL
    seg, val, xx, yy = seg[keep], val[keep], xx[keep], yy[keep]
    if seg.size == 0:
        return None
    seen = numpy.bincount(seg, minlength=numSeg
                          ).astype(numpy.int64)[:numSeg]
    noData = None
    if imgNullVal is not None:
        isNull = val == imageValueType(imgNullVal)
        if isNull.any():
            noData = numpy.bincount(
                seg[isNull], minlength=numSeg
            ).astype(numpy.int64)[:numSeg]
        seg, val, xx, yy = (seg[~isNull], val[~isNull], xx[~isNull],
                            yy[~isNull])
    return (seen, noData, seg, xx, yy, val)


def compactTileSpatial(tileSegments, tileImageData, leftPix, topLine,
                       imgNullVal, numSeg):
    """
    Group one tile's pixels by segment for the spatial accumulator:
    returns (seenCounts, noDataCounts-or-None,
    [(segId, xs, ys, vals), ...] in ascending segment order with pixels
    in scan order), or None for an all-null tile. Pure function of the
    tile — safe to run on worker threads.
    """
    pix = _spatialTilePixels(tileSegments, tileImageData, leftPix,
                             topLine, imgNullVal, numSeg)
    if pix is None:
        return None
    (seen, noData, seg, xx, yy, val) = pix
    groups = []
    if seg.size:
        order = numpy.argsort(seg, kind='stable')
        seg, val, xx, yy = seg[order], val[order], xx[order], yy[order]
        boundary = numpy.concatenate([[True], seg[1:] != seg[:-1]])
        starts = numpy.nonzero(boundary)[0]
        ends = numpy.append(starts[1:], len(seg))
        for s, e in zip(starts, ends):
            groups.append((int(seg[s]), xx[s:e], yy[s:e], val[s:e]))
    return (seen, noData, groups)


class SegmentPointAccumulator:
    """
    Streaming per-segment pixel-coordinate accumulator for spatial stats
    (replaces the reference's SegPoint typed lists,
    tilingstats.py:1219-1259, 1651-1740). Coordinates are whole-image
    (x=col, y=row). NoData pixels are counted but not stored.
    """

    def __init__(self, numSeg, imgNullVal):
        self.numSeg = numSeg
        self.imgNullVal = imgNullVal
        self.chunks = {}  # segId -> list of (x, y, val) arrays
        self.noData = numpy.zeros(numSeg, dtype=numpy.int64)
        self.seen = numpy.zeros(numSeg, dtype=numpy.int64)
        self.touched = numpy.zeros(numSeg, dtype=bool)
        self.done = numpy.zeros(numSeg, dtype=bool)

    def accumulate(self, tileSegments, tileImageData, leftPix, topLine):
        self.merge(compactTileSpatial(tileSegments, tileImageData,
                                      leftPix, topLine, self.imgNullVal,
                                      self.numSeg))

    def merge(self, compacted):
        """Merge one tile's pre-grouped points (from
        :func:`compactTileSpatial`); appending in row-major tile order
        preserves the reference's per-segment scan-order point lists."""
        if compacted is None:
            return
        seen, noData, groups = compacted
        self.touched |= seen > 0
        self.seen += seen
        if noData is not None:
            self.noData += noData
        for (segId, xs, ys, vs) in groups:
            self.chunks.setdefault(segId, []).append((xs, ys, vs))

    def completedSegments(self, segSize):
        complete = (self.touched & ~self.done &
                    (self.seen == segSize[:self.numSeg]))
        complete[shepseg.SEGNULLVAL] = False
        return numpy.nonzero(complete)[0]

    def extractSegment(self, segId):
        parts = self.chunks.pop(int(segId), [])
        self.done[segId] = True
        if parts:
            x = numpy.concatenate([p[0] for p in parts])
            y = numpy.concatenate([p[1] for p in parts])
            v = numpy.concatenate([p[2] for p in parts])
        else:
            x = numpy.empty(0, numpy.uint32)
            y = numpy.empty(0, numpy.uint32)
            v = numpy.empty(0, imageValueType)
        return makePtsArray(x, y, v)


# ------------------------- reference spatial dict-kernel compat layer
#
# Drop-in equivalents of the reference's typed-dict spatial accumulation
# kernels (reference: tilingstats.py:1219-1259, 1651-1740, 1846-1932) on
# plain Python containers. The user callback receives the points as the
# framework's recarray (fields x, y, val — element access ``pts[i].x``
# and vector access ``pts['x']`` both work), built from the accumulated
# SegPoint list just before the call.


class SegPoint:
    """One data point and its whole-image pixel location
    (reference SegPoint jitclass: tilingstats.py:1219-1242)."""

    __slots__ = ('x', 'y', 'val')

    def __init__(self, x, y, val):
        self.x = x
        self.y = y
        self.val = val


def createSegSpatialDataDict():
    """Dictionary keyed on segment ID holding each segment's list of
    :class:`SegPoint` (reference: tilingstats.py:1245-1259)."""
    return {}


def accumulateSegSpatial(segDict, noDataDict, imgNullVal, tileSegments,
                         tileImageData, topLine, leftPix):
    """
    Accumulate each segment's pixel locations and values for the given
    tile into segDict, nodata counts into noDataDict
    (reference: tilingstats.py:1651-1700; grouped with one stable sort
    instead of the per-pixel dict probes).
    """
    ysize, xsize = tileSegments.shape
    seg = tileSegments.ravel().astype(numpy.int64)
    val = tileImageData.ravel().astype(imageValueType)
    flat = numpy.arange(ysize * xsize, dtype=numpy.int64)
    yy = (flat // xsize + topLine).astype(numpy.uint32)
    xx = (flat % xsize + leftPix).astype(numpy.uint32)
    keep = seg != shepseg.SEGNULLVAL
    seg, val, yy, xx = seg[keep], val[keep], yy[keep], xx[keep]
    for s in numpy.unique(seg).tolist():
        if s not in segDict:
            segDict[s] = []
    if imgNullVal is not None:
        isNull = val == imageValueType(imgNullVal)
        if isNull.any():
            nullSegs, nullCounts = numpy.unique(seg[isNull],
                                                return_counts=True)
            for s, c in zip(nullSegs.tolist(), nullCounts.tolist()):
                noDataDict[s] = noDataDict.get(s, 0) + c
            seg, val, yy, xx = (seg[~isNull], val[~isNull],
                                yy[~isNull], xx[~isNull])
    if len(seg) == 0:
        return
    # stable sort preserves the reference's row-major within-segment order
    order = numpy.argsort(seg, kind='stable')
    seg, val, yy, xx = seg[order], val[order], yy[order], xx[order]
    segIds, bounds = numpy.unique(seg, return_index=True)
    bounds = numpy.append(bounds, len(seg))
    for i, s in enumerate(segIds.tolist()):
        lo, hi = bounds[i], bounds[i + 1]
        segDict[s].extend(
            SegPoint(int(x), int(y), int(v))
            for x, y, v in zip(xx[lo:hi].tolist(), yy[lo:hi].tolist(),
                               val[lo:hi].tolist()))


def checkSegCompleteSpatial(segDict, noDataDict, segSize, segId):
    """True when the segment's accumulated point count plus its nodata
    count equals the segment size (reference: tilingstats.py:1702-1740)."""
    count = len(segDict[segId]) if segId in segDict else 0
    count += noDataDict.get(segId, 0)
    return count == segSize[segId]


def calcStatsForCompletedSegsSpatial(segDict, noDataDict,
                                     missingStatsValue, pagedRat, segSize,
                                     userFunc, userParam,
                                     statsSelection_fast, intArr, floatArr,
                                     imgNullVal):
    """
    Invoke ``userFunc`` for every complete segment, write its
    intArr/floatArr outputs into the paged RAT, and drop the segment's
    points (reference: tilingstats.py:1846-1932). The point list is
    converted to the framework's pts recarray before the call.
    """
    maxSegId = len(segSize) - 1
    for segId in list(segDict.keys()):
        if not checkSegCompleteSpatial(segDict, noDataDict, segSize,
                                       segId):
            continue
        ratPageId = getRatPageId(segId)
        if ratPageId not in pagedRat:
            numSegThisPage = min(RAT_PAGE_SIZE, maxSegId - ratPageId + 1)
            pagedRat[ratPageId] = RatPage(intArr.shape[0],
                                          floatArr.shape[0],
                                          ratPageId, numSegThisPage)
        ratPage = pagedRat[ratPageId]
        segList = segDict[segId]
        if len(segList) > 0:
            intArr.fill(missingStatsValue)
            floatArr.fill(missingStatsValue)
            pts = makePtsArray(
                numpy.array([p.x for p in segList], dtype=numpy.uint32),
                numpy.array([p.y for p in segList], dtype=numpy.uint32),
                numpy.array([p.val for p in segList],
                            dtype=imageValueType))
            userFunc(pts, imgNullVal, intArr, floatArr, userParam)
            for n in range(statsSelection_fast.shape[0]):
                colType = int(statsSelection_fast[n, STATSEL_COLTYPE])
                colArrayNdx = int(
                    statsSelection_fast[n, STATSEL_COLARRAYINDEX])
                if colType == STAT_DTYPE_INT:
                    ratPage.setRatVal(segId, STAT_DTYPE_INT, colArrayNdx,
                                      intArr[colArrayNdx])
                else:
                    ratPage.setRatVal(segId, STAT_DTYPE_FLOAT,
                                      colArrayNdx, floatArr[colArrayNdx])
        else:
            for n in range(statsSelection_fast.shape[0]):
                colType = int(statsSelection_fast[n, STATSEL_COLTYPE])
                colArrayNdx = int(
                    statsSelection_fast[n, STATSEL_COLARRAYINDEX])
                ratPage.setRatVal(segId, colType, colArrayNdx,
                                  missingStatsValue)
        ratPage.setSegmentComplete(segId)
        segDict.pop(segId)
        noDataDict.pop(segId, None)


def createUserColumnsSpatial(colNamesAndTypes, attrTbl, existingColNames):
    """
    Create user columns for spatial stats; returns
    (numIntCols+1, numFloatCols+1, userColFast) where userColFast rows are
    (globalColIdx, colType, colArrayIdx) (reference: tilingstats.py:
    1587-1648 — the reference reserves one extra slot in each array).
    """
    numIntCols = 0
    numFloatCols = 0
    rows = []
    for (colName, colType) in colNamesAndTypes:
        if colName not in existingColNames:
            attrTbl.CreateColumn(colName, colType, rio.GFU_Generic)
            colNdx = attrTbl.GetColumnCount() - 1
            existingColNames.append(colName)
        else:
            colNdx = existingColNames.index(colName)
        if colType == rio.GFT_Integer:
            statType = STAT_DTYPE_INT
            arrayNdx = numIntCols
            numIntCols += 1
        elif colType == rio.GFT_Real:
            statType = STAT_DTYPE_FLOAT
            arrayNdx = numFloatCols
            numFloatCols += 1
        else:
            raise PyShepSegStatsError(
                "Only integer and float columns supported")
        rows.append((colNdx, statType, arrayNdx))
    userColFast = numpy.array(rows, dtype=numpy.uint32).reshape(-1, 3)
    return (numIntCols + 1, numFloatCols + 1, userColFast)


class StreamingSpatialUserFunc:
    """
    PUBLIC streaming contract for spatial per-segment user functions
    whose statistic is a per-pixel REDUCTION (sums/counts/extrema):
    instead of accumulating every segment's pixel-coordinate list and
    invoking a per-segment callback (the reference's only model,
    reference tilingstats.py:1262-1390), the engine streams each tile
    through vectorized hooks and never materializes point lists at all —
    per-segment state is a handful of (numSeg,) arrays.

    Hooks (all vectorized, no per-segment Python):

    - ``tileContrib(segIds, xx, yy, vals) -> contrib`` — one tile's
      non-null pixels (img-nodata pixels already removed); segIds int64,
      xx/yy uint32 whole-image coords. May run on reader threads; must
      be pure. Typically a tuple of ``numpy.bincount`` arrays.
    - ``mergeContrib(state, contrib)`` — fold one tile's contribution
      into the state dict (main thread, strict row-major tile order, so
      float accumulation order is deterministic and identical for
      serial and threaded reads).
    - ``finalizeRows(state, segIds) -> (intRows, floatRows)`` — compute
      the finished segments' column rows in one vectorized call;
      intRows (len(segIds), numIntCols) int64 or None, floatRows
      (len(segIds), numFloatCols) float64 or None. Segments arrive here
      only when complete and with >= 1 non-null pixel.

    ``initState(numSeg)`` returns the state dict. Instances are passed
    as the ``userFunc`` argument of calcPerSegmentSpatialStatsTiled
    (userParam is ignored — bind parameters in the instance).
    """

    def __init__(self, initState, tileContrib, mergeContrib,
                 finalizeRows, tileContrib2D=None, haloPixels=0):
        self.initState = initState
        self.tileContrib = tileContrib
        self.mergeContrib = mergeContrib
        self.finalizeRows = finalizeRows
        # Optional faster hook: ``tileContrib2D(seg2d, val2d, leftPix,
        # topLine, imgNullVal)`` receives the RAW 2-D tile (nodata
        # pixels NOT removed — mask them into segment 0 before any
        # bincount) and skips the engine's per-pixel coordinate/masking
        # construction entirely. When present it is used instead of
        # tileContrib.
        self.tileContrib2D = tileContrib2D
        # haloPixels > 0 requests NEIGHBOURHOOD context: tileContrib2D
        # receives seg2d/val2d expanded by haloPixels on every side
        # (the logical tile is [halo:-halo, halo:-halo]); off-image
        # positions are padded with the null segment id / the image
        # null value, so "beyond the image edge" reads as "no
        # same-segment support" — exactly the reference's bounding-box
        # mask semantics. This is what lets per-pixel statistics that
        # look at neighbours (edge-pixel counts) stream tile by tile
        # instead of accumulating whole-segment point lists.
        self.haloPixels = int(haloPixels)
        if self.haloPixels and tileContrib2D is None:
            raise PyShepSegStatsError(
                "haloPixels requires a tileContrib2D hook")


def streamingMeanCoord(transform):
    """
    Streaming-reduction equivalent of :func:`userFuncMeanCoord` (the
    engine substitutes it automatically when userFuncMeanCoord is
    passed): per-segment mean easting/northing as three running
    ``bincount`` sums, no coordinate lists. Numerically it differs from
    the per-segment-list mean only in float64 summation order
    (well inside the golden test's 3e-4 tolerance; the walk itself is
    exact for the affine transform).
    """
    t = numpy.asarray(transform, dtype=numpy.float64)

    def initState(numSeg):
        return {'gx': numpy.zeros(numSeg, numpy.float64),
                'gy': numpy.zeros(numSeg, numpy.float64),
                'cnt': numpy.zeros(numSeg, numpy.int64),
                'numSeg': numSeg}

    def tileContrib(segIds, xx, yy, vals):
        # generic per-pixel fallback (tileContrib2D below is the fast
        # route the engine actually uses)
        hi = int(segIds.max()) + 1
        sx = numpy.bincount(segIds, weights=xx.astype(numpy.float64),
                            minlength=hi)
        sy = numpy.bincount(segIds, weights=yy.astype(numpy.float64),
                            minlength=hi)
        cnt = numpy.bincount(segIds, minlength=hi)
        return sx, sy, cnt

    coordCache = {}

    def tileContrib2D(seg2d, val2d, leftPix, topLine, imgNullVal):
        # Three bincounts over the raw tile — no per-pixel coordinate
        # arrays, masks, or transforms. Pixel x/y are integers, so the
        # float64 per-segment sums are EXACT; the geotransform is
        # applied to the per-segment sums at finalize (algebraically
        # identical, numerically exact). The tile-local coordinate
        # planes are cached per tile shape; global offsets fold in as
        # leftPix*cnt / topLine*cnt.
        shape = seg2d.shape
        if shape not in coordCache:
            yy, xx = numpy.mgrid[0:shape[0], 0:shape[1]]
            coordCache[shape] = (xx.ravel().astype(numpy.float64),
                                 yy.ravel().astype(numpy.float64))
        xxl, yyl = coordCache[shape]
        seg = seg2d.ravel()
        if imgNullVal is not None:
            # compare in imageValueType like every other accumulation
            # path (compactTileSpatial casts pixel values to int64
            # before the nodata test; identical here — the API rejects
            # float imagery, but the semantics must not depend on which
            # route ran)
            isNull = (val2d.ravel().astype(imageValueType) ==
                      imageValueType(imgNullVal))
            if isNull.any():
                # nodata pixels drop into bin 0, which is never read
                seg = numpy.where(isNull, shepseg.SEGNULLVAL, seg)
        hi = int(seg.max()) + 1
        sx = numpy.bincount(seg, weights=xxl, minlength=hi)
        sy = numpy.bincount(seg, weights=yyl, minlength=hi)
        cnt = numpy.bincount(seg, minlength=hi).astype(numpy.float64)
        sx += leftPix * cnt
        sy += topLine * cnt
        sx[shepseg.SEGNULLVAL] = 0.0
        sy[shepseg.SEGNULLVAL] = 0.0
        cnt[shepseg.SEGNULLVAL] = 0.0
        return sx, sy, cnt

    def mergeContrib(state, contrib):
        sx, sy, cnt = contrib
        k = min(len(cnt), state['numSeg'])
        state['gx'][:k] += sx[:k]
        state['gy'][:k] += sy[:k]
        state['cnt'][:k] += cnt[:k].astype(numpy.int64)

    def finalizeRows(state, segIds):
        cnt = state['cnt'][segIds].astype(numpy.float64)
        mx = state['gx'][segIds] / cnt
        my = state['gy'][segIds] / cnt
        rows = numpy.empty((len(segIds), 2), numpy.float64)
        rows[:, 0] = t[0] + t[1] * mx + t[2] * my
        rows[:, 1] = t[3] + t[4] * mx + t[5] * my
        return None, rows

    return StreamingSpatialUserFunc(initState, tileContrib, mergeContrib,
                                    finalizeRows,
                                    tileContrib2D=tileContrib2D)


def streamingNumEdgePixels(fourConnected):
    """
    Streaming-reduction equivalent of :func:`userFuncNumEdgePixels`
    (substituted automatically on the host engine): per-segment
    edge-pixel counts via shifted whole-tile comparisons over a
    1-pixel-halo read — no per-segment coordinate lists or bounding-box
    masks are ever built.

    Semantics are exactly the reference's bbox-mask definition
    (reference tilingstats.py:1145-1216): a valid (non-nodata,
    non-null-segment) pixel is an edge pixel iff any 4/8-neighbour is
    NOT a valid pixel of the same segment. A neighbour outside the
    segment's bounding box is never a valid same-segment pixel (the box
    bounds them all), so "outside the bbox mask" and "any neighbour
    with a different support id" decide identically; nodata neighbours
    are excluded from the point list there and mapped to the null
    support id here; off-image neighbours are the mask's zero border
    there and the engine's null-padded halo here.
    """
    if fourConnected:
        offsets = ((-1, 0), (1, 0), (0, -1), (0, 1))
    else:
        offsets = ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1),
                   (1, -1), (1, 0), (1, 1))

    def initState(numSeg):
        return {'edge': numpy.zeros(numSeg, numpy.int64),
                'numSeg': numSeg}

    def tileContrib2D(segEx, valEx, leftPix, topLine, imgNullVal):
        # support plane: the segment id where the pixel is valid, the
        # null id where it is nodata (a nodata neighbour gives no
        # same-segment support, like its absence from the reference's
        # point list)
        if imgNullVal is not None:
            sup = numpy.where(
                valEx.astype(imageValueType) == imageValueType(imgNullVal),
                segEx.dtype.type(shepseg.SEGNULLVAL), segEx)
        else:
            sup = segEx
        H, W = segEx.shape
        core = segEx[1:-1, 1:-1]
        edge = numpy.zeros(core.shape, dtype=bool)
        for dy, dx in offsets:
            edge |= sup[1 + dy:H - 1 + dy, 1 + dx:W - 1 + dx] != core
        # countable = valid pixels: non-null segment AND non-nodata
        # (sup == core exactly on non-nodata pixels)
        countable = (core != shepseg.SEGNULLVAL) & (sup[1:-1, 1:-1] == core)
        hits = core[edge & countable]
        if hits.size == 0:
            return None
        return numpy.bincount(hits.astype(numpy.int64))

    def tileContrib(segIds, xx, yy, vals):  # pragma: no cover
        raise PyShepSegStatsError(
            "streamingNumEdgePixels requires the halo tile route")

    def mergeContrib(state, cnt):
        k = min(len(cnt), state['numSeg'])
        state['edge'][:k] += cnt[:k]

    def finalizeRows(state, segIds):
        return state['edge'][segIds][:, None], None

    return StreamingSpatialUserFunc(initState, tileContrib, mergeContrib,
                                    finalizeRows,
                                    tileContrib2D=tileContrib2D,
                                    haloPixels=1)


def streamingVariogram(maxDist):
    """
    Streaming-reduction equivalent of :func:`userFuncVariogram`
    (substituted automatically on the host engine): per-segment
    variograms at integer distances 1..maxDist via shifted whole-tile
    comparisons over a maxDist-pixel-halo read.

    The reference kernel (reference tilingstats.py:1037-1094) walks the
    POSITIVE offset quadrant only (yoffset, xoffset both >= 1 — purely
    horizontal/vertical pairs are never sampled) over each segment's
    null-filled bounding-box tile; the pair set at one offset is
    therefore exactly "both pixels valid, same segment". The streaming
    form accumulates the identical pair set tile by tile: a pair whose
    partner lies in a neighbouring tile is picked up through the halo
    by the tile that holds its base pixel, and only there (offsets are
    positive, so the partner tile never re-roots the pair). Sums are
    float64 either way; only the addition order differs.
    """
    maxDist = int(maxDist)
    offs = []
    for yoffset in range(1, maxDist + 1):
        for xoffset in range(1, maxDist + 1):
            dist = int(numpy.sqrt(yoffset * yoffset + xoffset * xoffset))
            if 1 <= dist <= maxDist:
                offs.append((yoffset, xoffset, dist))

    def initState(numSeg):
        return {'counts': numpy.zeros((numSeg, maxDist), numpy.int64),
                'sumsq': numpy.zeros((numSeg, maxDist), numpy.float64),
                'numSeg': numSeg}

    def tileContrib2D(segEx, valEx, leftPix, topLine, imgNullVal):
        h = maxDist
        ys = segEx.shape[0] - 2 * h
        xs = segEx.shape[1] - 2 * h
        core = segEx[h:h + ys, h:h + xs]
        coreVal = valEx[h:h + ys, h:h + xs].astype(numpy.float64)
        if imgNullVal is None:
            # every value is data (the JAX package's copy of this hook
            # has no such guard and raises here)
            validEx = numpy.ones(valEx.shape, dtype=bool)
        else:
            validEx = (valEx.astype(imageValueType) !=
                       imageValueType(imgNullVal))
        coreOk = (core != shepseg.SEGNULLVAL) & validEx[h:h + ys, h:h + xs]
        counts = []
        sumsqs = []
        hi = 0
        for (dy, dx, dist) in offs:
            segB = segEx[h + dy:h + dy + ys, h + dx:h + dx + xs]
            ok = coreOk & (segB == core) & \
                validEx[h + dy:h + dy + ys, h + dx:h + dx + xs]
            ids = core[ok].astype(numpy.int64)
            if ids.size == 0:
                counts.append((dist, None))
                sumsqs.append((dist, None))
                continue
            d = coreVal[ok] - valEx[h + dy:h + dy + ys,
                                    h + dx:h + dx + xs][ok]
            cnt = numpy.bincount(ids)
            ssq = numpy.bincount(ids, weights=d * d)
            hi = max(hi, len(cnt))
            counts.append((dist, cnt))
            sumsqs.append((dist, ssq))
        if hi == 0:
            return None
        cntArr = numpy.zeros((hi, maxDist), numpy.int64)
        ssqArr = numpy.zeros((hi, maxDist), numpy.float64)
        for (dist, cnt), (_d, ssq) in zip(counts, sumsqs):
            if cnt is not None:
                cntArr[:len(cnt), dist - 1] += cnt
                ssqArr[:len(ssq), dist - 1] += ssq
        return (cntArr, ssqArr)

    def tileContrib(segIds, xx, yy, vals):  # pragma: no cover
        raise PyShepSegStatsError(
            "streamingVariogram requires the halo tile route")

    def mergeContrib(state, contrib):
        cntArr, ssqArr = contrib
        k = min(len(cntArr), state['numSeg'])
        state['counts'][:k] += cntArr[:k]
        state['sumsq'][:k] += ssqArr[:k]

    def finalizeRows(state, segIds):
        cnt = state['counts'][segIds].astype(numpy.float64)
        ssq = state['sumsq'][segIds]
        with numpy.errstate(divide='ignore', invalid='ignore'):
            rows = numpy.sqrt(ssq / cnt)
        # zero-pair bins: the reference leaves the column untouched
        # (missingStatsValue); NaN here becomes missingStatsValue in
        # the streaming finalize
        rows[cnt == 0] = numpy.nan
        return None, rows

    return StreamingSpatialUserFunc(initState, tileContrib, mergeContrib,
                                    finalizeRows,
                                    tileContrib2D=tileContrib2D,
                                    haloPixels=maxDist)


class _StreamingSpatialAccumulator:
    """Completeness bookkeeping for the streaming spatial route: same
    seen/noData accounting as SegmentPointAccumulator, but the only
    per-segment payload is the user func's reduction state."""

    def __init__(self, numSeg, imgNullVal, streamFn):
        self.numSeg = numSeg
        self.imgNullVal = imgNullVal
        self.streamFn = streamFn
        self.state = streamFn.initState(numSeg)
        self.noData = numpy.zeros(numSeg, dtype=numpy.int64)
        self.seen = numpy.zeros(numSeg, dtype=numpy.int64)
        self.touched = numpy.zeros(numSeg, dtype=bool)
        self.done = numpy.zeros(numSeg, dtype=bool)

    def compactTile(self, tileSegments, tileImageData, window):
        """Per-tile vectorized pass (reader-thread safe): completeness
        counts + the user func's tile contribution. With
        ``streamFn.haloPixels`` the incoming arrays are the expanded
        clamped reads from the tile stream."""
        (xsize, ysize, leftPix, topLine) = window
        halo = self.streamFn.haloPixels
        if halo > 0:
            # Pad the clamped expanded read out to the full halo at the
            # image edges: null segment id / image null value, so the
            # hook's neighbour test reads off-image as "no same-segment
            # support" (the reference's bbox-mask border, reference
            # tilingstats.py:1795-1843).
            topPad = halo - min(halo, topLine)
            leftPad = halo - min(halo, leftPix)
            botPad = (ysize + 2 * halo) - tileSegments.shape[0] - topPad
            rightPad = (xsize + 2 * halo) - tileSegments.shape[1] - leftPad
            pads = ((topPad, botPad), (leftPad, rightPad))
            segEx = numpy.pad(tileSegments, pads,
                              constant_values=shepseg.SEGNULLVAL)
            nullPad = 0 if self.imgNullVal is None else self.imgNullVal
            valEx = numpy.pad(tileImageData, pads,
                              constant_values=nullPad)
            core = segEx[halo:halo + ysize, halo:halo + xsize]
            coreVal = valEx[halo:halo + ysize, halo:halo + xsize]
            n = self.numSeg
            seg = core.ravel()
            seen = numpy.bincount(
                seg, minlength=n).astype(numpy.int64)[:n]
            seen[shepseg.SEGNULLVAL] = 0
            noData = None
            if self.imgNullVal is not None:
                isNull = ((coreVal.ravel().astype(imageValueType) ==
                           imageValueType(self.imgNullVal)) &
                          (seg != shepseg.SEGNULLVAL))
                if isNull.any():
                    noData = numpy.bincount(
                        seg[isNull], minlength=n
                    ).astype(numpy.int64)[:n]
            contrib = self.streamFn.tileContrib2D(
                segEx, valEx, leftPix, topLine, self.imgNullVal)
            return (seen, noData, contrib)
        if self.streamFn.tileContrib2D is not None:
            # fast route: straight bincounts on the raw tile, no
            # per-pixel coordinate/mask construction. The nodata test
            # casts pixel values to imageValueType exactly like
            # compactTileSpatial does, so both accumulators' seen/noData
            # completeness accounting stays identical.
            n = self.numSeg
            seg = tileSegments.ravel()
            seen = numpy.bincount(
                seg, minlength=n).astype(numpy.int64)[:n]
            seen[shepseg.SEGNULLVAL] = 0
            noData = None
            if self.imgNullVal is not None:
                isNull = ((tileImageData.ravel().astype(imageValueType) ==
                           imageValueType(self.imgNullVal)) &
                          (seg != shepseg.SEGNULLVAL))
                if isNull.any():
                    noData = numpy.bincount(
                        seg[isNull], minlength=n
                    ).astype(numpy.int64)[:n]
            contrib = self.streamFn.tileContrib2D(
                tileSegments, tileImageData, leftPix, topLine,
                self.imgNullVal)
            return (seen, noData, contrib)
        pix = _spatialTilePixels(tileSegments, tileImageData, leftPix,
                                 topLine, self.imgNullVal, self.numSeg)
        if pix is None:
            return None
        (seen, noData, seg, xx, yy, val) = pix
        contrib = (self.streamFn.tileContrib(seg, xx, yy, val)
                   if seg.size else None)
        return (seen, noData, contrib)

    def merge(self, compacted):
        if compacted is None:
            return
        seen, noData, contrib = compacted
        self.touched |= seen > 0
        self.seen += seen
        if noData is not None:
            self.noData += noData
        if contrib is not None:
            self.streamFn.mergeContrib(self.state, contrib)

    def completedSegments(self, segSize):
        complete = (self.touched & ~self.done &
                    (self.seen == segSize[:self.numSeg]))
        complete[shepseg.SEGNULLVAL] = False
        return numpy.nonzero(complete)[0]


def _spatialFinalizeCompletedStreaming(acc, segSize, missingStatsValue,
                                       pagedRat, userColFast, numIntCols,
                                       numFloatCols):
    """Batch-finalize every segment that just completed through the
    streaming user func: one vectorized finalizeRows call, then the
    paged-RAT row writes."""
    segIds = acc.completedSegments(segSize)
    if len(segIds) == 0:
        return
    acc.done[segIds] = True
    # segments whose every pixel was nodata get missingStatsValue rows
    nPts = acc.seen[segIds] - acc.noData[segIds]
    live = nPts > 0
    intRows = numpy.full((len(segIds), numIntCols), missingStatsValue,
                         dtype=numpy.int64)
    floatRows = numpy.full((len(segIds), numFloatCols),
                           missingStatsValue, dtype=numpy.float64)
    if live.any():
        ir, fr = acc.streamFn.finalizeRows(acc.state, segIds[live])
        if ir is not None:
            intRows[live, :ir.shape[1]] = ir
        if fr is not None:
            # NaN = "no data for this column" (e.g. a variogram bin
            # with zero pairs): keep missingStatsValue, matching the
            # host kernels that leave floatArr untouched
            floatRows[live, :fr.shape[1]] = numpy.where(
                numpy.isnan(fr), missingStatsValue, fr)
    for i, segId in enumerate(segIds):
        _writeSpatialRow(pagedRat, segId, intRows[i], floatRows[i],
                         userColFast, numIntCols, numFloatCols,
                         acc.numSeg)


def calcPerSegmentSpatialStatsTiled(imgfile, imgbandnum, segfile,
        colNamesAndTypes, userFunc, userParam, missingStatsValue=-9999,
        numReadWorkers=None, engine='auto', device="cuda"):
    """
    Spatial per-segment statistics: accumulate every segment's pixel
    coordinates (whole-image space), and when a segment completes, call
    ``userFunc(pts, imgNullVal, intArr, floatArr, userParam)`` to fill the
    requested RAT columns (reference: tilingstats.py:1262-1390).

    ``pts`` is a recarray with fields x, y, val. ``colNamesAndTypes`` is a
    list of (columnName, gdal column type) tuples. The imagery must have a
    nodata value set (matching the reference's requirement).

    ``numReadWorkers`` works as in :func:`calcPerSegmentStatsTiled`.

    ``engine='device'`` (or 'auto' with a CUDA ``device``, see
    _resolveStatsEngine) evaluates the BUILT-IN user functions
    (userFuncVariogram, userFuncNumEdgePixels) and every
    :class:`DeviceSpatialUserFunc` as batched torch functions on
    ``device`` over padded per-segment bounding boxes
    (ops/spatialstats.py); other callbacks and userFuncMeanCoord always
    run on the host. ``device`` is "cuda" by default, which raises where
    CUDA is absent. On the host engine
    every built-in streams instead of accumulating point lists:
    userFuncMeanCoord always, userFuncNumEdgePixels through the
    1-pixel-halo tile route (:func:`streamingNumEdgePixels`), and
    userFuncVariogram through a maxDist-halo route for maxDist <= 8
    (:func:`streamingVariogram`).
    """
    device = _kernels.torch_device(device)
    numReadWorkers = _defaultReadWorkers(numReadWorkers, segfile)
    timings = timinghooks.Timers()

    segds, segband, imgds, imgband = doImageAlignmentChecks(
        segfile, imgfile, imgbandnum)

    imgNullVal = imgband.GetNoDataValue()
    if imgNullVal is None:
        raise PyShepSegStatsError("imgfile must have a nodata value set")
    imgNullVal = imageValueType(imgNullVal)

    attrTbl = segband.GetDefaultRAT()
    existingColNames = [attrTbl.GetNameOfCol(i)
                        for i in range(attrTbl.GetColumnCount())]
    histColNdx = checkHistColumn(existingColNames)
    segSize = attrTbl.ReadAsArray(histColNdx).astype(numpy.int64)
    numSeg = len(segSize)

    (numIntCols, numFloatCols, userColFast) = createUserColumnsSpatial(
        colNamesAndTypes, attrTbl, existingColNames)

    # Streaming-reduction fast path: a StreamingSpatialUserFunc never
    # materializes per-segment coordinate lists (userFuncMeanCoord is
    # substituted automatically — its statistic is a pure reduction).
    useDevice = _resolveStatsEngine(engine, imgband, device)
    streamFn = userFunc if isinstance(userFunc,
                                      StreamingSpatialUserFunc) else None
    if streamFn is None and userFunc is userFuncMeanCoord:
        streamFn = streamingMeanCoord(userParam)
    if streamFn is None and userFunc is userFuncNumEdgePixels \
            and not useDevice:
        # the host engine streams edge counts through the halo route;
        # engine='device' keeps the batched DeviceSpatialUserFunc box
        # functions
        streamFn = streamingNumEdgePixels(userParam)
    if streamFn is None and userFunc is userFuncVariogram \
            and not useDevice and int(userParam) <= 8:
        # variograms stream too (halo = maxDist); past maxDist 8 the
        # per-tile offset sweep outgrows the point route's box kernels,
        # so large distances keep the accumulator path
        streamFn = streamingVariogram(userParam)

    if streamFn is not None:
        acc = _StreamingSpatialAccumulator(numSeg, imgNullVal, streamFn)
    else:
        acc = SegmentPointAccumulator(numSeg, imgNullVal)
    pagedRat = createPagedRat()

    tileSize = tiling.TILESIZE
    (nlines, npix) = (segband.YSize, segband.XSize)

    def compactFn(tileSegments, tileImageData, window):
        (xsize, ysize, leftPix, topLine) = window
        if streamFn is not None:
            return acc.compactTile(tileSegments, tileImageData, window)
        return compactTileSpatial(tileSegments, tileImageData, leftPix,
                                  topLine, imgNullVal, numSeg)

    stream = _compactedTileStream(
        nlines, npix, tileSize, segfile, imgfile, imgbandnum,
        (segband, imgband), compactFn, numReadWorkers, timings,
        haloPixels=streamFn.haloPixels if streamFn is not None else 0)
    for compacted in stream:
        with timings.interval('accumulation'):
            acc.merge(compacted)

        with timings.interval('statscompletion'):
            if streamFn is not None:
                _spatialFinalizeCompletedStreaming(
                    acc, segSize, missingStatsValue, pagedRat,
                    userColFast, numIntCols, numFloatCols)
            else:
                handled = useDevice and _spatialFinalizeCompletedDevice(
                    acc, segSize, userFunc, userParam, missingStatsValue,
                    pagedRat, userColFast, numIntCols, numFloatCols,
                    device)
                if not handled:
                    _spatialFinalizeCompleted(acc, segSize, userFunc,
                                              userParam,
                                              missingStatsValue,
                                              pagedRat, userColFast,
                                              numIntCols, numFloatCols)

        with timings.interval('writing'):
            _writeCompletePagesSpatial(pagedRat, attrTbl, userColFast)

    with timings.interval('writing'):
        segds.FlushCache()

    if len(pagedRat) > 0:
        raise PyShepSegStatsError('Not all pixels found during processing')

    rtn = TiledStatsResult()
    rtn.timings = timings
    return rtn


# Largest padded bounding-box bucket the batched device path will ship;
# a segment with a bigger box falls back to the host callback (keeps
# device memory bounded for degenerate scene-spanning segments).
_SPATIAL_DEVICE_MAX_BOX = 2048


class DeviceSpatialUserFunc:
    """
    PUBLIC device contract for spatial per-segment user functions.

    The reference only supports numba host callbacks invoked one segment
    at a time (reference: tilingstats.py:1262-1390). This wrapper takes a
    **torch** callable for ONE segment and evaluates it under
    ``torch.func.vmap`` over a batch of padded per-segment bounding
    boxes on the run's device: one batched call per padded-shape bucket
    per finalization round.

    ``fn(vals, mask, userParam)`` — or ``fn(vals, mask, origin,
    userParam)`` with ``wantsOrigin=True`` — computes ONE segment's
    columns from tensors:

    - ``vals``: (Hb, Wb) float32 padded bounding box of the segment's
      pixel values; padding pixels hold the image null value
    - ``mask``: (Hb, Wb) bool, True exactly on the segment's pixels
    - ``origin``: float32 [ymin, xmin] whole-image coordinates of the
      box's top-left pixel (only with ``wantsOrigin=True``)
    - ``userParam``: the value given to
      calcPerSegmentSpatialStatsTiled. A hashable param (int/bool/float/
      str/tuple) is passed as it is (usable in Python control flow and
      shapes, e.g. a variogram's maxDist), and the vmapped function is
      cached per such value; any other param (an array) goes in as one
      tensor shared by the whole batch.

    ``fn`` must be vmappable: tensor ops with no data-dependent Python
    control flow and no in-place writes to its inputs. It returns
    ``(intRow, floatRow)`` — 1D tensors written into the int and float
    user columns (either may be None). NaN entries of ``floatRow`` become
    ``missingStatsValue``.

    ``hostFallback(pts, imgNullVal, intArr, floatArr, userParam)`` — a
    reference-signature host callback used for degenerate segments whose
    padded box exceeds ``maxBox`` (default 2048, bounding device memory
    for scene-spanning segments) and when the stats engine is 'host'.
    Without one, such a segment runs ``fn`` as a batch of one on its
    (large) box: on the run's device for an oversized box, on the CPU
    when the instance is called as a plain host callback.

    Instances are directly usable as the ``userFunc`` argument of both
    calcPerSegmentSpatialStatsTiled and the RIOS variant, with any
    engine setting; the built-in device routes (deviceFuncVariogram,
    deviceFuncNumEdgePixels, deviceFuncMeanCoord) are instances of this
    same class.
    """

    def __init__(self, fn, hostFallback=None,
                 maxBox=_SPATIAL_DEVICE_MAX_BOX, wantsOrigin=False):
        self.fn = fn
        self.hostFallback = hostFallback
        self.maxBox = int(maxBox)
        self.wantsOrigin = bool(wantsOrigin)
        self._vmapcache = {}

    @staticmethod
    def _isStatic(param):
        try:
            hash(param)
            return True
        except TypeError:
            return False

    def _batchedFn(self, userParam):
        """The vmapped function for ``userParam`` (cached per hashable
        value) and whether the param is passed as it is."""
        static = self._isStatic(userParam)
        key = userParam if static else "__tensor__"
        vfn = self._vmapcache.get(key)
        if vfn is not None:
            return vfn, static

        def one(*args):
            # a None row becomes an empty one: vmap maps tensors only
            rows = (self.fn(*args, userParam) if static else
                    self.fn(*args))
            return tuple(torch.zeros(0) if r is None else r for r in rows)

        inDims = (0, 0, 0) if self.wantsOrigin else (0, 0)
        vfn = torch.func.vmap(one, in_dims=inDims + (() if static
                                                     else (None,)))
        self._vmapcache[key] = vfn
        return vfn, static

    def runBatch(self, vals, masks, origins, userParam, device="cuda"):
        """Evaluate the batch on ``device``; returns (intRows, floatRows)
        as numpy (B, n) arrays or None."""
        device = _kernels.torch_device(device)
        vfn, static = self._batchedFn(userParam)
        args = [torch.from_numpy(vals).to(device),
                torch.from_numpy(masks).to(device)]
        if self.wantsOrigin:
            args.append(torch.from_numpy(origins).to(device))
        if not static:
            args.append(torch.as_tensor(numpy.asarray(userParam),
                                        device=device))
        intRows, floatRows = vfn(*args)

        def toNp(r):
            return None if r.shape[-1] == 0 else r.cpu().numpy()
        return toNp(intRows), toNp(floatRows)

    def evalOne(self, pts, imgNullVal, intArr, floatArr, userParam,
                device="cpu"):
        """Evaluate ONE segment: via hostFallback when given, else ``fn``
        on its single box on ``device``."""
        if self.hostFallback is not None:
            self.hostFallback(pts, imgNullVal, intArr, floatArr,
                              userParam)
            return
        vals = convertPtsInto2DArray(pts, imgNullVal)[None].astype(
            numpy.float32)
        masks = (convertPtsInto2DMaskArray(pts, imgNullVal) != 0)[None]
        origins = numpy.array([[pts['y'].min(), pts['x'].min()]],
                              dtype=numpy.float32)
        intRows, floatRows = self.runBatch(vals, masks, origins,
                                           userParam, device)
        _fillUserRows(intArr, floatArr, intRows, floatRows, 0)

    def __call__(self, pts, imgNullVal, intArr, floatArr, userParam):
        """Reference-signature host entry: :meth:`evalOne` on the CPU, so
        an instance works as a plain userFunc under engine='host'."""
        self.evalOne(pts, imgNullVal, intArr, floatArr, userParam)


def _fillUserRows(intArr, floatArr, intRows, floatRows, i):
    """Copy row i of a device batch result into the reference-signature
    intArr/floatArr (pre-filled with missingStatsValue); float NaNs keep
    the missing value."""
    if intRows is not None:
        n = min(len(intArr), intRows.shape[1])
        intArr[:n] = intRows[i, :n]
    if floatRows is not None:
        n = min(len(floatArr), floatRows.shape[1])
        row = floatRows[i, :n].astype(numpy.float64)
        ok = ~numpy.isnan(row)
        floatArr[:n][ok] = row[ok]


def _deviceVariogramOne(vals, mask, maxDist):
    from .ops import spatialstats as sps
    cnt, sums = sps.variogram_sums(vals[None], mask[None],
                                   max_dist=int(maxDist))
    vario = torch.where(cnt[0] > 0,
                        torch.sqrt(sums[0] / cnt[0].clamp(min=1)),
                        torch.nan)
    return None, vario


def _deviceEdgePixelsOne(vals, mask, fourConnected):
    from .ops import spatialstats as sps
    cnt = sps.edge_pixel_counts(mask[None],
                                four_connected=bool(fourConnected))
    return cnt, None


def _deviceMeanCoordOne(vals, mask, origin, transform):
    m = mask.to(torch.float32)
    n = torch.clamp(m.sum(), min=1.0)
    hb, wb = mask.shape
    yy = torch.arange(hb, dtype=torch.float32, device=m.device)[:, None]
    xx = torch.arange(wb, dtype=torch.float32, device=m.device)[None, :]
    my = (m * yy).sum() / n + origin[0]
    mx = (m * xx).sum() / n + origin[1]
    t = torch.as_tensor(transform, dtype=torch.float32, device=m.device)
    geox = t[0] + t[1] * mx + t[2] * my
    geoy = t[3] + t[4] * mx + t[5] * my
    return None, torch.stack([geox, geoy])


# Built-in spatial functions exposed through the SAME public device
# contract (each pairs the batched device function with its exact host
# fallback). deviceFuncMeanCoord computes in float32 on the device — the
# plain userFuncMeanCoord host path (float64, one vector op off the
# point list, no box scatter) remains the default route for mean
# coordinates.
deviceFuncVariogram = DeviceSpatialUserFunc(
    _deviceVariogramOne, hostFallback=userFuncVariogram)
deviceFuncNumEdgePixels = DeviceSpatialUserFunc(
    _deviceEdgePixelsOne, hostFallback=userFuncNumEdgePixels)
deviceFuncMeanCoord = DeviceSpatialUserFunc(
    _deviceMeanCoordOne, hostFallback=userFuncMeanCoord,
    wantsOrigin=True)


def _deviceContractFor(userFunc):
    """The DeviceSpatialUserFunc to run ``userFunc`` through on the
    device engine, or None for host-only callables. Built-ins route to
    their contract instances; userFuncMeanCoord deliberately stays on
    the host (its point-list computation is one cheap float64 vector op
    — a device box round trip would only add transfer)."""
    if isinstance(userFunc, DeviceSpatialUserFunc):
        return userFunc
    if userFunc is userFuncVariogram:
        return deviceFuncVariogram
    if userFunc is userFuncNumEdgePixels:
        return deviceFuncNumEdgePixels
    return None


def _writeSpatialRow(pagedRat, segId, intArr, floatArr, userColFast,
                     numIntCols, numFloatCols, numSeg):
    """Write one segment's intArr/floatArr into the paged RAT and mark
    it complete."""
    ratPage = _getRatPage(pagedRat, int(segId), numIntCols, numFloatCols,
                          numSeg)
    for (colNdx, statType, arrayNdx) in userColFast:
        if statType == STAT_DTYPE_INT:
            ratPage.setRatVal(int(segId), STAT_DTYPE_INT, int(arrayNdx),
                              intArr[int(arrayNdx)])
        else:
            ratPage.setRatVal(int(segId), STAT_DTYPE_FLOAT, int(arrayNdx),
                              floatArr[int(arrayNdx)])
    ratPage.setSegmentComplete(int(segId))


def _spatialFinalizeCompletedDevice(acc, segSize, userFunc, userParam,
                                    missingStatsValue, pagedRat,
                                    userColFast, numIntCols, numFloatCols,
                                    device):
    """
    Batched device finalization through the DeviceSpatialUserFunc
    contract: segments completing in this round are scattered into
    padded bounding-box tiles, boxes sharing a padded shape batch into
    one vmapped call on ``device``; built-in and custom torch callbacks
    take the identical route. Segments with boxes past the contract's
    maxBox use its host fallback (or one unbatched call on ``device``).
    Returns False when ``userFunc`` has no device route (the caller then
    runs the host loop).
    """
    dev = _deviceContractFor(userFunc)
    if dev is None:
        return False
    from .ops import spatialstats as sps

    numSeg = acc.numSeg
    batches = {}   # padded shape -> [(segId, pts), ...]
    for segId in acc.completedSegments(segSize):
        pts = acc.extractSegment(segId)
        intArr = numpy.full(numIntCols, missingStatsValue,
                            dtype=numpy.int64)
        floatArr = numpy.full(numFloatCols, missingStatsValue,
                              dtype=numpy.float64)
        if len(pts) == 0:
            _writeSpatialRow(pagedRat, segId, intArr, floatArr,
                             userColFast, numIntCols, numFloatCols,
                             numSeg)
            continue
        shape = sps.pad_box_shape(
            int(pts['y'].max() - pts['y'].min() + 1),
            int(pts['x'].max() - pts['x'].min() + 1))
        if max(shape) > dev.maxBox:
            dev.evalOne(pts, acc.imgNullVal, intArr, floatArr, userParam,
                        device)
            _writeSpatialRow(pagedRat, segId, intArr, floatArr,
                             userColFast, numIntCols, numFloatCols,
                             numSeg)
            continue
        batches.setdefault(shape, []).append((segId, pts))

    for shape, members in batches.items():
        segIds = [m[0] for m in members]
        ptsList = [m[1] for m in members]
        vals = sps.scatter_boxes(ptsList, acc.imgNullVal,
                                 numpy.float32, lambda p: p['val'])
        masks = sps.scatter_boxes(ptsList, 0, numpy.uint8, None) != 0
        origins = None
        if dev.wantsOrigin:
            origins = numpy.array(
                [[p['y'].min(), p['x'].min()] for p in ptsList],
                dtype=numpy.float32)
        intRows, floatRows = dev.runBatch(vals, masks, origins,
                                          userParam, device)
        for i, segId in enumerate(segIds):
            intArr = numpy.full(numIntCols, missingStatsValue,
                                dtype=numpy.int64)
            floatArr = numpy.full(numFloatCols, missingStatsValue,
                                  dtype=numpy.float64)
            _fillUserRows(intArr, floatArr, intRows, floatRows, i)
            _writeSpatialRow(pagedRat, segId, intArr, floatArr,
                             userColFast, numIntCols, numFloatCols,
                             numSeg)
    return True


def _spatialFinalizeCompleted(acc, segSize, userFunc, userParam,
                              missingStatsValue, pagedRat, userColFast,
                              numIntCols, numFloatCols):
    """Invoke the user callback for every segment that just completed and
    write its values into the paged RAT
    (reference: tilingstats.py:1846-1932)."""
    numSeg = acc.numSeg
    for segId in acc.completedSegments(segSize):
        pts = acc.extractSegment(segId)
        intArr = numpy.full(numIntCols, missingStatsValue,
                            dtype=numpy.int64)
        floatArr = numpy.full(numFloatCols, missingStatsValue,
                              dtype=numpy.float64)
        if len(pts) > 0:
            userFunc(pts, acc.imgNullVal, intArr, floatArr, userParam)
        _writeSpatialRow(pagedRat, segId, intArr, floatArr, userColFast,
                         numIntCols, numFloatCols, numSeg)


def _writeCompletePagesSpatial(pagedRat, attrTbl, userColFast):
    """Flush complete pages for the spatial-stats user columns."""
    for pageId in list(pagedRat.keys()):
        ratPage = pagedRat[pageId]
        if not ratPage.pageComplete():
            continue
        startSegId = ratPage.startSegId
        numRows = max(ratPage.intcols.shape[1], ratPage.floatcols.shape[1])
        endSegId = startSegId + numRows
        if attrTbl.GetRowCount() < endSegId:
            attrTbl.SetRowCount(endSegId)
        for (colNdx, statType, arrayNdx) in userColFast:
            if statType == STAT_DTYPE_INT:
                colArr = ratPage.intcols[int(arrayNdx)]
            else:
                colArr = ratPage.floatcols[int(arrayNdx)]
            attrTbl.WriteArray(colArr, int(colNdx), start=int(startSegId))
        pagedRat.pop(pageId)


# ------------------------------------------------------------- RIOS glue


def _importRIOS():
    try:
        from rios import applier, ratapplier
    except ImportError:
        raise PyShepSegStatsError(
            "This function requires the rios package; use the *Tiled "
            "variant instead")
    return applier, ratapplier


def _riosCheckConcurrency(applier, concurrencyStyle, controls):
    """Only read-worker concurrency is supported: the accumulator state
    must stay in one process (reference: tilingstats.py:373-380)."""
    if concurrencyStyle is not None:
        if getattr(concurrencyStyle, 'numComputeWorkers', 0) > 0:
            raise PyShepSegStatsError('numComputeWorkers must be zero')
        if (getattr(concurrencyStyle, 'computeWorkerKind', applier.CW_NONE)
                != applier.CW_NONE):
            raise PyShepSegStatsError('computeWorkerKind must be CW_NONE')
        controls.setConcurrencyStyle(concurrencyStyle)


def _riosTempRatTarget(applier, controls, outFile, numRows):
    """
    Create the separate raster whose RAT receives the new columns (RAT
    writes go to a temp file while RIOS holds the inputs open, then get
    copied back — reference: tilingstats.py:345-359, 392-407). Returns
    (path, dataset, attrTbl).
    """
    import os as _os
    if outFile is None:
        tempFileMgr = applier.TempfileManager(
            getattr(controls, 'tempdir', '.'))
        tempPath = tempFileMgr.mktempfile(prefix='pyshepseg_tilingstats_',
                                          suffix='.kea')
    else:
        tempPath = outFile
        if _os.path.exists(tempPath):
            import shutil as _shutil
            if _os.path.isdir(tempPath):
                _shutil.rmtree(tempPath)
            else:
                _os.remove(tempPath)
    driverName = 'KEA' if rio.HAVE_GDAL else None
    ds = rio.create(tempPath, 10, 10, 1, numpy.uint32, driverName)
    band = ds.GetRasterBand(1)
    band.SetMetadataItem('LAYER_TYPE', 'thematic')
    attrTbl = band.GetDefaultRAT()
    attrTbl.SetRowCount(int(numRows))
    return tempPath, ds, attrTbl


def _statsRIOSFunc(info, inputs, outputs, otherArgs):
    """RIOS block callback: accumulate, finalize completed segments,
    flush complete RAT pages (reference: tilingstats.py:219-233)."""
    otherArgs.acc.merge(compactTile(
        inputs.segfile[0], inputs.imgfile[0], otherArgs.acc.imgNullVal,
        otherArgs.acc.numSeg))
    _calcStatsForCompletedSegs(
        otherArgs.acc, otherArgs.segSize, otherArgs.missingStatsValue,
        otherArgs.pagedRat, otherArgs.statsSelection_fast,
        otherArgs.numIntCols, otherArgs.numFloatCols)
    writeCompletePages(otherArgs.pagedRat, otherArgs.attrTbl,
                       otherArgs.statsSelection_fast)


# public name matching the reference's callback (reference:
# tilingstats.py:219 calcPerSegmentStats_riosFunc)
calcPerSegmentStats_riosFunc = _statsRIOSFunc


def calcPerSegmentStatsRIOS(imgfile, imgbandnum, segfile,
        statsSelection, concurrencyStyle=None, missingStatsValue=-9999,
        outFile=None):
    """
    RIOS-driven variant of calcPerSegmentStatsTiled: RIOS performs the
    (optionally read-worker-concurrent) block reading, statistics
    accumulate through the same streaming run accumulator, new columns
    are written to a separate temp RAT while RIOS holds the inputs open,
    and copied back into segfile with ratapplier.copyRAT
    (reference: tilingstats.py:219-407 — same structure and semantics).
    Only read workers are supported (computeWorkerKind CW_NONE).
    """
    applier, ratapplier = _importRIOS()

    segds, segband, imgds, imgband = doImageAlignmentChecks(
        segfile, imgfile, imgbandnum, update=False)
    attrTbl = segband.GetDefaultRAT()
    existingColNames = [attrTbl.GetNameOfCol(i)
                        for i in range(attrTbl.GetColumnCount())]
    imgNullVal = imgband.GetNoDataValue()
    if imgNullVal is not None:
        imgNullVal = imageValueType(imgNullVal)
    histColNdx = checkHistColumn(existingColNames)
    segSize = attrTbl.ReadAsArray(histColNdx).astype(numpy.int64)
    # close our handles so RIOS can open the files its own way
    del attrTbl, segband, segds, imgband, imgds

    controls = applier.ApplierControls()
    controls.selectInputImageLayers([imgbandnum], 'imgfile')
    # the RIOS default 256x256 window leaves too many incomplete
    # segments alive at once and inflates memory (reference:
    # tilingstats.py:338-341)
    controls.setWindowSize(tiling.TILESIZE, tiling.TILESIZE)
    _riosCheckConcurrency(applier, concurrencyStyle, controls)

    tempPath, tempDs, tempAttrTbl = _riosTempRatTarget(
        applier, controls, outFile, segSize.size)
    colIndexList = createStatColumns(statsSelection, tempAttrTbl, [])
    (statsSelection_fast, numIntCols, numFloatCols) = (
        makeFastStatsSelection(colIndexList, statsSelection))

    inputs = applier.FilenameAssociations()
    inputs.segfile = segfile
    inputs.imgfile = imgfile
    outputs = applier.FilenameAssociations()  # no raster outputs

    otherArgs = applier.OtherInputs()
    otherArgs.acc = SegmentHistAccumulator(len(segSize), imgNullVal)
    otherArgs.pagedRat = createPagedRat()
    otherArgs.attrTbl = tempAttrTbl
    otherArgs.missingStatsValue = missingStatsValue
    otherArgs.statsSelection_fast = statsSelection_fast
    otherArgs.segSize = segSize
    otherArgs.numIntCols = numIntCols
    otherArgs.numFloatCols = numFloatCols

    applier.apply(_statsRIOSFunc, inputs, outputs, controls=controls,
                  otherArgs=otherArgs)

    if len(otherArgs.pagedRat) > 0:
        raise PyShepSegStatsError('Not all pixels found during processing')

    tempDs.FlushCache()
    del tempAttrTbl, tempDs
    if outFile is None:
        ratapplier.copyRAT(tempPath, segfile)


def _spatialStatsRIOSFunc(info, inputs, outputs, otherArgs):
    """RIOS block callback for the spatial variant
    (reference: tilingstats.py:1393-1411)."""
    (leftPix, topLine) = info.getPixColRow(0, 0)
    otherArgs.acc.accumulate(inputs.segfile[0], inputs.imgfile[0],
                             leftPix, topLine)
    _spatialFinalizeCompleted(
        otherArgs.acc, otherArgs.segSize, otherArgs.userFunc,
        otherArgs.userParam, otherArgs.missingStatsValue,
        otherArgs.pagedRat, otherArgs.userColFast, otherArgs.numIntCols,
        otherArgs.numFloatCols)
    _writeCompletePagesSpatial(otherArgs.pagedRat, otherArgs.attrTbl,
                               otherArgs.userColFast)


# public name matching the reference's callback (reference:
# tilingstats.py:1393 calcPerSegmentSpatialStats_riosFunc)
calcPerSegmentSpatialStats_riosFunc = _spatialStatsRIOSFunc


def calcPerSegmentSpatialStatsRIOS(imgfile, imgbandnum, segfile,
        colNamesAndTypes, userFunc, userParam=None, concurrencyStyle=None,
        missingStatsValue=-9999, outFile=None):
    """
    RIOS-driven variant of calcPerSegmentSpatialStatsTiled: RIOS reads
    the blocks, per-segment coordinate lists accumulate through the same
    streaming point accumulator, the user callback fills the requested
    columns of a temp RAT, and the columns are copied back into segfile
    (reference: tilingstats.py:1393-1584). Only read workers are
    supported (computeWorkerKind CW_NONE).

    RIOS drives the block reads itself, so the streaming-reduction
    contract (which needs the engine's halo reads) is not available
    here — built-in callbacks run through the point accumulator.
    """
    applier, ratapplier = _importRIOS()
    if isinstance(userFunc, StreamingSpatialUserFunc):
        raise PyShepSegStatsError(
            "StreamingSpatialUserFunc is not supported by the RIOS "
            "variant (RIOS owns the block reads; use "
            "calcPerSegmentSpatialStatsTiled)")

    segds, segband, imgds, imgband = doImageAlignmentChecks(
        segfile, imgfile, imgbandnum, update=False)
    imgNullVal = imgband.GetNoDataValue()
    if imgNullVal is None:
        raise PyShepSegStatsError("imgfile must have a nodata value set")
    imgNullVal = imageValueType(imgNullVal)
    attrTbl = segband.GetDefaultRAT()
    existingColNames = [attrTbl.GetNameOfCol(i)
                        for i in range(attrTbl.GetColumnCount())]
    histColNdx = checkHistColumn(existingColNames)
    segSize = attrTbl.ReadAsArray(histColNdx).astype(numpy.int64)
    del attrTbl, segband, segds, imgband, imgds

    controls = applier.ApplierControls()
    controls.selectInputImageLayers([imgbandnum], 'imgfile')
    controls.setWindowSize(tiling.TILESIZE, tiling.TILESIZE)
    _riosCheckConcurrency(applier, concurrencyStyle, controls)

    tempPath, tempDs, tempAttrTbl = _riosTempRatTarget(
        applier, controls, outFile, segSize.size)
    (numIntCols, numFloatCols, userColFast) = createUserColumnsSpatial(
        colNamesAndTypes, tempAttrTbl, [])

    inputs = applier.FilenameAssociations()
    inputs.segfile = segfile
    inputs.imgfile = imgfile
    outputs = applier.FilenameAssociations()

    otherArgs = applier.OtherInputs()
    otherArgs.acc = SegmentPointAccumulator(len(segSize), imgNullVal)
    otherArgs.pagedRat = createPagedRat()
    otherArgs.attrTbl = tempAttrTbl
    otherArgs.missingStatsValue = missingStatsValue
    otherArgs.userFunc = userFunc
    otherArgs.userParam = userParam
    otherArgs.userColFast = userColFast
    otherArgs.segSize = segSize
    otherArgs.numIntCols = numIntCols
    otherArgs.numFloatCols = numFloatCols

    applier.apply(_spatialStatsRIOSFunc, inputs, outputs,
                  controls=controls, otherArgs=otherArgs)

    if len(otherArgs.pagedRat) > 0:
        raise PyShepSegStatsError('Not all pixels found during processing')

    tempDs.FlushCache()
    del tempAttrTbl, tempDs
    if outFile is None:
        ratapplier.copyRAT(tempPath, segfile)
