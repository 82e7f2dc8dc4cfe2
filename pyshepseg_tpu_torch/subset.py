"""
Subset a segmentation raster and "compress" its RAT so only segments
present in the subset remain (counterpart: pyshepseg_tpu/subset.py;
reference: pyshepseg/subset.py). Segment IDs are recoded to dense 1..N in
first-encounter (row-major scan) order; surviving RAT rows are copied
across page-by-page; a fresh histogram is written; optionally a back-link
column records each new segment's original ID.

Host numpy and the g++ loop ``native.subset_recode`` over the port's own
``io``, with no device work: the recode is strictly sequential. Where the
native library cannot be built, a vectorized first-encounter unique within
each tile, merged with a running recode table, reproduces the scan-order
ID assignment exactly.
"""

import numpy

from . import tiling
from . import tilingstats
from . import native
from . import io as rio
from .ops.constants import SegIdType, SEGNULLVAL


class PyShepSegSubsetError(Exception):
    pass


def subsetImage(inname, outname, tlx, tly, newXsize, newYsize, outformat,
        creationOptions=[], origSegIdColName=None, maskImage=None):
    """
    Subset the window (tlx, tly, newXsize, newYsize) of a segmentation
    raster into outname, recoding segment IDs to dense 1..N in
    first-encounter order and compacting the RAT to surviving segments
    (reference: subset.py:40-215 — same parameters and semantics).

    If maskImage is given, only pixels non-zero in that mask (which must
    match the subset's shape) are kept.
    """
    inds = rio.open(inname, rio.GA_Update)
    inband = inds.GetRasterBand(1)

    if (tlx + newXsize) > inband.XSize or (tly + newYsize) > inband.YSize:
        raise PyShepSegSubsetError('Requested subset is not within input '
                                   'image')

    outds = rio.create(outname, newXsize, newYsize, 1, SegIdType,
                       outformat, creationOptions)
    proj = inds.GetProjection()
    if proj:
        outds.SetProjection(proj)
    transform = inds.GetGeoTransform()
    if transform is not None:
        transform = list(transform)
        transform[0] = transform[0] + transform[1] * tlx
        transform[3] = transform[3] + transform[5] * tly
        outds.SetGeoTransform(tuple(transform))

    outband = outds.GetRasterBand(1)
    outband.SetMetadataItem('LAYER_TYPE', 'thematic')
    outRAT = outband.GetDefaultRAT()
    inRAT = inband.GetDefaultRAT()

    recodeDict = {}     # original ID -> new dense ID
    histogramDict = {}  # new ID -> pixel count in subset

    # The recode is strictly sequential (a segment's new ID depends on
    # which of its pixels is hit first in global scan order), so the hot
    # path is the native C++ loop with a dense LUT; the vectorized
    # per-tile dict merge below is the compiler-less fallback.
    useNative = native.available() and inRAT.GetRowCount() > 0
    if useNative:
        maxOldId = inRAT.GetRowCount() - 1
        recodeLut = numpy.zeros(maxOldId + 2, dtype=numpy.uint32)
        histArr = numpy.zeros(maxOldId + 2, dtype=numpy.uint64)
        nextNativeId = 1
        maxValidId = maxOldId  # IDs beyond the RAT rows are stale data

    numIntCols, numFloatCols = copyColumns(inRAT, outRAT)

    maskBand = None
    if maskImage is not None:
        maskds = rio.open(maskImage)
        maskBand = maskds.GetRasterBand(1)
        if maskBand.XSize != newXsize or maskBand.YSize != newYsize:
            raise PyShepSegSubsetError(
                'mask should match requested subset size if supplied')

    tileSize = tiling.TILESIZE
    minInVal = None
    maxInVal = None

    for tileRowStart in range(0, newYsize, tileSize):
        for tileColStart in range(0, newXsize, tileSize):
            leftPix = tlx + tileColStart
            topLine = tly + tileRowStart
            xsize = min(tileSize, newXsize - tileColStart)
            ysize = min(tileSize, newYsize - tileRowStart)

            inData = inband.ReadAsArray(leftPix, topLine, xsize, ysize)

            inDataMasked = inData[inData != SEGNULLVAL]
            if len(inDataMasked) == 0:
                continue
            minVal = inDataMasked.min()
            maxVal = inDataMasked.max()
            minInVal = minVal if minInVal is None else min(minInVal, minVal)
            maxInVal = maxVal if maxInVal is None else max(maxInVal, maxVal)

            maskData = None
            if maskBand is not None:
                maskData = maskBand.ReadAsArray(tileColStart, tileRowStart,
                                                xsize, ysize)

            if useNative and maxVal <= maxValidId:
                outData, nextNativeId = native.subset_recode(
                    inData, maskData, recodeLut, nextNativeId, histArr)
            elif useNative:
                # Tile holds an ID beyond the RAT row count (stale or
                # truncated RAT) — the dense LUT can't hold it
                raise PyShepSegSubsetError(
                    'Segment ID {} exceeds the input RAT row count {}'
                    .format(int(maxVal), len(recodeLut) - 1))
            else:
                outData = processSubsetTile(inData, recodeDict,
                                            histogramDict, maskData)
            outband.WriteArray(outData, tileColStart, tileRowStart)

    if minInVal is None or maxInVal is None:
        raise PyShepSegSubsetError('No valid data found in subset')

    if useNative:
        # Synthesize the dict views the RAT-copy stage consumes; the
        # first-encounter ordering is already baked into the LUT values.
        origArr = numpy.nonzero(recodeLut)[0]
        recodeDict = {int(o): int(recodeLut[o]) for o in origArr}
        histogramDict = {int(recodeLut[o]): int(histArr[recodeLut[o]])
                         for o in origArr}

    # Copy surviving RAT rows across, one input page at a time
    outPagedRat = tilingstats.createPagedRat()
    origIds = numpy.fromiter(recodeDict.keys(), dtype=numpy.int64,
                             count=len(recodeDict))
    newIds = numpy.fromiter(recodeDict.values(), dtype=numpy.int64,
                            count=len(recodeDict))
    for startSegId in range(int(minInVal), int(maxInVal) + 1,
                            tilingstats.RAT_PAGE_SIZE):
        endSegId = min(startSegId + tilingstats.RAT_PAGE_SIZE - 1,
                       int(maxInVal))
        inPage = readRATIntoPage(inRAT, numIntCols, numFloatCols,
                                 startSegId, endSegId)
        copySubsettedSegmentsToNew(inPage, outPagedRat, recodeDict,
                                   origIds, newIds)
        writeCompletedPagesForSubset(inRAT, outRAT, outPagedRat)

    # Histogram of the subset
    histArray = numpy.zeros(outRAT.GetRowCount(), dtype=numpy.float64)
    setHistogramFromDictionary(histogramDict, histArray)
    colNum = outRAT.GetColOfUsage(rio.GFU_PixelCount)
    if colNum == -1:
        outRAT.CreateColumn('Histogram', rio.GFT_Real, rio.GFU_PixelCount)
        colNum = outRAT.GetColumnCount() - 1
    outRAT.WriteArray(histArray, colNum)

    # Optional back-link column of original segment IDs
    if origSegIdColName is not None:
        colNum = -1
        for n in range(outRAT.GetColumnCount()):
            if outRAT.GetNameOfCol(n) == origSegIdColName:
                colNum = n
                break
        if colNum == -1:
            outRAT.CreateColumn(origSegIdColName, rio.GFT_Integer,
                                rio.GFU_Generic)
            colNum = outRAT.GetColumnCount() - 1
        origSegIdArray = numpy.zeros(outRAT.GetRowCount(),
                                     dtype=numpy.int32)
        setSubsetRecodeFromDictionary(recodeDict, origSegIdArray)
        outRAT.WriteArray(origSegIdArray, colNum)

    outds.FlushCache()


def processSubsetTile(tile, recodeDict, histogramDict, maskData):
    """
    Recode one tile, assigning dense new IDs in first-encounter scan order
    and updating recodeDict / histogramDict in place
    (reference: subset.py:367-424, vectorized).
    """
    outData = numpy.zeros_like(tile)

    valid = tile != SEGNULLVAL
    if maskData is not None:
        valid &= (maskData != 0)
    vals = tile[valid]  # boolean indexing preserves row-major scan order
    if len(vals) == 0:
        return outData

    uniq, firstIdx = numpy.unique(vals, return_index=True)
    isNew = numpy.array([u not in recodeDict for u in uniq.tolist()])
    # new IDs in order of first encounter within this tile
    newUniq = uniq[isNew]
    order = numpy.argsort(firstIdx[isNew], kind='stable')
    nextId = len(recodeDict) + 1
    for u in newUniq[order].tolist():
        recodeDict[u] = nextId
        nextId += 1

    lut = numpy.fromiter((recodeDict[u] for u in uniq.tolist()),
                         dtype=numpy.int64, count=len(uniq))
    idx = numpy.searchsorted(uniq, vals)
    newVals = lut[idx]
    outData[valid] = newVals.astype(SegIdType)

    counts = numpy.bincount(idx)
    for i in range(len(uniq)):
        newId = int(lut[i])
        histogramDict[newId] = histogramDict.get(newId, 0) + int(counts[i])

    return outData


def copySubsettedSegmentsToNew(inPage, outPagedRat, recodeDict,
                               origIds, newIds):
    """
    Copy rows of an input RAT page whose segments survive the subset into
    the output paged RAT at their new row numbers
    (reference: subset.py:218-268, vectorized per page).
    """
    numIntCols = inPage.intcols.shape[0]
    numFloatCols = inPage.floatcols.shape[0]
    numRows = max(inPage.intcols.shape[1], inPage.floatcols.shape[1])
    maxSegId = len(recodeDict)

    inPageEnd = inPage.startSegId + numRows
    sel = (origIds >= inPage.startSegId) & (origIds < inPageEnd)
    pageOrig = origIds[sel]
    pageNew = newIds[sel]
    inRowsInPage = (pageOrig - inPage.startSegId).astype(numpy.int64)

    for outRow, inRowInPage in zip(pageNew.tolist(),
                                   inRowsInPage.tolist()):
        outPageId = tilingstats.getRatPageId(outRow)
        outRowInPage = outRow - outPageId
        if outPageId not in outPagedRat:
            numSegThisPage = min(tilingstats.RAT_PAGE_SIZE,
                                 (maxSegId - outPageId + 1))
            outPagedRat[outPageId] = tilingstats.RatPage(
                numIntCols, numFloatCols, outPageId, numSegThisPage)
            if outPageId == SEGNULLVAL:
                outPagedRat[outPageId].setSegmentComplete(SEGNULLVAL)
        outPage = outPagedRat[outPageId]
        for n in range(numIntCols):
            outPage.intcols[n, outRowInPage] = inPage.intcols[n,
                                                              inRowInPage]
        for n in range(numFloatCols):
            outPage.floatcols[n, outRowInPage] = (
                inPage.floatcols[n, inRowInPage])
        outPage.complete[outRowInPage] = True


def setHistogramFromDictionary(dictn, histArray):
    """
    Write dictionary pixel counts (keyed on segment ID) into the array;
    the null row is zeroed (reference: subset.py:271-279). Vectorized
    over the dictionary items.
    """
    n = len(dictn)
    idx = numpy.fromiter(dictn.keys(), dtype=numpy.int64, count=n)
    vals = numpy.fromiter(dictn.values(), dtype=numpy.int64, count=n)
    histArray[idx] = vals
    histArray[SEGNULLVAL] = 0


def setSubsetRecodeFromDictionary(dictn, array):
    """
    Given the recodeDict (old ID -> new ID), write each original ID at
    its new index; the null row is zeroed (reference: subset.py:282-290).
    """
    n = len(dictn)
    old = numpy.fromiter(dictn.keys(), dtype=numpy.int64, count=n)
    new = numpy.fromiter(dictn.values(), dtype=numpy.int64, count=n)
    array[new] = old
    array[SEGNULLVAL] = 0


def readColDataIntoPage(page, data, idx, colType, minVal):
    """
    Bulk-write one RAT column slice starting at segment ID ``minVal``
    into a RatPage column, offset by the page's startSegId — the
    reference writes row ``i + minVal`` per element (subset.py:293-300).
    """
    start = int(minVal) - int(page.startSegId)
    if colType == tilingstats.STAT_DTYPE_INT:
        page.intcols[idx, start:start + len(data)] = data
    else:
        page.floatcols[idx, start:start + len(data)] = data


def readRATIntoPage(rat, numIntCols, numFloatCols, minVal, maxVal):
    """
    Read the RAT rows [minVal, maxVal] into a RatPage with startSegId =
    minVal (reference: subset.py:293-329).
    """
    minVal = int(minVal)
    nrows = int(maxVal - minVal) + 1
    page = tilingstats.RatPage(numIntCols, numFloatCols, minVal, nrows)

    intColIdx = 0
    floatColIdx = 0
    for col in range(rat.GetColumnCount()):
        dtype = rat.GetTypeOfCol(col)
        data = rat.ReadAsArray(col, start=minVal, length=nrows)
        if dtype == rio.GFT_Integer:
            readColDataIntoPage(page, data, intColIdx,
                                tilingstats.STAT_DTYPE_INT, minVal)
            intColIdx += 1
        else:
            readColDataIntoPage(page, data, floatColIdx,
                                tilingstats.STAT_DTYPE_FLOAT, minVal)
            floatColIdx += 1
    return page


def copyColumns(inRat, outRat):
    """
    Clone the RAT column schema (names/types/usages, no data). String
    columns are not supported (reference: subset.py:332-364).
    Returns (numIntCols, numFloatCols).
    """
    numIntCols = 0
    numFloatCols = 0
    for col in range(inRat.GetColumnCount()):
        dtype = inRat.GetTypeOfCol(col)
        usage = inRat.GetUsageOfCol(col)
        name = inRat.GetNameOfCol(col)
        outRat.CreateColumn(name, dtype, usage)
        if dtype == rio.GFT_Integer:
            numIntCols += 1
        elif dtype == rio.GFT_Real:
            numFloatCols += 1
        else:
            raise TypeError("String columns not supported")
    return numIntCols, numFloatCols


def writeCompletedPagesForSubset(inRAT, outRAT, outPagedRat):
    """
    Flush complete output pages, using the input RAT's column order/types
    to route int/float blocks (reference: subset.py:427-471).
    """
    for pageId in list(outPagedRat.keys()):
        ratPage = outPagedRat[pageId]
        if not ratPage.pageComplete():
            continue
        maxRow = ratPage.startSegId + max(ratPage.intcols.shape[1],
                                          ratPage.floatcols.shape[1])
        if outRAT.GetRowCount() < maxRow:
            outRAT.SetRowCount(maxRow)

        intColIdx = 0
        floatColIdx = 0
        for col in range(inRAT.GetColumnCount()):
            dtype = inRAT.GetTypeOfCol(col)
            if dtype == rio.GFT_Integer:
                data = ratPage.intcols[intColIdx]
                intColIdx += 1
            else:
                data = ratPage.floatcols[floatColIdx]
                floatColIdx += 1
            outRAT.WriteArray(data, col, start=int(ratPage.startSegId))
        outPagedRat.pop(pageId)
