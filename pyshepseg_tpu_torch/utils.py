"""
Utility functions: histogram-derived band statistics, overviews, colour
tables, deprecation warnings, worker error records and timing reports
(counterpart: pyshepseg_tpu/utils.py; reference: pyshepseg/utils.py). All
raster/RAT access goes through the JAX-free driver abstraction in
:mod:`.io`, so these work with both GDAL datasets and
numpy-driver datasets. Host numpy only.
"""

import sys
import inspect
import traceback

import numpy

from . import io as rio
from . import shepseg

DEFAULT_MINOVERVIEWDIM = 100
DEFAULT_OVERVIEWLEVELS = [4, 8, 16, 32, 64, 128, 256, 512]


# GDAL float band types (public, reference: utils.py:44)
gdalFloatTypes = {rio.GDT_Float32, rio.GDT_Float64}
_floatTypes = gdalFloatTypes


def estimateStatsFromHisto(bandObj, hist):
    """
    Derive STATISTICS_* band metadata from an existing histogram instead of
    re-scanning the raster (reference: utils.py:47-95). ``hist[i]`` is the
    pixel count of value i.
    """
    hist = numpy.asarray(hist)
    mask = hist > 0
    nVals = hist.sum()
    minVal = mask.argmax()
    maxVal = hist.shape[0] - numpy.flip(mask).argmax() - 1

    values = numpy.arange(hist.shape[0])
    meanVal = (values * hist).sum() / nVals
    stdDevVal = numpy.sqrt(
        (hist * numpy.power(values - meanVal, 2)).sum() / nVals)
    modeVal = numpy.argmax(hist)
    middlenum = hist.sum() / 2
    medianVal = (hist.cumsum() >= middlenum).nonzero()[0][0]

    if bandObj.DataType in _floatTypes:
        minVal, maxVal = float(minVal), float(maxVal)
        modeVal, medianVal = float(modeVal), float(medianVal)
    else:
        minVal, maxVal = int(minVal), int(maxVal)
        modeVal, medianVal = int(modeVal), int(medianVal)

    bandObj.SetMetadataItem("STATISTICS_MINIMUM", repr(minVal))
    bandObj.SetMetadataItem("STATISTICS_MAXIMUM", repr(maxVal))
    bandObj.SetMetadataItem("STATISTICS_MEAN", repr(float(meanVal)))
    bandObj.SetMetadataItem("STATISTICS_STDDEV", repr(float(stdDevVal)))
    bandObj.SetMetadataItem("STATISTICS_MODE", repr(modeVal))
    bandObj.SetMetadataItem("STATISTICS_MEDIAN", repr(medianVal))
    bandObj.SetMetadataItem("STATISTICS_SKIPFACTORX", "1")
    bandObj.SetMetadataItem("STATISTICS_SKIPFACTORY", "1")
    bandObj.SetMetadataItem("STATISTICS_HISTOBINFUNCTION", "direct")


def addOverviews(ds):
    """
    Add nearest-neighbour raster overviews, choosing levels the way RIOS
    does (reference: utils.py:98-120).
    """
    mindim = min(ds.RasterXSize, ds.RasterYSize)
    nOverviews = 0
    for lvl in DEFAULT_OVERVIEWLEVELS:
        if (mindim // lvl) > DEFAULT_MINOVERVIEWDIM:
            nOverviews += 1
    ds.BuildOverviews("NEAREST", DEFAULT_OVERVIEWLEVELS[:nOverviews])


def writeRandomColourTable(outBand, nRows):
    """
    Attach a random RGB(+alpha) colour table to a segmentation band so
    segment boundaries are viewable (reference: utils.py:123-159). The
    null row (segment 0) is fully transparent.
    """
    nRows = int(nRows)
    colNames = ["Blue", "Green", "Red"]
    colUsages = [rio.GFU_Blue, rio.GFU_Green, rio.GFU_Red]

    attrTbl = outBand.GetDefaultRAT()
    attrTbl.SetRowCount(nRows)

    rng = numpy.random.default_rng()
    for band in range(3):
        colNum = attrTbl.GetColOfUsage(colUsages[band])
        if colNum == -1:
            attrTbl.CreateColumn(colNames[band], rio.GFT_Integer,
                                 colUsages[band])
            colNum = attrTbl.GetColumnCount() - 1
        colour = rng.integers(0, 256, size=nRows)
        attrTbl.WriteArray(colour, colNum)

    alpha = numpy.full((nRows,), 255, dtype=numpy.uint8)
    alpha[shepseg.SEGNULLVAL] = 0
    colNum = attrTbl.GetColOfUsage(rio.GFU_Alpha)
    if colNum == -1:
        attrTbl.CreateColumn('Alpha', rio.GFT_Integer, rio.GFU_Alpha)
        colNum = attrTbl.GetColumnCount() - 1
    attrTbl.WriteArray(alpha, colNum)


def writeColorTableFromRatColumns(segfile, redColName, greenColName,
        blueColName):
    """
    Build Red/Green/Blue colour columns from three existing RAT columns
    (typically per-segment band means), stretched to the 5th-95th
    percentile (reference: utils.py:162-230).
    """
    colList = [redColName, greenColName, blueColName]
    colorColList = ['Red', 'Green', 'Blue']
    usageList = [rio.GFU_Red, rio.GFU_Green, rio.GFU_Blue]

    ds = rio.open(segfile, rio.GA_Update)
    band = ds.GetRasterBand(1)
    attrTbl = band.GetDefaultRAT()
    colNameList = [attrTbl.GetNameOfCol(i)
                   for i in range(attrTbl.GetColumnCount())]

    colVals = None
    for i in range(3):
        n = colNameList.index(colList[i])
        colVals = attrTbl.ReadAsArray(n)

        if colorColList[i] not in colNameList:
            attrTbl.CreateColumn(colorColList[i], rio.GFT_Integer,
                                 usageList[i])
            clrColNdx = attrTbl.GetColumnCount() - 1
        else:
            clrColNdx = colNameList.index(colorColList[i])

        colMin = numpy.percentile(colVals, 5)
        colMax = numpy.percentile(colVals, 95)
        denom = max(colMax - colMin, 1e-30)
        clr = (255 * ((colVals - colMin) / denom).clip(0, 1))
        attrTbl.WriteArray(clr.astype(numpy.uint8), clrColNdx)

    alpha = numpy.full(len(colVals), 255, dtype=numpy.uint8)
    if 'Alpha' not in colNameList:
        attrTbl.CreateColumn('Alpha', rio.GFT_Integer, rio.GFU_Alpha)
        i = attrTbl.GetColumnCount() - 1
    else:
        i = colNameList.index('Alpha')
    attrTbl.WriteArray(alpha, i)


deprecationAlreadyWarned = set()


def deprecationWarning(msg, stacklevel=2):
    """
    Consistent deprecation warning to stderr with the caller's file/line,
    deduplicated per call site (reference: utils.py:236-264).
    """
    frame = inspect.currentframe()
    for _ in range(stacklevel):
        if frame is not None:
            frame = frame.f_back

    if frame is None:
        filename, lineno = "sys", 1
    else:
        filename, lineno = frame.f_code.co_filename, frame.f_lineno

    key = (filename, lineno)
    if key not in deprecationAlreadyWarned:
        print("{} (line {}):\n    WARNING: {}".format(filename, lineno, msg),
              file=sys.stderr)
        deprecationAlreadyWarned.add(key)


class WorkerErrorRecord:
    """
    Record of an exception raised in a remote/thread worker, carrying the
    formatted traceback across pickling boundaries
    (reference: utils.py:267-288).
    """

    def __init__(self, exc, workerType):
        self.exc = exc
        self.workerType = workerType
        self.formattedTraceback = traceback.format_exception(exc)

    def __str__(self):
        lines = ["Error in {} worker".format(self.workerType)]
        lines.extend(line.strip('\n') for line in self.formattedTraceback)
        return '\n'.join(lines) + '\n'


def reportWorkerException(exceptionRecord):
    """Report the given WorkerErrorRecord to stderr."""
    print(exceptionRecord, file=sys.stderr)


def formatTimingRpt(summaryDict):
    """
    Fixed-width report of phase timings from Timers.makeSummaryDict()
    (reference: utils.py:291-340 — same layout, same phase ordering for
    the segmentation and stats timer sets).
    """
    isSeg = ('spectralclusters' in summaryDict)
    isStats = ('statscompletion' in summaryDict)
    if isSeg:
        hdr = "Segmentation Timings (sec)"
        timerList = ['spectralclusters', 'startworkers', 'reading',
                     'segmentation', 'stitchtiles', 'stitchwait',
                     'stitchfinalize']
    elif isStats:
        hdr = "Per-segment Stats Timings (sec)"
        timerList = ['reading', 'compaction', 'accumulation',
                     'statscompletion', 'writing']
    else:
        hdr = "Timers (unknown set) (sec)"
        timerList = sorted(summaryDict.keys())
    timerList = [t for t in timerList if t in summaryDict]

    lines = [hdr]
    walltimeDict = summaryDict.get('walltime')
    if walltimeDict is not None:
        lines.append(f"Walltime: {walltimeDict['total']:.2f}")
    lines.append("")

    if not timerList:
        return '\n'.join(lines)

    fldWidth1 = max(len(t) for t in timerList)
    maxTime = max(summaryDict[t]['total'] for t in timerList)
    logMaxTime = numpy.log10(max(maxTime, 1e-9))
    if int(logMaxTime) == logMaxTime:
        logMaxTime += 0.1
    fldWidth2 = 3 + max(int(numpy.ceil(logMaxTime)), 1)
    colHdrFmt = "{:" + str(fldWidth1) + "s}   {:>" + str(fldWidth2) + "s}"
    lines.append(colHdrFmt.format("Timer", "Total"))
    lines.append((3 + fldWidth1 + fldWidth2) * '-')
    colFmt = "{:" + str(fldWidth1) + "s}   {:" + str(fldWidth2) + ".2f}"
    for t in timerList:
        lines.append(colFmt.format(t, summaryDict[t]['total']))

    return '\n'.join(lines)
