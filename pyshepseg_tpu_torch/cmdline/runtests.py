"""
End-to-end synthetic test suite (counterpart:
pyshepseg_tpu/cmdline/runtests.py; reference:
pyshepseg/cmdline/runtests.py), on the device given by ``--device``.

Strategy, following the reference's oracle design:

1. Generate a known "true" segmentation — Voronoi cells of deterministic
   random centres — with a null margin to exercise null handling.
2. Synthesize a 3-band uint16 image giving each true segment a distinct,
   well-separated colour (nodata = 65535).
3. Run the real tiled pipeline (doTiledShepherdSegmentation).
4. Oracles:
   (a) per-pixel spectral check: per-segment mean RAT columns (via
       calcPerSegmentStatsTiled) must match the pixel colours within
       TOL=0.5 for (approximately) all pixels;
   (b) spatial check: per-segment mean coords from
       calcPerSegmentSpatialStatsTiled + userFuncMeanCoord vs directly
       computed means (TOL=3e-4);
   (c) subset round-trip: subsetImage of a window; new IDs start at 1 and
       origSegIdCol must reproduce the old raster exactly;
   (d) colour-table write exercises utils.

Exit status 1 on any failure.
"""

import os
import sys
import shutil
import argparse
import tempfile

import numpy
import torch

from pyshepseg_tpu_torch import _kernels, tiling, tilingstats, subset, utils
from pyshepseg_tpu_torch import io as rio
from pyshepseg_tpu_torch.ops.constants import SegIdType, SEGNULLVAL

NBANDS = 3
OUTNULL = 2 ** 16 - 1


def getCmdargs():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-d", "--directory", default=".",
        help="Directory in which to create test files (default='%(default)s')")
    p.add_argument("--size", type=int, default=1000,
        help="Image side length in pixels (default=%(default)s)")
    p.add_argument("--ncentres", type=int, default=101,
        help="Number of true Voronoi segments (default=%(default)s)")
    p.add_argument("--tilesize", type=int, default=512,
        help="Tile size for tiled segmentation (default=%(default)s)")
    p.add_argument("--overlapsize", type=int, default=128,
        help="Tile overlap (default=%(default)s)")
    p.add_argument("--keep", default=False, action="store_true",
        help="Keep test files")
    p.add_argument("--knownseg",
        help="Use existing true-segment file (skips generation)")
    p.add_argument("--driver", default=None,
        help="Raster format driver for all test files (e.g. KEA, GTiff). "
             "Default: the built-in numpy .npseg driver. Anything else "
             "requires GDAL (mirrors the reference runtests' KEA files, "
             "pyshepseg/cmdline/runtests.py)")
    p.add_argument("--device", default="cuda",
        help="Torch device of the scene generation, the segmentation and "
             "the stats passes: 'cuda' (raises when CUDA is absent), "
             "'cuda:N' or 'cpu' (default=%(default)s)")
    return p.parse_args()


# file extension per GDAL driver name (None = builtin numpy driver)
_DRIVER_EXT = {None: ".npseg", "NPSEG": ".npseg", "KEA": ".kea",
               "GTiff": ".tif", "HFA": ".img"}


def _voronoiOnDevice(centres, nRows, nCols, device, stripRows=256):
    """Nearest-centre labels 1..nCentres computed on ``device`` in row
    strips (bounded memory): float32 squared distances and an argmin
    whose ties go to the lowest centre index, as the JAX package's."""
    cy = torch.from_numpy(centres[:, 0].astype(numpy.float32)).to(device)
    cx = torch.from_numpy(centres[:, 1].astype(numpy.float32)).to(device)
    xg = torch.arange(nCols, dtype=torch.float32, device=device)
    dx2 = (xg[:, None] - cx[None, :]) ** 2        # (nCols, nCentres)

    out = numpy.empty((nRows, nCols), dtype=SegIdType)
    for r0 in range(0, nRows, stripRows):
        rows = min(stripRows, nRows - r0)
        yg = torch.arange(r0, r0 + rows, dtype=torch.float32, device=device)
        dy2 = (yg[:, None] - cy[None, :]) ** 2    # (rows, nCentres)
        d = dy2[:, None, :] + dx2[None, :, :]
        labels = torch.argmin(d, dim=-1).to(torch.int32) + 1
        out[r0:r0 + rows] = labels.cpu().numpy()
    return out


def generateTrueSegments(rng, nRows, nCols, nCentres, device):
    """Nearest-centre Voronoi labels 1..nCentres with a 10px null margin,
    vectorised over all centres in bounded row strips on ``device``."""
    centres = rng.uniform(0, [nRows, nCols], size=(nCentres, 2))
    seg = _voronoiOnDevice(centres, nRows, nCols, device)
    m = 10
    seg[:m, :] = SEGNULLVAL
    seg[-m:, :] = SEGNULLVAL
    seg[:, :m] = SEGNULLVAL
    seg[:, -m:] = SEGNULLVAL
    return seg


def createPalette(numSeg, rng):
    """
    Distinct, well-separated colours, one per true segment, spread along a
    3-D path in colour space (values in [0, 10000], uint16).
    """
    MAXVAL = 10000
    step = MAXVAL / max(numSeg - 1, 1)
    mid = numSeg / 2
    c = numpy.zeros((numSeg, NBANDS), dtype=numpy.uint16)
    for i in range(numSeg):
        c[i, 0] = round(i * step)
        c[i, 1] = round(MAXVAL - i * step)
        c[i, 2] = round(i * 2 * step) if i < mid else round(
            MAXVAL - (i - mid) * 2 * step)
    return c


def createMultispectral(trueseg, outfile, driver=None):
    """Synthesize the multi-band image from the true segments."""
    numSeg = int(trueseg.max())
    palette = createPalette(numSeg, numpy.random.default_rng(1))
    (nRows, nCols) = trueseg.shape
    nullNdx = (trueseg == SEGNULLVAL)

    ds = rio.create(outfile, nCols, nRows, NBANDS, numpy.uint16, driver)
    ds.SetGeoTransform((0, 1, 0, 0, 0, -1))
    for i in range(NBANDS):
        band = numpy.zeros(trueseg.shape, dtype=numpy.uint16)
        valid = ~nullNdx
        band[valid] = palette[trueseg[valid] - 1, i]
        band[nullNdx] = OUTNULL
        b = ds.GetRasterBand(i + 1)
        b.SetNoDataValue(OUTNULL)
        b.WriteArray(band)
    ds.FlushCache()


def checkSegmentation(imgfile, segfile, meanColNames):
    """Oracle (a): percentage of pixels whose segment-mean colour matches
    the pixel colour within TOL=0.5 (nulls must be null)."""
    segds = rio.open(segfile)
    seg = segds.GetRasterBand(1).ReadAsArray()
    nonNull = (seg != SEGNULLVAL)
    TOL = 0.5

    rat = segds.GetRasterBand(1).GetDefaultRAT()
    names = [rat.GetNameOfCol(i) for i in range(rat.GetColumnCount())]

    ds = rio.open(imgfile)
    colourMatch = None
    img = None
    bandobj = None
    for i in range(NBANDS):
        bandobj = ds.GetRasterBand(i + 1)
        img = bandobj.ReadAsArray()
        segmeans = rat.ReadAsArray(names.index(meanColNames[i]))
        segColour = segmeans[seg]
        diff = numpy.absolute(img - segColour)
        diff[~nonNull] = 0
        matchBand = (diff < TOL)
        colourMatch = matchBand if colourMatch is None else (
            colourMatch & matchBand)

    numColourMatch = numpy.count_nonzero(colourMatch | ~nonNull)
    imgnullval = bandobj.GetNoDataValue()
    nullMatch = (img[~nonNull] == imgnullval)
    ok = nullMatch.all()
    pcntMatch = 100 * numColourMatch / colourMatch.size
    return pcntMatch, ok


def checkSpatialColumns(segfile, eastingCol, northingCol):
    """Oracle (b): RAT mean coords vs directly computed (TOL=3e-4)."""
    segds = rio.open(segfile)
    seg = segds.GetRasterBand(1).ReadAsArray()
    rat = segds.GetRasterBand(1).GetDefaultRAT()
    names = [rat.GetNameOfCol(i) for i in range(rat.GetColumnCount())]
    eastingData = rat.ReadAsArray(names.index(eastingCol))
    northingData = rat.ReadAsArray(names.index(northingCol))
    TOL = 0.0003
    for segId in range(1, int(seg.max()) + 1):
        norths, easts = numpy.nonzero(seg == segId)
        if len(norths) == 0:
            continue
        if (abs(easts.mean() - eastingData[segId]) > TOL or
                abs(norths.mean() - northingData[segId]) > TOL):
            return False
    return True


def checkSubset(outsegfile, subset_segfile):
    """Oracle (c): subset IDs start at 1; orig-ID column reproduces the
    original raster exactly."""
    subds = rio.open(subset_segfile)
    subseg = subds.GetRasterBand(1).ReadAsArray()
    rat = subds.GetRasterBand(1).GetDefaultRAT()
    names = [rat.GetNameOfCol(i) for i in range(rat.GetColumnCount())]
    orig = rat.ReadAsArray(names.index("orig_segid"))

    used = numpy.unique(subseg[subseg > 0])
    if len(used) == 0 or used[0] != 1:
        return False
    if not numpy.array_equal(used, numpy.arange(1, len(used) + 1)):
        return False

    fullseg = rio.open(outsegfile).GetRasterBand(1).ReadAsArray()
    window = fullseg[:subseg.shape[0], :subseg.shape[1]]
    return numpy.array_equal(orig[subseg], window)


def mainCmd():
    cmdargs = getCmdargs()
    device = _kernels.torch_device(cmdargs.device)
    if cmdargs.directory is not None:
        os.makedirs(cmdargs.directory, exist_ok=True)
    tempDir = tempfile.mkdtemp(dir=cmdargs.directory,
                               prefix="pyshepseg_tpu_torch_test_")
    allOK = True
    try:
        rng = numpy.random.default_rng(42)
        n = cmdargs.size
        driver = cmdargs.driver
        ext = _DRIVER_EXT.get(driver, ".img")
        if driver is not None and driver != "NPSEG" and not rio.HAVE_GDAL:
            raise IOError(f"--driver {driver} requires GDAL")
        truesegfile = cmdargs.knownseg
        if truesegfile is None:
            print("Generating true segments ...")
            trueseg = generateTrueSegments(rng, n, n, cmdargs.ncentres,
                                           device)
            truesegfile = os.path.join(tempDir, "trueseg" + ext)
            ds = rio.create(truesegfile, n, n, 1, numpy.uint32, driver)
            ds.SetGeoTransform((0, 1, 0, 0, 0, -1))
            band = ds.GetRasterBand(1)
            band.SetNoDataValue(SEGNULLVAL)
            band.WriteArray(trueseg)
            ds.FlushCache()
        else:
            trueseg = rio.open(truesegfile).GetRasterBand(1).ReadAsArray()

        imgfile = os.path.join(tempDir, "multispec" + ext)
        print("Creating multispectral image ...")
        createMultispectral(trueseg, imgfile, driver)

        outsegfile = os.path.join(tempDir, "seg" + ext)
        print("Running tiled segmentation ...")
        res = tiling.doTiledShepherdSegmentation(
            imgfile, outsegfile, tileSize=cmdargs.tilesize,
            overlapSize=cmdargs.overlapsize,
            numClusters=cmdargs.ncentres, minSegmentSize=50,
            fourConnected=False, fixedKMeansInit=False, verbose=False,
            outputDriver=(driver or 'KEA'), device=device)
        print("Found {} segments (empty-segments={})".format(
            res.maxSegId, res.hasEmptySegments))
        if res.hasEmptySegments:
            allOK = False

        print("Calculating per-segment statistics ...")
        meanColNames = []
        for i in range(NBANDS):
            meanCol = "Band_{}_mean".format(i + 1)
            meanColNames.append(meanCol)
            tilingstats.calcPerSegmentStatsTiled(
                imgfile, i + 1, outsegfile,
                [(meanCol, "mean"),
                 ("Band_{}_stddev".format(i + 1), "stddev")],
                device=device)

        pcntMatch, nullsOK = checkSegmentation(imgfile, outsegfile,
                                               meanColNames)
        print("Spectral match: {:.4f}% (nulls ok: {})".format(pcntMatch,
                                                              nullsOK))
        # Allow a whisker below 100% for single-pixel sliver absorption
        # (the reference's eliminateSinglePixels merges 1-pixel clumps with
        # no spectral threshold; see shepseg.py:572-615)
        if pcntMatch < 99.99 or not nullsOK:
            allOK = False

        print("Calculating spatial statistics ...")
        transform = numpy.array([0, 1, 0, 0, 0, 1], dtype=numpy.float64)
        tilingstats.calcPerSegmentSpatialStatsTiled(
            imgfile, 1, outsegfile,
            [("Band_1_easting", rio.GFT_Real),
             ("Band_1_northing", rio.GFT_Real)],
            tilingstats.userFuncMeanCoord, transform, device=device)
        spatialOK = checkSpatialColumns(outsegfile, "Band_1_easting",
                                        "Band_1_northing")
        print("Spatial stats ok:", spatialOK)
        if not spatialOK:
            allOK = False

        # Neighbourhood built-ins: the streaming halo routes (which the
        # default engine takes on every device) must agree with the
        # point-list accumulator route on the same segmentation
        print("Checking streaming spatial routes ...")
        tilingstats.calcPerSegmentSpatialStatsTiled(
            imgfile, 1, outsegfile, [("edgepix_s", rio.GFT_Integer)],
            tilingstats.userFuncNumEdgePixels, True, device=device)
        tilingstats.calcPerSegmentSpatialStatsTiled(
            imgfile, 1, outsegfile, [("vario1_s", rio.GFT_Real),
                                     ("vario2_s", rio.GFT_Real)],
            tilingstats.userFuncVariogram, 2, device=device)

        def pointEdge(pts, imgNullVal, intArr, floatArr, param):
            return tilingstats.userFuncNumEdgePixels(
                pts, imgNullVal, intArr, floatArr, param)

        def pointVario(pts, imgNullVal, intArr, floatArr, param):
            return tilingstats.userFuncVariogram(
                pts, imgNullVal, intArr, floatArr, param)

        tilingstats.calcPerSegmentSpatialStatsTiled(
            imgfile, 1, outsegfile, [("edgepix_p", rio.GFT_Integer)],
            pointEdge, True, device=device)
        tilingstats.calcPerSegmentSpatialStatsTiled(
            imgfile, 1, outsegfile, [("vario1_p", rio.GFT_Real),
                                     ("vario2_p", rio.GFT_Real)],
            pointVario, 2, device=device)
        rat = rio.open(outsegfile).GetRasterBand(1).GetDefaultRAT()
        names = [rat.GetNameOfCol(i) for i in range(rat.GetColumnCount())]

        def col(name):
            return rat.ReadAsArray(names.index(name))

        streamOK = bool(numpy.array_equal(col("edgepix_s"),
                                          col("edgepix_p")))
        for c in ("vario1", "vario2"):
            a, b = col(c + "_s"), col(c + "_p")
            streamOK = streamOK and bool(
                numpy.array_equal(a == -9999, b == -9999) and
                numpy.allclose(a, b, rtol=1e-9))
        print("Streaming spatial routes ok:", streamOK)
        if not streamOK:
            allOK = False

        print("Testing subset ...")
        subsegfile = os.path.join(tempDir, "subset" + ext)
        subSize = max(n // 4, 64)
        subset.subsetImage(outsegfile, subsegfile, 0, 0, subSize, subSize,
                           driver, origSegIdColName="orig_segid")
        subsetOK = checkSubset(outsegfile, subsegfile)
        print("Subset ok:", subsetOK)
        if not subsetOK:
            allOK = False

        print("Writing colour table ...")
        utils.writeColorTableFromRatColumns(outsegfile, meanColNames[0],
                                            meanColNames[1],
                                            meanColNames[2])
    finally:
        if not cmdargs.keep:
            shutil.rmtree(tempDir, ignore_errors=True)
        else:
            print("Test files kept in", tempDir)

    if allOK:
        print("All tests passed")
        sys.exit(0)
    else:
        print("SOME TESTS FAILED")
        sys.exit(1)


if __name__ == "__main__":
    mainCmd()
