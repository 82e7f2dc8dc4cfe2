"""
Command-line tool: subset a segmentation raster by pixel window, projected
window, or mask extent (counterpart: pyshepseg_tpu/cmdline/subset.py;
reference: pyshepseg/cmdline/subset.py), with grid-alignment checks for
the mask case. It runs on the host only, so it takes no ``--device``.
"""

import math
import argparse

from pyshepseg_tpu_torch import subset, tilingstats
from pyshepseg_tpu_torch import io as rio

DFLT_OUTPUT_DRIVER = 'KEA'
GDAL_DRIVER_CREATION_OPTIONS = {'KEA': [], 'HFA': ['COMPRESS=YES']}


def getCmdargs():
    p = argparse.ArgumentParser()
    p.add_argument("-i", "--infile", required=True, help="Input file")
    p.add_argument("-o", "--outfile", required=True, help="Output file")
    group = p.add_mutually_exclusive_group(required=True)
    group.add_argument("--srcwin", type=int, nargs=4,
        metavar=('xoff', 'yoff', 'xsize', 'ysize'),
        help="Top left pixel coordinates and subset size (in pixels)")
    group.add_argument("--projwin", type=float, nargs=4,
        metavar=('ulx', 'uly', 'lrx', 'lry'),
        help="Projected coordinates of the subset window")
    group.add_argument("--mask",
        help="Use extent of specified raster as subset area; only pixels "
             "that are != 0 in this image are kept")
    p.add_argument("--origsegidcol",
        help="Name of column to write the original segment ids")
    p.add_argument("-f", "--format", default=DFLT_OUTPUT_DRIVER,
        help="Name of output format that supports RATs "
             "(default=%(default)s)")
    return p.parse_args()


def _applyTransform(t, x, y):
    return (t[0] + t[1] * x + t[2] * y, t[3] + t[4] * x + t[5] * y)


def _invTransform(t):
    det = t[1] * t[5] - t[2] * t[4]
    if det == 0:
        raise ValueError("Non-invertible geotransform")
    inv1 = t[5] / det
    inv2 = -t[2] / det
    inv4 = -t[4] / det
    inv5 = t[1] / det
    inv0 = -(inv1 * t[0] + inv2 * t[3])
    inv3 = -(inv4 * t[0] + inv5 * t[3])
    return (inv0, inv1, inv2, inv3, inv4, inv5)


def getPixelCoords(fname, coords):
    """(ulx, uly, lrx, lry) projected -> (tlx, tly, xsize, ysize) pixels."""
    ulx, uly, lrx, lry = coords
    ds = rio.open(fname)
    inv = _invTransform(ds.GetGeoTransform())
    pix_tlx, pix_tly = _applyTransform(inv, ulx, uly)
    pix_brx, pix_bry = _applyTransform(inv, lrx, lry)
    pix_tlx, pix_tly = int(pix_tlx), int(pix_tly)
    pix_brx, pix_bry = int(math.ceil(pix_brx)), int(math.ceil(pix_bry))

    if (pix_tlx < 0 or pix_tly < 0 or pix_brx >= ds.RasterXSize or
            pix_bry >= ds.RasterYSize):
        raise ValueError('Specified coordinates not completely within image')
    return pix_tlx, pix_tly, pix_brx - pix_tlx, pix_bry - pix_tly


def getExtentOfMaskForInfile(infile, maskfile):
    """Mask raster extent in infile pixel coords, with grid checks."""
    inds = rio.open(infile)
    in_transform = inds.GetGeoTransform()
    maskds = rio.open(maskfile)
    mask_transform = maskds.GetGeoTransform()

    if not tilingstats.equalProjection(inds.GetProjection(),
                                       maskds.GetProjection()):
        raise ValueError("Mask and infile don't have same projection")
    if (in_transform[1] != mask_transform[1] or
            in_transform[5] != mask_transform[5]):
        raise ValueError("Mask and infile don't have same pixel size")
    if ((in_transform[0] - mask_transform[0]) % in_transform[1]) != 0:
        raise ValueError("Mask and infile not on same grid")
    if ((in_transform[3] - mask_transform[3]) % in_transform[5]) != 0:
        raise ValueError("Mask and infile not on same grid")

    mask_tlx, mask_tly = _applyTransform(mask_transform, 0, 0)
    mask_brx, mask_bry = _applyTransform(
        mask_transform, maskds.RasterXSize, maskds.RasterYSize)
    inv = _invTransform(in_transform)
    tlx, tly = _applyTransform(inv, mask_tlx, mask_tly)
    brx, bry = _applyTransform(inv, mask_brx, mask_bry)
    return int(tlx), int(tly), int(brx) - int(tlx), int(bry) - int(tly)


def mainCmd():
    cmdargs = getCmdargs()

    if cmdargs.srcwin is not None:
        tlx, tly, xsize, ysize = cmdargs.srcwin
    elif cmdargs.projwin is not None:
        tlx, tly, xsize, ysize = getPixelCoords(cmdargs.infile,
                                                cmdargs.projwin)
    else:
        tlx, tly, xsize, ysize = getExtentOfMaskForInfile(cmdargs.infile,
                                                          cmdargs.mask)

    creationOptions = GDAL_DRIVER_CREATION_OPTIONS.get(cmdargs.format, [])
    subset.subsetImage(cmdargs.infile, cmdargs.outfile, tlx, tly,
                       xsize, ysize, cmdargs.format,
                       creationOptions=creationOptions,
                       origSegIdColName=cmdargs.origsegidcol,
                       maskImage=cmdargs.mask)


if __name__ == "__main__":
    mainCmd()
