"""
Command-line tool: in-memory segmentation of selected bands of a raster
(counterpart: pyshepseg_tpu/cmdline/run_seg.py; reference:
pyshepseg/cmdline/run_seg.py), on the device given by ``--device``. Writes
the segment raster with histogram-derived statistics, overviews, a random
colour table, and the k-means cluster centres as JSON band metadata.
"""

import os
import sys
import json
import time
import argparse

import numpy
import torch

from pyshepseg_tpu_torch import io as rio
from pyshepseg_tpu_torch import shepseg
from pyshepseg_tpu_torch import utils

DFLT_OUTPUT_DRIVER = 'KEA'
GDAL_DRIVER_CREATION_OPTIONS = {'KEA': [], 'HFA': ['COMPRESS=YES']}

DFLT_MAX_SPECTRAL_DIFF = 'auto'

CLUSTER_CNTRS_METADATA_NAME = 'pyshepseg_cluster_cntrs'


def getCmdargs():
    p = argparse.ArgumentParser()
    p.add_argument("-i", "--infile", help="Input Raster file")
    p.add_argument("-o", "--outfile")
    p.add_argument("-n", "--nclusters", default=60, type=int,
        help="Number of clusters (default=%(default)s)")
    p.add_argument("--eightway", default=False, action="store_true",
        help="Use 8-way instead of 4-way")
    p.add_argument("-f", "--format", default=DFLT_OUTPUT_DRIVER,
        help="Name of output format that supports RATs "
             "(default=%(default)s)")
    p.add_argument("-m", "--maxspectraldiff", default=DFLT_MAX_SPECTRAL_DIFF,
        help=("Maximum Spectral Difference to use when merging "
              "segments. Either 'auto', 'none' or a value to use "
              "(default=%(default)s)"))
    p.add_argument("-s", "--minsegmentsize", default=100, type=int,
        help="Minimum segment size in pixels (default=%(default)s)")
    p.add_argument("-c", "--clustersubsamplepercent", default=0.5,
        type=float,
        help="Percent of data to subsample for clustering "
             "(default=%(default)s)")
    p.add_argument("-b", "--bands", default="3,4,5",
        help="Comma separated list of bands to use. 1-based. "
             "(default=%(default)s)")
    p.add_argument("--fixedkmeansinit", default=False, action="store_true",
        help="Use a fixed algorithm to select initial cluster centres, "
             "for completely deterministic, reproducible results")
    p.add_argument("--sharded", default=False, action="store_true",
        help="Shard the image's rows across the devices and run the "
             "whole pipeline as one row-sharded segmentation (for single "
             "images too large for one device; output is identical). "
             "With --device cuda the devices are every visible CUDA "
             "device; 'cuda:N' or 'cpu' names the one device to use")
    p.add_argument("--device", default="cuda",
        help="Torch device to segment on: 'cuda' (raises when CUDA is "
             "absent), 'cuda:N' or 'cpu' (default=%(default)s)")

    cmdargs = p.parse_args()

    if cmdargs.infile is None:
        print('Must supply input file name')
        p.print_help()
        sys.exit()
    if cmdargs.outfile is None:
        print('Must supply output file name')
        p.print_help()
        sys.exit()

    try:
        cmdargs.maxspectraldiff = float(cmdargs.maxspectraldiff)
    except ValueError:
        if cmdargs.maxspectraldiff not in ('auto', 'none'):
            print("Only 'auto', 'none' or a value supported for "
                  "--maxspectraldiff")
            p.print_help()
            sys.exit()
        if cmdargs.maxspectraldiff == 'none':
            cmdargs.maxspectraldiff = None

    cmdargs.bands = [int(x) for x in cmdargs.bands.split(',')]
    return cmdargs


def mainCmd():
    cmdargs = getCmdargs()

    t0 = time.time()
    print("Reading ... ", end='')
    (img, refNull) = readImageBands(cmdargs)
    print(round(time.time() - t0, 1), "seconds")

    if cmdargs.sharded:
        from pyshepseg_tpu_torch.parallel.shardmap_seg import (
            doShepherdSegmentationSharded)
        segFunc = doShepherdSegmentationSharded
        device = torch.device(cmdargs.device)
        allCards = device.type == 'cuda' and device.index is None
        where = dict(mesh=None if allCards else [device])
    else:
        segFunc = shepseg.doShepherdSegmentation
        where = dict(device=cmdargs.device)
    segResult = segFunc(
        img, numClusters=cmdargs.nclusters,
        clusterSubsamplePcnt=cmdargs.clustersubsamplepercent,
        minSegmentSize=cmdargs.minsegmentsize,
        maxSpectralDiff=cmdargs.maxspectraldiff,
        imgNullVal=refNull, fourConnected=not cmdargs.eightway,
        fixedKMeansInit=cmdargs.fixedkmeansinit, verbose=True, **where)

    seg = segResult.segimg
    segSize = shepseg.makeSegSize(seg)
    writeOutput(cmdargs, seg, segSize, segResult.kmeans)


def writeOutput(cmdargs, seg, segSize, kmeansObj):
    """Write the segmentation raster + stats + overviews + colour table."""
    (nRows, nCols) = seg.shape
    if os.path.exists(cmdargs.outfile) and not rio.isNumpyDriverPath(
            cmdargs.outfile):
        os.remove(cmdargs.outfile)

    creationOptions = GDAL_DRIVER_CREATION_OPTIONS.get(cmdargs.format, [])
    inDs = rio.open(cmdargs.infile)
    outDs = rio.create(cmdargs.outfile, nCols, nRows, 1, shepseg.SegIdType,
                       cmdargs.format, creationOptions)
    proj = inDs.GetProjection()
    if proj:
        outDs.SetProjection(proj)
    gt = inDs.GetGeoTransform()
    if gt is not None:
        outDs.SetGeoTransform(gt)
    b = outDs.GetRasterBand(1)
    b.WriteArray(seg)
    b.SetMetadataItem('LAYER_TYPE', 'thematic')
    b.SetNoDataValue(int(shepseg.SEGNULLVAL))

    utils.estimateStatsFromHisto(b, segSize)
    utils.addOverviews(outDs)
    utils.writeRandomColourTable(b, int(seg.max()) + 1)
    writeClusterCentresToMetadata(b, kmeansObj)
    outDs.FlushCache()


def readImageBands(cmdargs):
    """Read the requested bands; returns (img, nullValue)."""
    ds = rio.open(cmdargs.infile)
    bandList = []
    refNull = None
    for bn in cmdargs.bands:
        b = ds.GetRasterBand(bn)
        refNull = b.GetNoDataValue()
        bandList.append(b.ReadAsArray())
    return (numpy.array(bandList), refNull)


def writeClusterCentresToMetadata(bandObj, km):
    """Save cluster centres as JSON band metadata."""
    ctrsList = [list(map(float, r)) for r in km.cluster_centers_]
    bandObj.SetMetadataItem(CLUSTER_CNTRS_METADATA_NAME,
                            json.dumps(ctrsList))


if __name__ == "__main__":
    mainCmd()
