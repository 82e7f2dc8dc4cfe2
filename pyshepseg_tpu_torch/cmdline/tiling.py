"""
Command-line tool: full tiled segmentation pipeline
(counterpart: pyshepseg_tpu/cmdline/tiling.py; reference:
pyshepseg/cmdline/tiling.py) — segmentation parameters, tiling
parameters, per-segment statistics specs, colour tables, and concurrency
flags, on the device given by ``--device``. With ``--concurrencytype
CONC_MESH`` the tiles are dealt to every visible CUDA device (or run on
the one device that ``--device cpu`` names), ``--tilesperdevice`` at a
time to each.
"""

import sys
import json
import time
import argparse

from pyshepseg_tpu_torch import tiling
from pyshepseg_tpu_torch import tilingstats
from pyshepseg_tpu_torch import utils
from pyshepseg_tpu_torch import io as rio

DFLT_OUTPUT_DRIVER = 'KEA'
GDAL_DRIVER_CREATION_OPTIONS = {'KEA': [], 'HFA': ['COMPRESS=YES']}

DFLT_MAX_SPECTRAL_DIFF = 'auto'


def getCmdargs():
    p = argparse.ArgumentParser()
    p.add_argument("-i", "--infile", help="Input Raster file")
    p.add_argument("-o", "--outfile")
    p.add_argument("--verbose", default=False, action="store_true",
        help="Turn on verbose output.")
    p.add_argument("--nullvalue", default=None, type=int,
        help="Null value for input image. If not given, the value set in "
             "the image is used.")
    p.add_argument("-f", "--format", default=DFLT_OUTPUT_DRIVER,
        help="Name of output format that supports RATs "
             "(default=%(default)s)")
    p.add_argument("--device", default="cuda",
        help="Torch device for the segmentation and the stats pass: "
             "'cuda' (raises when CUDA is absent), 'cuda:N' or 'cpu' "
             "(default=%(default)s)")

    segGroup = p.add_argument_group("Segmentation Parameters")
    tileGroup = p.add_argument_group("Tiling Parameters")
    statsGroup = p.add_argument_group("Per-segment Statistics")
    concGroup = p.add_argument_group("Concurrency")

    segGroup.add_argument("-n", "--nclusters", default=60, type=int,
        help="Number of clusters (default=%(default)s)")
    segGroup.add_argument("--eightway", default=False, action="store_true",
        help="Use 8-way instead of 4-way")
    segGroup.add_argument("-m", "--maxspectraldiff",
        default=DFLT_MAX_SPECTRAL_DIFF,
        help="Maximum Spectral Difference to use when merging segments. "
             "Either 'auto', 'none' or a value (default=%(default)s)")
    segGroup.add_argument("-s", "--minsegmentsize", default=100, type=int,
        help="Minimum segment size in pixels (default=%(default)s)")
    segGroup.add_argument("-b", "--bands", default="3,4,5",
        help="Comma-separated list of bands to use. 1-based. "
             "(default=%(default)s)")
    segGroup.add_argument("--fixedkmeansinit", default=False,
        action="store_true",
        help="Use a fixed algorithm to select initial cluster centres, "
             "for completely deterministic, reproducible results")

    tileGroup.add_argument("-t", "--tilesize", default=tiling.DFLT_TILESIZE,
        type=int,
        help="Size (in pixels) of tiles to chop input image into "
             "(default=%(default)s)")
    tileGroup.add_argument("-l", "--overlapsize",
        default=tiling.DFLT_OVERLAPSIZE, type=int,
        help="Size (in pixels) of the overlap between tiles "
             "(default=%(default)s)")
    tileGroup.add_argument("-c", "--clustersubsamplepercent", default=None,
        type=float,
        help="Percent of data to subsample for clustering (across all "
             "tiles). If not given, 1 million pixels are used.")
    tileGroup.add_argument("--tilegrid", default="uniform",
        choices=("uniform", "grow"),
        help="Tile decomposition: 'uniform' keeps every tile exactly "
             "tilesize; 'grow' "
             "reproduces the reference's grown-edge-tile grid "
             "(default=%(default)s)")
    tileGroup.add_argument("--simplerecode", default=False,
        action="store_true",
        help="Use a simple recode method when merging tiles, rather than "
             "merging segments across the tile boundary (testing only)")

    statsGroup.add_argument("--statsbands",
        help="Comma-separated list of bands for which to calculate "
             "per-segment statistics as RAT columns")
    statsGroup.add_argument("--statspec", default=[], action="append",
        help="Statistic to include in the RAT, may be repeated. Options: "
             "'mean', 'stddev', 'min', 'max', 'median', 'mode', "
             "'percentile,p'")
    statsGroup.add_argument("--statsreadworkers", type=int, default=None,
        help="Read+compact worker threads for the stats pass "
             "(default: min(4, cpu_count - 1))")
    statsGroup.add_argument("--statsengine", default="auto",
        choices=["auto", "host", "device"],
        help="Where the stats pass compacts each tile's (segment, value) "
             "pairs into histogram runs: 'host' (numpy), 'device' (one "
             "torch sort on --device, the GPU by default; bit-identical "
             "columns), or 'auto' (the device on a CUDA --device for "
             "imagery that fits int32, else the host) "
             "(default=%(default)s)")
    statsGroup.add_argument("--colortablebands",
        help="Comma-separated list of 3 band numbers (red,green,blue) "
             "whose per-segment means colour the segments")

    concGroup.add_argument("--concurrencytype", default=tiling.CONC_NONE,
        choices=[tiling.CONC_NONE, tiling.CONC_THREADS, tiling.CONC_FARGATE,
                 tiling.CONC_SUBPROC, tiling.CONC_MESH],
        help="Type of concurrency for tiled segmentation; CONC_MESH "
             "deals chunks of tiles to every visible CUDA device "
             "(default=%(default)s)")
    concGroup.add_argument("--numworkers", default=0, type=int,
        help="Number of workers for concurrent segmentation "
             "(default=%(default)s)")
    concGroup.add_argument("--fargatecfg",
        help="JSON file of keyword arguments for FargateConfig "
             "(for use with CONC_FARGATE)")
    concGroup.add_argument("--tilecompletiontimeout", type=int, default=60,
        help="Timeout (seconds) to wait for completion of each tile "
             "(default=%(default)s)")
    concGroup.add_argument("--scenecache", default="auto",
        choices=["auto", "on", "off"],
        help="Whole-scene device-memory cache for the in-process "
             "backends: the scene is copied to the device once and tiles "
             "are sliced there, instead of re-reading each overlapping "
             "tile from the file. 'auto' enables it when the scene fits "
             "the device's memory budget (default=%(default)s)")
    concGroup.add_argument("--tilesperdevice", type=int, default=1,
        help="With CONC_MESH, tiles each device takes from a chunk of "
             "nDev * tilesperdevice tiles (default=%(default)s)")
    concGroup.add_argument("--workerdevices", default="default",
        choices=["default", "all"],
        help="With CONC_THREADS, 'all' assigns worker threads to the "
             "host's CUDA devices round-robin so the pipelined tile "
             "flow drives every card (default=%(default)s)")

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
    if cmdargs.statsbands is not None:
        cmdargs.statsbands = [int(x) for x in cmdargs.statsbands.split(',')]
    else:
        cmdargs.statsbands = []
    if cmdargs.colortablebands is not None:
        cmdargs.colortablebands = [int(x) for x in
                                   cmdargs.colortablebands.split(',')]
        if cmdargs.statspec is None or 'mean' not in cmdargs.statspec:
            print('Using --colortablebands requires "--statspec mean"')
            sys.exit()
        for i in cmdargs.colortablebands:
            if i not in cmdargs.statsbands:
                print("Bands given in --colortablebands must also be in "
                      "--statsbands")
                sys.exit()

    return cmdargs


def mainCmd():
    cmdargs = getCmdargs()

    creationOptions = GDAL_DRIVER_CREATION_OPTIONS.get(cmdargs.format, [])

    fargateCfg = None
    if cmdargs.fargatecfg is not None:
        fargateCfg_kwArgs = json.load(open(cmdargs.fargatecfg))
        fargateCfg = tiling.FargateConfig(**fargateCfg_kwArgs)
    concurrencyCfg = tiling.SegmentationConcurrencyConfig(
        concurrencyType=cmdargs.concurrencytype,
        numWorkers=cmdargs.numworkers,
        fargateCfg=fargateCfg,
        tileCompletionTimeout=cmdargs.tilecompletiontimeout,
        deviceSceneCache={"auto": "auto", "on": True,
                          "off": False}[cmdargs.scenecache],
        tilesPerDevice=cmdargs.tilesperdevice,
        workerDevices=cmdargs.workerdevices)

    tiledSegResult = tiling.doTiledShepherdSegmentation(
        cmdargs.infile, cmdargs.outfile,
        tileSize=cmdargs.tilesize, overlapSize=cmdargs.overlapsize,
        minSegmentSize=cmdargs.minsegmentsize,
        numClusters=cmdargs.nclusters,
        bandNumbers=cmdargs.bands,
        subsamplePcnt=cmdargs.clustersubsamplepercent,
        maxSpectralDiff=cmdargs.maxspectraldiff,
        imgNullVal=cmdargs.nullvalue,
        fixedKMeansInit=cmdargs.fixedkmeansinit,
        fourConnected=not cmdargs.eightway, verbose=cmdargs.verbose,
        simpleTileRecode=cmdargs.simplerecode, outputDriver=cmdargs.format,
        creationOptions=creationOptions, concurrencyCfg=concurrencyCfg,
        tileGrid=cmdargs.tilegrid, device=cmdargs.device)

    if cmdargs.verbose and tiledSegResult.timings is not None:
        summaryDict = tiledSegResult.timings.makeSummaryDict()
        print('\n' + utils.formatTimingRpt(summaryDict) + '\n')

    outDs = rio.open(cmdargs.outfile, rio.GA_Update)
    band = outDs.GetRasterBand(1)
    if cmdargs.colortablebands is None:
        utils.writeRandomColourTable(band, tiledSegResult.maxSegId + 1)
    del outDs

    t0 = time.time()
    doPerSegmentStats(cmdargs)
    if cmdargs.verbose:
        print('Done per-segment statistics: {:.2f} seconds'.format(
            time.time() - t0))

    if cmdargs.colortablebands is not None:
        colorTableNames = ['Band_{}_mean'.format(i)
                           for i in cmdargs.colortablebands]
        utils.writeColorTableFromRatColumns(
            cmdargs.outfile, colorTableNames[0], colorTableNames[1],
            colorTableNames[2])


def doPerSegmentStats(cmdargs):
    """Calculate the requested per-segment statistics RAT columns —
    every band in ONE pass over the segmentation raster
    (calcPerSegmentStatsTiledMultiBand), instead of the reference's
    re-read of the whole segmentation per band."""
    statsSelectionList = []
    for statsBand in cmdargs.statsbands:
        statsSelection = []
        for statsSpec in cmdargs.statspec:
            if statsSpec.startswith('percentile,'):
                param = int(statsSpec.split(',')[1])
                name = "Band_{}_pcnt{}".format(statsBand, param)
                selection = (name, 'percentile', param)
            else:
                name = "Band_{}_{}".format(statsBand, statsSpec)
                selection = (name, statsSpec)
            statsSelection.append(selection)
        statsSelectionList.append(statsSelection)

    if statsSelectionList:
        rtn = tilingstats.calcPerSegmentStatsTiledMultiBand(
            cmdargs.infile, cmdargs.statsbands, cmdargs.outfile,
            statsSelectionList, numReadWorkers=cmdargs.statsreadworkers,
            engine=cmdargs.statsengine, device=cmdargs.device)

        if cmdargs.verbose:
            print(utils.formatTimingRpt(rtn.timings.makeSummaryDict())
                  + '\n')


if __name__ == "__main__":
    mainCmd()
