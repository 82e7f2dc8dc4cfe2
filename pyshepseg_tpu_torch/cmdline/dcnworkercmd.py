"""
Multi-host (DCN) tiled-segmentation job entry point
(counterpart: pyshepseg_tpu/cmdline/dcnworkercmd.py).

Launch this SAME command on every host of the job (one process per host),
giving each its process id; the processes coordinate through a TCP store
that process 0 serves at --coordinator, segment their tile shards on
their local devices, and process 0 stitches the result (see
pyshepseg_tpu_torch.parallel.dcn).

Two processes on one host with one card (both use cuda:0):
    for ID in 0 1; do
    pyshepseg_tpu_torch_dcnworkercmd -i in.tif -o out.kea -w /shared/work \\
        --coordinator localhost:8476 --numprocesses 2 --procid $ID &
    done; wait
"""

import argparse

from pyshepseg_tpu_torch import tiling
from pyshepseg_tpu_torch.parallel.dcn import (
    doTiledShepherdSegmentationDistributed)


def getCmdargs():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-i", "--infile", required=True,
        help="Input raster")
    p.add_argument("-o", "--outfile", required=True,
        help="Output segmentation raster (written by process 0)")
    p.add_argument("-w", "--workdir", required=True,
        help="SHARED work directory visible to every host")
    p.add_argument("--coordinator", required=True,
        help="host:port at which process 0 serves the job's store")
    p.add_argument("--numprocesses", type=int, required=True,
        help="Total process count")
    p.add_argument("--procid", type=int, required=True,
        help="This process's id, 0 .. numprocesses-1")
    p.add_argument("--device", default="cuda",
        help="Torch device(s) this process segments on: 'cuda' (every "
             "visible card of the host; raises when CUDA is absent), "
             "'cuda:N' (that card) or 'cpu' (default=%(default)s)")
    p.add_argument("-t", "--tilesize", type=int,
        default=tiling.DFLT_TILESIZE,
        help="Tile size (default=%(default)s)")
    p.add_argument("-l", "--overlapsize", type=int,
        default=tiling.DFLT_OVERLAPSIZE,
        help="Tile overlap (default=%(default)s)")
    p.add_argument("-m", "--minsegmentsize", type=int, default=50,
        help="Minimum segment size in pixels (default=%(default)s)")
    p.add_argument("-n", "--numclusters", type=int, default=60,
        help="Number of spectral clusters (default=%(default)s)")
    p.add_argument("-b", "--bands",
        help="Comma-separated list of bands to use (default: all)")
    p.add_argument("--maxspectraldiff", default='auto',
        help="Maximum spectral difference for merges (default=auto)")
    p.add_argument("--nullvalue", type=int,
        help="Image null value (default: from the file)")
    p.add_argument("--eightway", default=False, action="store_true",
        help="8-connected clumping (default: 4-connected)")
    p.add_argument("--fixedkmeansinit", default=False, action="store_true",
        help="Deterministic diagonal k-means init")
    p.add_argument("--tilegrid", default='uniform',
        choices=('uniform', 'grow'),
        help="Tile decomposition style (default=%(default)s)")
    p.add_argument("--format", default='KEA', dest="outformat",
        help="Output raster format (default=%(default)s)")
    p.add_argument("--tilesperdevice", type=int, default=1,
        help="Tiles each local device takes from a chunk, where the "
             "host has several devices (default=%(default)s)")
    p.add_argument("-v", "--verbose", default=False, action="store_true",
        help="Print progress")
    return p.parse_args()


def mainCmd():
    args = getCmdargs()
    bandNumbers = None
    if args.bands is not None:
        bandNumbers = [int(b) for b in args.bands.split(",")]
    maxSpectralDiff = args.maxspectraldiff
    if maxSpectralDiff == 'none':
        # unbounded merging, as the sibling CLIs spell it
        maxSpectralDiff = None
    elif maxSpectralDiff not in ('auto', None):
        maxSpectralDiff = float(maxSpectralDiff)

    res = doTiledShepherdSegmentationDistributed(
        args.infile, args.outfile, args.workdir,
        tileSize=args.tilesize, overlapSize=args.overlapsize,
        minSegmentSize=args.minsegmentsize, numClusters=args.numclusters,
        bandNumbers=bandNumbers, maxSpectralDiff=maxSpectralDiff,
        imgNullVal=args.nullvalue, fixedKMeansInit=args.fixedkmeansinit,
        fourConnected=not args.eightway, verbose=args.verbose,
        outputDriver=args.outformat, tileGrid=args.tilegrid,
        coordinatorAddress=args.coordinator,
        numProcesses=args.numprocesses, processId=args.procid,
        tilesPerDevice=args.tilesperdevice, device=args.device)
    if res is not None and args.verbose:
        print("Found", res.maxSegId, "segments; empty-segments =",
              res.hasEmptySegments)


if __name__ == "__main__":
    mainCmd()
