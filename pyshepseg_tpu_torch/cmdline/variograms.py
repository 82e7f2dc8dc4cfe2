"""
Command-line tool: per-segment variograms via the spatial-stats user
function (counterpart: pyshepseg_tpu/cmdline/variograms.py; reference:
pyshepseg/cmdline/variograms.py), on the device given by ``--device``.
"""

import argparse

from pyshepseg_tpu_torch import tilingstats
from pyshepseg_tpu_torch import io as rio


def getCmdargs():
    p = argparse.ArgumentParser()
    p.add_argument("-i", "--infile", required=True,
        help="Input file to collect stats from")
    p.add_argument("-s", "--segfile", required=True,
        help="File from segmentation. Note: stats are written into the "
             "RAT in this file")
    p.add_argument("-n", "--numvariograms", required=True,
        choices=list(range(1, 10)), type=int,
        help="Number of variograms to calculate")
    p.add_argument("--device", default="cuda",
        help="Torch device of the stats engine: 'cuda' (raises when CUDA "
             "is absent), 'cuda:N' or 'cpu' (default=%(default)s)")
    return p.parse_args()


def mainCmd():
    cmdargs = getCmdargs()
    cols = [("variogram{}".format(n + 1), rio.GFT_Real)
            for n in range(cmdargs.numvariograms)]
    tilingstats.calcPerSegmentSpatialStatsTiled(
        cmdargs.infile, 1, cmdargs.segfile, cols,
        tilingstats.userFuncVariogram, cmdargs.numvariograms,
        device=cmdargs.device)


if __name__ == '__main__':
    mainCmd()
