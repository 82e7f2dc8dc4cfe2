#!/usr/bin/env python
"""
Batch pipeline phase 3 (runs once, after all tile jobs): download the
segmented tiles, stitch/recode them into the final raster, compute
per-segment statistics, and upload the result. GPU counterpart of
parallel_examples/tpubatch/do_stitch.py (and of the reference's
parallel_examples/awsbatch/do_stitch.py).

The stitch is host numpy; ``--device`` is where the per-segment
statistics pass runs. A tile that is missing from the store fails the
job: the stitch never writes an output with a hole in it.
"""

import argparse
import os
import pickle
import sys
import tempfile

# Allow running straight from a repo checkout without an installed
# package: if pyshepseg_tpu_torch is not importable, add the repo root
# (two levels up from this script) to sys.path.
try:
    import pyshepseg_tpu_torch  # noqa: F401
except ImportError:
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))

from pyshepseg_tpu_torch import _kernels, tiling, tilingstats, utils

from objstore import ObjectStore


def getCmdargs():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--store", required=True, help="Object store URL")
    p.add_argument("--outname", default="segmentation.npseg",
                   help="Output object key (default %(default)s)")
    p.add_argument("--statsbands",
                   help="Comma-separated 1-based band numbers for "
                        "per-segment mean/stddev statistics")
    p.add_argument("--colortablebands",
                   help="Three band numbers for an RGB colour table "
                        "from per-segment means, e.g. 3,2,1")
    p.add_argument("--keeptiles", action="store_true", default=False,
                   help="Do not delete tile objects from the store")
    p.add_argument("--device", default="cuda",
                   help="Torch device of the statistics pass: 'cuda' "
                        "(raises when CUDA is absent), 'cuda:N' or 'cpu' "
                        "(default=%(default)s)")
    return p.parse_args()


def main():
    cmdargs = getCmdargs()
    # raises before the download when CUDA is asked for and absent
    device = _kernels.torch_device(cmdargs.device)
    # Validate the colour-table request BEFORE the expensive download +
    # stitch: every colour band needs its per-segment mean column.
    if cmdargs.colortablebands:
        statsBands = ([int(b) for b in cmdargs.statsbands.split(",")]
                      if cmdargs.statsbands else [])
        rgb = [int(b) for b in cmdargs.colortablebands.split(",")]
        missing = [b for b in rgb if b not in statsBands]
        if missing:
            raise SystemExit(
                "--colortablebands {} need per-segment means: add band(s) "
                "{} to --statsbands".format(cmdargs.colortablebands,
                                            missing))
    store = ObjectStore(cmdargs.store)

    with tempfile.TemporaryDirectory() as tmpDir:
        prepFile = store.download("prepare.pkl",
                                  os.path.join(tmpDir, "prepare.pkl"))
        with open(prepFile, "rb") as f:
            prep = pickle.load(f)

        tileFilenames = {}
        for (col, row) in prep["colRowList"]:
            name = "tile_{}_{}.npseg".format(col, row)
            tileFilenames[(col, row)] = store.download(
                name, os.path.join(tmpDir, name))

        localOut = os.path.join(tmpDir, "segmentation.npseg")
        (maxSegId, hasEmptySegments, outDs) = (
            tiling.doTiledShepherdSegmentation_finalize(
                prep["infile"], localOut, tileFilenames, prep["tileInfo"],
                prep["overlapSize"], tmpDir, outputDriver=None,
                verbose=True))
        print("Stitched {} segments (empty-segments={})".format(
            maxSegId, hasEmptySegments))
        outDs.FlushCache()
        del outDs

        meanColNames = {}
        if cmdargs.statsbands:
            for band in [int(b) for b in cmdargs.statsbands.split(",")]:
                cols = [("Band_{}_mean".format(band), "mean"),
                        ("Band_{}_stddev".format(band), "stddev")]
                tilingstats.calcPerSegmentStatsTiled(
                    prep["infile"], band, localOut, cols, device=device)
                meanColNames[band] = cols[0][0]

        if cmdargs.colortablebands:
            rgbBands = [int(b) for b in cmdargs.colortablebands.split(",")]
            utils.writeColorTableFromRatColumns(
                localOut, meanColNames[rgbBands[0]],
                meanColNames[rgbBands[1]], meanColNames[rgbBands[2]])

        store.upload(localOut, cmdargs.outname)

        if not cmdargs.keeptiles:
            for (col, row) in prep["colRowList"]:
                store.delete("tile_{}_{}.npseg".format(col, row))
            store.delete("prepare.pkl")

    print("Result uploaded as", cmdargs.outname)
    return 0


if __name__ == "__main__":
    sys.exit(main())
