#!/usr/bin/env python
"""
Batch pipeline phase 1 (runs once, any node): whole-image k-means +
tile grid, persisted to the object store so every tile job can run
independently. GPU counterpart of parallel_examples/tpubatch/do_prepare.py
(and of the reference's parallel_examples/awsbatch/do_prepare.py, which
pickles the same state to S3 and submits the array job).

The k-means fit runs on ``--device``: one GPU is plenty, since the fit
uses a ~1e6-pixel subsample. The pickled state is numpy arrays and plain
Python objects, so it loads on a node whose devices differ; where a tile
runs is decided by the tile job's own ``--device``.
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

from pyshepseg_tpu_torch import tiling

from objstore import ObjectStore


def getCmdargs():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--infile", required=True,
                   help="Path/URL of the input raster (visible to workers)")
    p.add_argument("--store", required=True,
                   help="Object store URL (file://dir or s3://bucket/prefix)")
    p.add_argument("--tilesize", type=int, default=tiling.DFLT_TILESIZE)
    p.add_argument("--overlapsize", type=int,
                   default=tiling.DFLT_OVERLAPSIZE)
    p.add_argument("--nclusters", type=int, default=60)
    p.add_argument("--bands", help="Comma-separated band numbers (1-based)")
    p.add_argument("--fixedkmeansinit", action="store_true", default=False)
    p.add_argument("--device", default="cuda",
                   help="Torch device of the k-means fit: 'cuda' (raises "
                        "when CUDA is absent), 'cuda:N' or 'cpu' "
                        "(default=%(default)s)")
    return p.parse_args()


def main():
    cmdargs = getCmdargs()
    store = ObjectStore(cmdargs.store)

    bandNumbers = None
    if cmdargs.bands:
        bandNumbers = [int(b) for b in cmdargs.bands.split(",")]

    (inDs, bandNumbers, kmeansObj, subsamplePcnt, imgNullVal, tileInfo) = (
        tiling.doTiledShepherdSegmentation_prepare(
            cmdargs.infile, tileSize=cmdargs.tilesize,
            overlapSize=cmdargs.overlapsize, numClusters=cmdargs.nclusters,
            bandNumbers=bandNumbers,
            fixedKMeansInit=cmdargs.fixedkmeansinit, verbose=True,
            device=cmdargs.device))

    colRowList = sorted(tileInfo.tiles.keys(), key=lambda x: (x[1], x[0]))
    dataChunk = {
        "tileInfo": tileInfo,
        "colRowList": colRowList,
        "bandNumbers": list(bandNumbers),
        "imgNullVal": imgNullVal,
        "kmeansObj": kmeansObj,
        "overlapSize": cmdargs.overlapsize,
        "infile": cmdargs.infile,
    }
    with tempfile.NamedTemporaryFile(suffix=".pkl", delete=False) as f:
        pickle.dump(dataChunk, f)
        tmpname = f.name
    try:
        store.upload(tmpname, "prepare.pkl")
    finally:
        os.remove(tmpname)

    print("Prepared {} tiles; state uploaded to {}/prepare.pkl".format(
        len(colRowList), cmdargs.store))
    # The array size the submitter should use for the tile jobs
    print("NUMTILES={}".format(len(colRowList)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
