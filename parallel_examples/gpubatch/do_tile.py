#!/usr/bin/env python
"""
Batch pipeline phase 2 (one job per tile, array-indexed): segment a
single tile on this node's GPU and upload the labelled tile to the
object store. GPU counterpart of parallel_examples/tpubatch/do_tile.py
(and of the reference's parallel_examples/awsbatch/do_tile.py, indexed by
AWS_BATCH_JOB_ARRAY_INDEX there; any of the common array-index env vars
or --index here).

Tile jobs are independent and idempotent: a failed/preempted job can
simply be re-run, which is what gives the batch pipeline its coarse
elastic recovery (the reference gets the same from Batch job retries).

Every job is a fresh process, so every tile pays the interpreter, the
CUDA context and the kernel library's load (and its nvcc build, when the
library is not there yet). Before it exits the job prints one line,
``TILEJOB {json}``, with its own seconds by stage, its CUDA kernel
launches and its peak device memory; ``seconds`` holds:

- ``import``: from this script's first statement to the end of its
  imports (torch and the package), of which ``torch`` is ``import torch``;
- ``cudainit``: the first CUDA call (context creation; 0 on the CPU);
- ``kernels``: building (``build`` of it, 0 when up to date) and loading
  the kernel library (0 on the CPU, which runs the plain versions);
- ``download``: ``prepare.pkl`` from the store;
- ``doOne``: doTiledShepherdSegmentation_doOne, of which ``reading`` is
  the tile's band reads;
- ``upload``: the tile into the store;
- ``total``: from the first statement to that line.
"""

import time

_T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pickle  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

import torch  # noqa: E402

_T_TORCH = time.time()

# Allow running straight from a repo checkout without an installed
# package: if pyshepseg_tpu_torch is not importable, add the repo root
# (two levels up from this script) to sys.path.
try:
    import pyshepseg_tpu_torch  # noqa: F401
except ImportError:
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))

from pyshepseg_tpu_torch import _kernels, tiling  # noqa: E402
from pyshepseg_tpu_torch import io as rio  # noqa: E402
from pyshepseg_tpu_torch.ops import local_ccl, lut  # noqa: E402
from pyshepseg_tpu_torch.timinghooks import Timers  # noqa: E402

from objstore import ObjectStore  # noqa: E402

_T_IMPORTED = time.time()

# Array-index environment variables of common schedulers, in priority
# order: AWS Batch, GCP Batch, Slurm
INDEX_ENV_VARS = ["AWS_BATCH_JOB_ARRAY_INDEX", "BATCH_TASK_INDEX",
                  "SLURM_ARRAY_TASK_ID"]


def getCmdargs():
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--store", required=True, help="Object store URL")
    p.add_argument("--index", type=int, default=None,
                   help="Tile index (default: scheduler array-index env)")
    p.add_argument("--minsegmentsize", type=int, default=50)
    p.add_argument("--maxspectraldiff", default="auto")
    p.add_argument("--eightway", action="store_true", default=False)
    p.add_argument("--spectdistpcntile", type=int, default=50)
    p.add_argument("--device", default="cuda",
                   help="Torch device the tile is segmented on, whatever "
                        "device the prepare job fitted on: 'cuda' (raises "
                        "when CUDA is absent), 'cuda:N' or 'cpu' "
                        "(default=%(default)s)")
    return p.parse_args()


def resolveIndex(cmdargs):
    if cmdargs.index is not None:
        return cmdargs.index
    for var in INDEX_ENV_VARS:
        if var in os.environ:
            return int(os.environ[var])
    raise SystemExit("No --index and no scheduler array-index env var set")


class TimedBand:
    """A raster band whose reads are timed under 'reading'."""

    def __init__(self, band, timers):
        self.band = band
        self.timers = timers

    def ReadAsArray(self, *args, **kwargs):
        with self.timers.interval("reading"):
            return self.band.ReadAsArray(*args, **kwargs)


class TimedDataset:
    """The input dataset as doOne uses it, with its band reads timed
    (doOne reads the tile itself, so the read cannot be timed around)."""

    def __init__(self, ds, timers):
        self.ds = ds
        self.timers = timers

    def GetRasterBand(self, bandNum):
        return TimedBand(self.ds.GetRasterBand(bandNum), self.timers)

    def GetProjection(self):
        return self.ds.GetProjection()

    def GetGeoTransform(self):
        return self.ds.GetGeoTransform()


def total(timers, name):
    return float(sum(timers.getDurationsForName(name) or [0.0]))


def main():
    cmdargs = getCmdargs()
    # raises here, before anything is downloaded, when CUDA is asked for
    # and absent: a tile job never carries on on the CPU by itself
    device = _kernels.torch_device(cmdargs.device)
    idx = resolveIndex(cmdargs)
    maxSpectralDiff = cmdargs.maxspectraldiff
    if maxSpectralDiff != "auto":
        maxSpectralDiff = float(maxSpectralDiff)

    timers = Timers()
    buildSeconds = 0.0
    if device.type == "cuda":
        with timers.interval("cudainit"):
            torch.zeros(1, device=device)
            torch.cuda.synchronize(device)
        with timers.interval("kernels"):
            buildSeconds = _kernels.build()
            _kernels.lib()
        torch.cuda.reset_peak_memory_stats(device)

    store = ObjectStore(cmdargs.store)
    with tempfile.TemporaryDirectory() as tmpDir:
        with timers.interval("download"):
            prepFile = store.download("prepare.pkl",
                                      os.path.join(tmpDir, "prepare.pkl"))
            with open(prepFile, "rb") as f:
                prep = pickle.load(f)

        col, row = prep["colRowList"][idx]
        tileName = "tile_{}_{}.npseg".format(col, row)
        localTile = os.path.join(tmpDir, tileName)
        with timers.interval("doOne"):
            tiling.doTiledShepherdSegmentation_doOne(
                TimedDataset(rio.open(prep["infile"]), timers), localTile,
                prep["tileInfo"], col, row,
                prep["bandNumbers"], prep["imgNullVal"], prep["kmeansObj"],
                minSegmentSize=cmdargs.minsegmentsize,
                maxSpectralDiff=maxSpectralDiff,
                fourConnected=not cmdargs.eightway,
                spectDistPcntile=cmdargs.spectdistpcntile, verbose=True,
                device=device)
        with timers.interval("upload"):
            store.upload(localTile, tileName)

    print("Tile ({}, {}) [index {}] uploaded".format(col, row, idx))
    seconds = {"import": _T_IMPORTED - _T_START,
               "torch": _T_TORCH - _T_START, "build": buildSeconds}
    for name in ("cudainit", "kernels", "download", "doOne", "reading",
                 "upload"):
        seconds[name] = total(timers, name)
    seconds["total"] = time.time() - _T_START
    peak = (torch.cuda.max_memory_allocated(device) / 2 ** 20
            if device.type == "cuda" else 0.0)
    print("TILEJOB " + json.dumps({
        "index": idx, "col": col, "row": row, "device": str(device),
        "seconds": seconds,
        "launches": {"local_ccl": local_ccl.local_ccl_blocks.launches,
                     "lut_gather": lut.lut_gather.launches},
        "peak_mib": peak}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
