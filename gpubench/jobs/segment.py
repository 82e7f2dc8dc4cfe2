"""
Whole scenes through ``tiling.doTiledShepherdSegmentation``, in a closed
loop: one scene after another, each to the same output path. The window
ends when the first scene that finishes after ``--seconds`` finishes;
``scene_mpix_s`` is the raster pixels of all its scenes (fill included)
over its whole time (a cell may report it split by cells, as
``scene_mpix_s.<qualifier>``). After the window every scene's wall, its
main Timers totals and the process's CPU seconds go to standard error,
one line a scene, so a run's log shows which stage spread.

Checked against the reference: the last scene's output raster pixel for
pixel, and every scene's 'Histogram' column and largest id. The control
writes the reference's mosaic one precision below where the scenes go.
"""

import sys
import time

import numpy as np
import torch

from gpubench import common
from gpubench.reference import npseg
from gpubench.reference import segment as rseg
from gpubench.reference import stitch as rstitch


def prepare(run):
    common.start(run)
    img = common.scene(run)
    run.state["inpath"] = common.path(run, "scene.npseg")
    run.state["outpath"] = common.path(run, "segments.npseg")
    common.write_image(run, run.state["inpath"], img)
    run.state["centres"], run.state["km"] = common.fit(run, img)
    common.warm_tile(run, img, run.state["km"])
    del img
    if run.device.type == "cuda":
        torch.cuda.empty_cache()


def measure(run):
    from pyshepseg_tpu_torch import tiling
    seg, drv, grid = (common.segmentation(run), run.config["driver"],
                      run.config["grid"])
    conc = tiling.SegmentationConcurrencyConfig(
        concurrencyType=drv["concurrencyType"],
        numWorkers=drv["numWorkers"],
        deviceSceneCache=drv["deviceSceneCache"])
    npix = grid["width"] * grid["height"]
    t0 = time.perf_counter()
    while True:
        cpu0 = time.process_time()
        with torch.profiler.record_function("gpubench.scene"):
            s0 = time.perf_counter()
            res = tiling.doTiledShepherdSegmentation(
                run.state["inpath"], run.state["outpath"],
                tileSize=seg["tileSize"], overlapSize=seg["overlapSize"],
                minSegmentSize=seg["minSegmentSize"],
                numClusters=seg["numClusters"],
                bandNumbers=seg["bandNumbers"],
                maxSpectralDiff=seg["maxSpectralDiff"],
                fourConnected=seg["fourConnected"],
                spectDistPcntile=seg["spectDistPcntile"],
                kmeansObj=run.state["km"], concurrencyCfg=conc,
                tileGrid=seg["tileGrid"], device=str(run.device))
            wall = time.perf_counter() - s0
            hist = npseg.histogram(run.state["outpath"])
        common.count_mapped(run, run.state["outpath"])
        run.records.append(dict(wall=wall, cpu_s=time.process_time() - cpu0,
                                timers=common.totals(res.timings),
                                maxSegId=int(res.maxSegId), hist=hist))
        if time.perf_counter() - t0 >= run.seconds:
            break
    elapsed = time.perf_counter() - t0
    print("scenes %d in %.3f s: %s s each" % (
        len(run.records), elapsed,
        " ".join("%.3f" % r["wall"] for r in run.records)),
        file=sys.stderr)
    for i, r in enumerate(run.records):
        print(scene_line(i, r), file=sys.stderr)
    return {"scene_mpix_s": len(run.records) * npix / 1e6 / elapsed}


# the Timers intervals a scene's line gives, in the tiled driver's order
SCENE_TIMERS = ("reading", "segmentation", "stitchtiles", "stitchwait",
                "stitchfinalize")


def scene_line(i, rec):
    """One scene of the window: its wall, its main Timers totals and the
    process's CPU seconds (all threads) over it."""
    parts = ["scene %d: wall %.3f" % (i, rec["wall"])]
    parts += ["%s %.3f" % (k, rec["timers"][k]) for k in SCENE_TIMERS
              if k in rec["timers"]]
    parts.append("cpu_s %.3f" % rec["cpu_s"])
    return ", ".join(parts)


release = common.release


def reference_mosaic(run, tf32=False):
    """The reference's mosaic of the input file, and its largest id."""
    seg, grid = common.segmentation(run), run.config["grid"]
    bands = [npseg.band(run.state["inpath"], b) for b in seg["bandNumbers"]]
    centres = torch.from_numpy(run.state["centres"]).to(run.device)
    msd = rseg.max_spectral_diff(run.state["centres"],
                                 seg["spectDistPcntile"])
    tiles = {}
    for key, (x, y, xs, ys) in common.tile_grid(run).items():
        img = torch.from_numpy(np.stack(
            [b[y:y + ys, x:x + xs] for b in bands]).astype(np.int32)).to(
                run.device)
        out, _ = rseg.segment_tile(img, centres, run.config["nodata"],
                                   seg["minSegmentSize"], msd, tf32)
        tiles[key] = out.cpu().numpy().astype(np.uint32)
    return rstitch.stitch(tiles, grid["height"], grid["width"],
                          seg["tileSize"], seg["overlapSize"])


def control(run):
    mosaic, last = reference_mosaic(run, tf32=True)
    common.write_segments(run, run.state["outpath"],
                          torch.from_numpy(mosaic.astype(np.int64)))
    run.records = [dict(maxSegId=last, hist=rstitch.histogram(mosaic))]


def verify(run):
    mosaic, last = reference_mosaic(run)
    hist = rstitch.histogram(mosaic)
    got = npseg.band(run.state["outpath"])
    pixels = int(np.count_nonzero(got != mosaic))
    wrong = sum(1 for r in run.records
                if r["maxSegId"] != last or not np.array_equal(r["hist"],
                                                               hist))
    return ([("pixels_differ", pixels, 0), ("scenes_differ", wrong, 0)],
            len(run.records), wrong)
