"""
Per-segment statistics through
``tilingstats.calcPerSegmentStatsTiledMultiBand``, in a closed loop: one
pass after another over the same image and segment raster, each writing
the same attribute-table columns. The segment raster is the landscape's
patch ids, written in set-up with its 'Histogram' column. The window ends
when the first pass that finishes after ``--seconds`` finishes;
``stats_mpix_s`` is the raster pixels of all its passes over its whole
time.

Checked against the reference: every column every pass wrote, value for
value. The control is one pass of the reference's columns one precision
below.
"""

import sys
import time

import numpy as np
import torch

from gpubench import common
from gpubench import landscape as land
from gpubench.reference import npseg
from gpubench.reference import stats as rstats

WARM_EDGE = 1024


def selection(run):
    """Per band, the (column, statistic[, param]) list, and all names."""
    bands = run.traffic["bandNumbers"]
    names = [b["name"] for b in run.config["bands"]]
    sel = []
    for b in bands:
        per = []
        for stat in run.traffic["statistics"]:
            tag = stat[0] if len(stat) == 1 else "p%d" % stat[1]
            per.append(("%s_%s" % (names[b - 1], tag),) + tuple(stat))
        sel.append(per)
    return sel


def prepare(run):
    common.start(run)
    img, keys = common.scene(run, keys=True)
    with run.part("generate"):
        ids, run.state["nseg"] = land.patch_ids(keys)
        del keys
    run.state["imgpath"] = common.path(run, "scene.npseg")
    run.state["segpath"] = common.path(run, "patches.npseg")
    common.write_image(run, run.state["imgpath"], img)
    common.write_segments(run, run.state["segpath"], ids)
    # the warm-up: one pass over one window's worth of the same rasters
    e = WARM_EDGE
    warm = (common.path(run, "warm.npseg"), common.path(run, "warmseg.npseg"))
    common.write_image(run, warm[0], img[:, :e, :e])
    crop = ids[:e, :e]
    common.write_segments(run, warm[1], land.patch_ids(
        torch.where(crop > 0, crop, -1))[0])
    del img, ids
    with run.part("warmup"):
        one_pass(run, *warm)
    if run.device.type == "cuda":
        torch.cuda.empty_cache()


def one_pass(run, imgpath, segpath):
    from pyshepseg_tpu_torch import tilingstats
    return tilingstats.calcPerSegmentStatsTiledMultiBand(
        imgpath, run.traffic["bandNumbers"], segpath, selection(run),
        device=str(run.device))


def measure(run):
    grid = run.config["grid"]
    npix = grid["width"] * grid["height"]
    names = [c[0] for per in selection(run) for c in per]
    t0 = time.perf_counter()
    while True:
        with torch.profiler.record_function("gpubench.stats"):
            s0 = time.perf_counter()
            res = one_pass(run, run.state["imgpath"], run.state["segpath"])
            wall = time.perf_counter() - s0
            cols = npseg.rat_columns(run.state["segpath"], names)
        run.records.append(dict(wall=wall, timers=common.totals(res.timings),
                                cols=cols))
        if time.perf_counter() - t0 >= run.seconds:
            break
    elapsed = time.perf_counter() - t0
    print("passes %d in %.3f s: %s s each" % (
        len(run.records), elapsed,
        " ".join("%.3f" % r["wall"] for r in run.records)), file=sys.stderr)
    return {"stats_mpix_s": len(run.records) * npix / 1e6 / elapsed}


release = common.release


def reference_columns(run, float32=False):
    """{column: float64 rows 0..nseg} from the reference."""
    seg = torch.from_numpy(np.asarray(npseg.band(run.state["segpath"]))
                           .astype(np.int64)).to(run.device)
    out = {}
    for b, per in zip(run.traffic["bandNumbers"], selection(run)):
        band = torch.from_numpy(np.asarray(
            npseg.band(run.state["imgpath"], b)).astype(np.int32)).to(
                run.device)
        runs = rstats.value_runs(seg, band, run.config["nodata"])
        del band
        out.update(rstats.segment_stats(runs, run.state["nseg"], per,
                                        float32=float32))
    return out


def columns_differ(got, want):
    """Values of rows 1.. that differ, over every column."""
    return sum(int(np.count_nonzero(
        np.asarray(got[k], dtype=np.float64)[1:] != want[k][1:]))
        if len(got[k]) == len(want[k]) else len(want[k]) for k in want)


def control(run):
    run.records = [dict(cols=reference_columns(run, float32=True))]


def verify(run):
    want = reference_columns(run)
    values = wrong = 0
    for r in run.records:
        differ = columns_differ(r["cols"], want)
        values += differ
        wrong += bool(differ)
    return ([("values_differ", values, 0), ("passes_differ", wrong, 0)],
            len(run.records), wrong)
