"""
Tiles through ``shepseg.doShepherdSegmentation``, as a batch job's
``doOne`` or an in-memory caller runs them: the scene's own tiles (its
uniform grid), cycled, each a host numpy array of the segmentation bands,
each call ending with its labels on the host. The window is whole cycles:
it ends when the first pass over all the grid's tiles that finishes
after ``--seconds`` finishes, so every tile is timed equally often.
``tile_s_p95`` is the 95th percentile of the wall of every call in the
window; over one cycle of 16 tiles that is its slowest tile.

Checked against the reference: every call's labels and counts. The
control is one cycle of the reference's tiles one precision below.
"""

import sys
import time

import numpy as np
import torch

from gpubench import common
from gpubench.reference import segment as rseg


def prepare(run):
    common.start(run)
    img = common.scene(run)
    run.state["centres"], run.state["km"] = common.fit(run, img)
    with run.part("tiles"):
        run.state["tiles"] = [common.host_tile(run, img, *geo)
                              for geo in common.tile_grid(run).values()]
    common.warm_tile(run, img, run.state["km"])
    run.shapes["tile"] = run.state["tiles"][0].shape[1:]
    del img
    if run.device.type == "cuda":
        torch.cuda.empty_cache()


def call(run, k):
    """One call on tile ``k``, recorded."""
    with torch.profiler.record_function("gpubench.tile"):
        s0 = time.perf_counter()
        res = common.segment_one(run, run.state["tiles"][k], run.state["km"])
        wall = time.perf_counter() - s0
    run.records.append(dict(
        tile=k, wall=wall, seg=res.segimg,
        counts=(int(res.segimg.max()), res.singlePixelsEliminated,
                res.smallSegmentsEliminated, res.elimPasses)))


def measure(run):
    from pyshepseg_tpu_torch.ops.sync import to_host
    tiles = run.state["tiles"]
    syncs = to_host.syncs
    t0 = time.perf_counter()
    i = 0
    while True:
        call(run, i % len(tiles))
        i += 1
        if i % len(tiles) == 0 and time.perf_counter() - t0 >= run.seconds:
            break
    run.counters["host_syncs"] = to_host.syncs - syncs
    walls = [r["wall"] for r in run.records]
    print("tile calls %d (%d cycles of %d tiles) in %.3f s: median %.4f s,"
          " p95 %.4f s, max %.4f s"
          % (len(walls), len(walls) // len(tiles), len(tiles),
             time.perf_counter() - t0, float(np.median(walls)),
             common.p95(walls), max(walls)), file=sys.stderr)
    return {"tile_s_p95": common.p95(walls)}


release = common.release


def reference_tile(run, k, tf32=False):
    seg = common.segmentation(run)
    img = torch.from_numpy(run.state["tiles"][k].astype(np.int32)).to(
        run.device)
    centres = torch.from_numpy(run.state["centres"]).to(run.device)
    msd = rseg.max_spectral_diff(run.state["centres"],
                                 seg["spectDistPcntile"])
    out, c = rseg.segment_tile(img, centres, run.config["nodata"],
                               seg["minSegmentSize"], msd, tf32)
    return out.cpu().numpy().astype(np.uint32), (
        c["maxSegId"], c["singlePixelsEliminated"],
        c["smallSegmentsEliminated"], c["elimPasses"])


def control(run):
    run.records = []
    for k in range(len(run.state["tiles"])):
        seg, counts = reference_tile(run, k, tf32=True)
        run.records.append(dict(tile=k, wall=0.0, seg=seg, counts=counts))


def verify(run):
    refs = {k: reference_tile(run, k)
            for k in sorted({r["tile"] for r in run.records})}
    pixels = wrong = 0
    for r in run.records:
        want, counts = refs[r["tile"]]
        differ = int(np.count_nonzero(r["seg"] != want))
        pixels += differ
        wrong += bool(differ) or r["counts"] != counts
    return ([("pixels_differ", pixels, 0), ("calls_differ", wrong, 0)],
            len(run.records), wrong)
