"""The port's spans and counts (pyshepseg_tpu_torch.timinghooks) under a
CPU ``torch.profiler`` session: nothing is kept without one; spans from
the main thread and from pool threads are kept with their parent and
unit key; a main-thread span is also the profiler's own event, on the
same clock; Timers with counts pickle and merge; and the segmentation,
the tiled driver and the statistics pass record what they should."""

import pickle
import threading
from concurrent import futures

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from pyshepseg_tpu_torch import io as rio
from pyshepseg_tpu_torch import shepseg, tiling, tilingstats, timinghooks
from pyshepseg_tpu_torch.ops.sync import to_host
from torch_parity import voronoi_image, write_raster


def session():
    """A CPU profiler session; the call before it finds none running,
    so the session starts an empty trace."""
    assert not timinghooks.tracing()
    return profile(activities=[ProfilerActivity.CPU])


def names(spans):
    return [s.name for s in spans]


def test_nothing_is_kept_without_a_session():
    with session():
        with timinghooks.span("old"):
            pass
    assert names(timinghooks.TRACE.spans) == ["old"]
    timers = timinghooks.Timers()
    with timinghooks.unit((0, 0)), timinghooks.span("a"), \
            timers.interval("b"):
        timinghooks.count("c", 3)
    assert not timinghooks.tracing()
    # the trace of the last session stays as it was
    assert names(timinghooks.TRACE.spans) == ["old"]
    assert timinghooks.TRACE.counts == {}
    assert len(timers.getDurationsForName("b")) == 1
    # a new session starts an empty trace
    with session():
        assert timinghooks.tracing()
    assert timinghooks.TRACE.spans == []


def test_spans_from_pool_threads_parent_and_key():
    def work(k):
        with timinghooks.unit(("tile", k)):
            with timinghooks.span("outer"):
                with timinghooks.span("inner"):
                    timinghooks.count("work", 2)
        return threading.get_ident()

    with session():
        with timinghooks.span("main"):
            with futures.ThreadPoolExecutor(3) as pool:
                threads = set(pool.map(work, range(6)))
    spans = timinghooks.TRACE.spans
    assert sorted(names(spans)) == ["inner"] * 6 + ["main"] + ["outer"] * 6
    byId = {s.id: s for s in spans}
    (main, ) = [s for s in spans if s.name == "main"]
    assert main.parent is None and main.key is None
    inner = [s for s in spans if s.name == "inner"]
    assert sorted(s.key for s in inner) == [("tile", k) for k in range(6)]
    for s in inner:
        outer = byId[s.parent]
        assert outer.name == "outer" and outer.key == s.key
        assert outer.thread == s.thread != main.thread
        # the pool thread's own stack: its top span has no parent
        assert outer.parent is None
        assert outer.start <= s.start <= s.end <= outer.end
    assert {s.thread for s in inner} <= threads
    assert timinghooks.TRACE.counts == {"work": 12}


def test_unit_keeps_an_enclosing_key_or_numbers_calls():
    with session():
        with timinghooks.unit((3, 4)):
            with timinghooks.unit(), timinghooks.span("kept"):
                pass
        with timinghooks.unit(), timinghooks.span("first"):
            pass
        with timinghooks.unit(), timinghooks.span("second"):
            pass
    keys = {s.name: s.key for s in timinghooks.TRACE.spans}
    assert keys["kept"] == (3, 4)
    assert isinstance(keys["first"], int)
    assert keys["second"] == keys["first"] + 1


def test_main_thread_span_is_the_profilers_event_on_its_clock():
    with session() as prof:
        with timinghooks.span("shepseg.mirror"):
            pass
    (mine, ) = timinghooks.TRACE.spans
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name() == "shepseg.mirror"]
    assert len(events) == 1
    assert abs(events[0].start_ns() - mine.start) < 1_000_000
    assert events[0].is_user_annotation()


def test_trace_is_bounded(monkeypatch):
    monkeypatch.setattr(timinghooks, "MAX_SPANS", 3)
    with session():
        for _ in range(5):
            with timinghooks.span("s"):
                pass
    assert len(timinghooks.TRACE.spans) == 3
    assert timinghooks.TRACE.dropped == 2


def test_timers_with_counts_pickle_and_merge():
    a, b = timinghooks.Timers(), timinghooks.Timers()
    with a.interval("x"):
        a.count("n", 2)
    with session():
        with b.interval("x"):
            b.count("n", 5)
            b.count("m")
    for span in timinghooks.TRACE.spans:
        b.addSpan(span)
    b2 = pickle.loads(pickle.dumps(b))
    assert b2.counts == {"n": 5, "m": 1}
    assert names(b2.spans) == ["x"]
    a.merge(b2)
    assert a.counts == {"n": 7, "m": 1}
    assert len(a.getDurationsForName("x")) == 2
    assert names(a.spans) == ["x"] and a.dropped == 0
    # the restored lock works
    b2.count("n")
    assert b2.counts["n"] == 6


STAGES = ["shepseg.call", "shepseg.upload", "shepseg.assign",
          "shepseg.clump", "shepseg.single_pixels", "shepseg.sums",
          "shepseg.edges", "elim_small.graph_loop", "shepseg.relabel",
          "shepseg.download"]


def test_segmentation_records_its_stages_passes_and_syncs(rng):
    img, _ = voronoi_image(rng, shape=(96, 96), ncentres=30, noise=40)
    syncs = to_host.syncs
    with session():
        res = shepseg.doShepherdSegmentation(
            img, numClusters=12, minSegmentSize=8, fixedKMeansInit=True,
            device="cpu")
    rise = to_host.syncs - syncs
    spans = timinghooks.TRACE.spans
    got = names(spans)
    for stage in STAGES:
        assert got.count(stage) == 1, stage
    assert res.elimPasses > 0
    assert got.count("elim_small.pass") == res.elimPasses
    assert got.count("ops.sync") == rise > res.elimPasses
    byName = {s.name: s for s in spans}
    call = byName["shepseg.call"]
    assert all(s.key == call.key for s in spans)
    assert byName["shepseg.assign"].parent == call.id
    loop = byName["elim_small.graph_loop"]
    assert all(s.parent == loop.id for s in spans
               if s.name == "elim_small.pass")
    assert timinghooks.TRACE.counts["to_host.syncs"] == rise


def test_tiled_threads_key_one_segmentation_span_a_tile(tmp_path, rng):
    img, _ = voronoi_image(rng, shape=(150, 180), ncentres=40)
    inpath = str(tmp_path / "in.npseg")
    write_raster(inpath, img)
    conc = tiling.SegmentationConcurrencyConfig(
        concurrencyType=tiling.CONC_THREADS, numWorkers=2)
    with session():
        res = tiling.doTiledShepherdSegmentation(
            inpath, str(tmp_path / "out.npseg"), tileSize=64,
            overlapSize=16, minSegmentSize=10, numClusters=8,
            fixedKMeansInit=True, concurrencyCfg=conc, device="cpu")
    spans = timinghooks.TRACE.spans
    tiles = sorted(tiling.getTilesForFile(
        rio.open(inpath), 64, 16).tiles)
    seg = [s for s in spans if s.name == "segmentation"]
    assert sorted(s.key for s in seg) == tiles
    assert len(seg) == len(res.timings.getDurationsForName("segmentation"))
    # the tile's call inherits its key; the stitch keys its parts by tile
    calls = [s for s in spans if s.name == "shepseg.call"]
    assert sorted(s.key for s in calls) == tiles
    for name in ("stitchwait", "stitch.recode", "stitch.mapping",
                 "stitch.gather", "stitch.write", "stitch.histogram"):
        assert sorted(s.key for s in spans if s.name == name) == tiles, name
    for name in ("walltime", "tiling.initialize", "stitchtiles",
                 "stitchfinalize"):
        assert names(spans).count(name) == 1, name


def test_stats_pass_counts_sorted_and_delivered_runs(tmp_path, rng,
                                                     monkeypatch):
    monkeypatch.setattr(tiling, "TILESIZE", 48)
    h, w = 120, 130
    centres = rng.uniform(0, [h, w], size=(40, 2))
    yy, xx = np.mgrid[0:h, 0:w]
    seg = (((yy[..., None] - centres[:, 0]) ** 2 +
            (xx[..., None] - centres[:, 1]) ** 2).argmin(axis=-1) + 1)
    seg = seg.astype(np.uint32)
    segpath = str(tmp_path / "seg.npseg")
    ds = rio.create(segpath, w, h, 1, np.uint32)
    ds.GetRasterBand(1).WriteArray(seg)
    hist = np.bincount(seg.ravel()).astype(np.float64)
    hist[0] = 0
    rat = ds.GetRasterBand(1).GetDefaultRAT()
    rat.CreateColumn("Histogram", rio.GFT_Real, rio.GFU_PixelCount)
    rat.WriteArray(hist, 0)
    ds.FlushCache()
    imgpath = str(tmp_path / "img.npseg")
    write_raster(imgpath, rng.integers(0, 100, size=(1, h, w)).astype(
        np.uint16))
    with session():
        tilingstats.calcPerSegmentStatsTiledMultiBand(
            imgpath, [1], segpath, [[("mean", "mean")]], engine="host",
            numReadWorkers=1, device="cpu")
    counts = timinghooks.TRACE.counts
    delivered = counts["tilingstats.merge.delivered"]
    assert delivered > 0
    assert counts["tilingstats.merge.sorted"] >= delivered
    extract = [s for s in timinghooks.TRACE.spans
               if s.name == "tilingstats.extract"]
    assert extract


@pytest.mark.parametrize("name", ["span", "unit"])
def test_off_is_one_shared_null_context(name):
    assert getattr(timinghooks, name)("x") is timinghooks._OFF
