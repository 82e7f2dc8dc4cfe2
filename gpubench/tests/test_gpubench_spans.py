"""The readers of the program's own trace: each of the seven on a
synthetic trace, each silent (None, no exception) where the program keeps
no trace, and each reported by a traced CPU run of its cell."""

import types

import pytest

from gpubench import bench, roofline
from pyshepseg_tpu_torch import timinghooks

S = 10 ** 9


def span(name, start, end, key=None, thread=1):
    return timinghooks.Span(name, int(start * S), int(end * S), thread, 0,
                            None, key)


@pytest.fixture
def trace(monkeypatch):
    """An empty trace in the program's place; the test fills it."""
    t = timinghooks.Timers()
    monkeypatch.setattr(timinghooks, "TRACE", t)
    return t


def reader(name):
    return bench.Spec().metric_reader(name).read


def fake_run(records=2, kernels=None):
    trace = None if kernels is None else {"kernels": kernels}
    return types.SimpleNamespace(records=[{}] * records, trace=trace)


def test_spans_a_call(trace):
    for k, t0 in enumerate((0.0, 10.0)):
        trace.addSpan(span("elim_small.graph_loop", t0, t0 + 1.0, k))
        for j in range(3):
            trace.addSpan(span("ops.sync", t0 + j, t0 + j + 0.25, k))
    assert reader("graph_loop_s.tile")(fake_run()) == pytest.approx(1.0)
    assert reader("sync_wait_s.tile")(fake_run()) == pytest.approx(0.75)
    assert reader("graph_loop_s.tile")(fake_run(records=0)) is None


@pytest.mark.parametrize("name", ["outside_tiles_s.scene",
                                  "outside_tiles_s.landsat"])
def test_outside_the_tiles(trace, name):
    # two scenes: the workers' tiles overlap each other and one spills
    # past its scene's end; a tile of another scene does not count
    trace.addSpan(span("walltime", 0.0, 10.0))
    for a, b, w in ((1.0, 4.0, 2), (3.0, 6.0, 3), (8.0, 12.0, 2)):
        trace.addSpan(span("segmentation", a, b, thread=w))
    trace.addSpan(span("walltime", 20.0, 24.0))
    trace.addSpan(span("segmentation", 21.0, 22.0, thread=2))
    # scene 1: 10 - (5 + 2) = 3; scene 2: 4 - 1 = 3
    assert reader(name)(fake_run()) == pytest.approx(3.0)


def test_stats_resort_and_extract(trace):
    trace.count("tilingstats.merge.delivered", 400)
    trace.count("tilingstats.merge.sorted", 500)
    trace.addSpan(span("tilingstats.extract", 0.0, 0.5))
    trace.addSpan(span("tilingstats.extract", 1.0, 2.5))
    assert reader("stats_resort_x")(fake_run()) == pytest.approx(1.25)
    assert reader("stats_extract_s")(fake_run()) == pytest.approx(1.0)


def test_lut_gather_roofline(trace):
    nbytes = 3.35e9
    trace.count("lut_gather.bytes", nbytes)
    kernels = {"void (anonymous namespace)::lut_direct<int, long>(...)":
               [10, 0.002], "void lut_staged<int, int>(...)": [1, 0.002],
               "local_ccl_kernel": [1, 5.0]}
    got = reader("lut_gather_roofline")(fake_run(kernels=kernels))
    assert got == pytest.approx(roofline.roofline_pct(nbytes, 0.004))
    assert got == pytest.approx(25.0)
    assert reader("lut_gather_roofline")(fake_run(kernels={})) is None


NEW = ["graph_loop_s.tile", "sync_wait_s.tile", "lut_gather_roofline",
       "outside_tiles_s.scene", "outside_tiles_s.landsat", "stats_resort_x",
       "stats_extract_s"]


@pytest.mark.parametrize("name", NEW)
def test_silent_without_the_programs_trace(monkeypatch, name):
    """A program that keeps no trace (the commit before it) reads None."""
    monkeypatch.delattr(timinghooks, "TRACE")
    assert reader(name)(fake_run(kernels={"lut_direct": [1, 1.0]})) is None


@pytest.mark.parametrize("cell,names", [
    ("s2-cropland.tile", {"graph_loop_s.tile", "sync_wait_s.tile"}),
    ("s2-cropland.segment", {"outside_tiles_s.scene"}),
    ("landsat-rangeland.segment", {"outside_tiles_s.landsat"}),
    ("s2-cropland.stats", {"stats_resort_x", "stats_extract_s"}),
])
def test_a_traced_cpu_run_reports_them(small_spec, cell, names):
    """K2 runs only on the card, so its roofline is left out here."""
    res = bench.run_cell(small_spec, cell, 2 ** 31 + 7, 0.01, 1, "cpu")
    assert res["correct"]
    for name in names:
        assert res["metrics"][name]["value"] > 0, name
    if cell == "s2-cropland.stats":
        assert res["metrics"]["stats_resort_x"]["value"] >= 1.0
