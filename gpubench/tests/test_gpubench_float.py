"""The float32 cell, ``s2float-cropland.segment``: its job, its reference
and its readers, at the small test size on the CPU (the card's run:
``python gpubench/run.py --workload s2float-cropland.segment ...``)."""

import types

import numpy as np
import pytest
import torch

from gpubench import bench, control, roofline
from pyshepseg_tpu_torch import timinghooks

CELL = "s2float-cropland.segment"


def test_float_cell_is_correct_on_the_cpu(small_spec):
    res = bench.run_cell(small_spec, CELL, 2 ** 31 + 99, 0.01, 0, "cpu")
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"scene_mpix_s", "setup_s"}
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert all(c["value"] == 0 for c in res["checks"].values())


def test_float_control_comes_out_not_correct(small_spec, tmp_path):
    run = bench.Run(small_spec, CELL, 17, 0, 0, "cpu")
    run.workdir = str(tmp_path)
    run.job.prepare(run)
    checks = control.control_checks(run)
    assert not bench.correct(checks), checks


def test_a_traced_cpu_run_reports_the_scene_metrics(small_spec):
    """K4 runs only on the card, so its two metrics are left out here."""
    res = bench.run_cell(small_spec, CELL, 2 ** 31 + 7, 0.01, 1, "cpu")
    assert res["correct"]
    for name in ("outside_tiles_s.scene", "stitch_s.scene",
                 "tile_worker_s.scene"):
        assert res["metrics"][name]["value"] > 0, name
    assert "ordered_sum_roofline" not in res["metrics"]
    assert "ordered_sum_s.f32" not in res["metrics"]


def test_setup_warms_one_whole_scene_and_keeps_no_record(small_spec,
                                                         tmp_path):
    """The warm-up is the window's own call for one scene: it writes the
    output raster, is timed as set-up, and leaves the window's records
    and length as they were."""
    import os
    run = bench.Run(small_spec, CELL, 2 ** 31 + 3, 7.5, 0, "cpu")
    run.workdir = str(tmp_path)
    run.job.prepare(run)
    assert run.records == [] and run.seconds == 7.5
    assert run.parts["warmup"] > 0
    assert os.path.isdir(run.state["outpath"])


def test_the_scene_is_reflectance_by_the_rule(small_spec):
    """Every band is (DN - 1000) / 10000 rounded once to float32, from the
    DNs of the uint16 configuration's landscape and seed."""
    from gpubench import common
    run = bench.Run(small_spec, CELL, 5, 0, 0, "cpu")
    dn = common.scene(run)
    refl = run.job.reflectance(run, dn)
    want = ((dn.numpy().astype(np.float64) - 1000) / 10000).astype(
        np.float32)
    assert refl.dtype == torch.float32
    np.testing.assert_array_equal(refl.numpy(), want)


def test_float_fit_is_exact_and_repeats(small_spec):
    from gpubench import common
    run = bench.Run(small_spec, CELL, 2 ** 31 + 1, 0, 0, "cpu")
    img = run.job.reflectance(run, common.scene(run))
    args = ([1, 2, 3], -9999.0, 20, 5000, 8, run.seed)
    a = run.job.fit_centres(img, *args)
    b = run.job.fit_centres(img, *args)
    assert a.dtype == np.float32 and a.shape == (20, 3)
    assert np.array_equal(a, b)
    # values of 2 or more, and values below the grid's reach
    for off in (img + 2.0, img * 1e-6):
        with pytest.raises(ValueError):
            run.job.fit_centres(off, *args)


def _reader(name):
    return bench.Spec().metric_reader(name).read


def _run(kernels, records=3):
    return types.SimpleNamespace(records=[{}] * records,
                                 trace={"kernels": kernels})


def test_ordered_sum_readers(monkeypatch):
    t = timinghooks.Timers()
    monkeypatch.setattr(timinghooks, "TRACE", t)
    nbytes = 3.35e9
    t.count("ordered_sum.bytes", nbytes)
    kernels = {"(anonymous namespace)::ordered_sum_kernel(long long const*,"
               " ...)": [200, 0.004],
               "(anonymous namespace)::merge_movers_kernel(...)": [199, 1.0],
               "lut_direct": [5, 2.0]}
    got = _reader("ordered_sum_roofline")(_run(kernels))
    assert got == pytest.approx(roofline.roofline_pct(nbytes, 0.004))
    assert got == pytest.approx(25.0)
    assert _reader("ordered_sum_s.f32")(_run(kernels)) == pytest.approx(
        0.004 / 3)
    for name in ("ordered_sum_roofline", "ordered_sum_s.f32"):
        assert _reader(name)(_run({"lut_direct": [1, 1.0]})) is None


@pytest.mark.parametrize("name", ["ordered_sum_roofline",
                                  "ordered_sum_s.f32"])
def test_ordered_sum_readers_silent_without_the_kernel(monkeypatch, name):
    """A program without K4 (the commit before it) reads None."""
    monkeypatch.delattr(timinghooks, "TRACE")
    assert _reader(name)(_run({"lut_direct": [1, 1.0]})) is None
    assert _reader(name)(types.SimpleNamespace(records=[], trace=None)) \
        is None


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False here)")
    return "cuda"


@pytest.mark.cuda
def test_float_cell_on_the_card(small_spec, card):
    res = bench.run_cell(small_spec, CELL, 2 ** 31 + 5, 0.5, 1, card)
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
    assert 0 < res["metrics"]["ordered_sum_roofline"]["value"] <= 100
    assert res["metrics"]["ordered_sum_s.f32"]["value"] > 0


@pytest.mark.cuda
def test_float_control_on_the_card(small_spec, card, tmp_path):
    run = bench.Run(small_spec, CELL, 31, 0, 0, card)
    run.workdir = str(tmp_path)
    run.job.prepare(run)
    checks = control.control_checks(run)
    assert not bench.correct(checks), checks
