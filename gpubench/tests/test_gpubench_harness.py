"""The harness's arithmetic and its data-driven lookup: the window and
the rate, p95 with its count, the profiler's busy-interval union, K1's
bytes, a cell, mix and metric found by name from new files alone, and
the import guard."""

import ast
import glob
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from gpubench import bench, common, devtrace as trace, roofline
from gpubench.bench import CHECKOUT


class FakeTimers:
    def makeSummaryDict(self):
        return {"stitchtiles": {"total": 0.5}, "stitchwait": {"total": 0.2},
                "stitchfinalize": {"total": 0.1},
                "segmentation": {"total": 1.5}}


class FakeResult:
    timings = FakeTimers()
    maxSegId = 7


def test_window_counts_whole_scenes_over_all_time(small_spec, monkeypatch,
                                                  capsys):
    from pyshepseg_tpu_torch import tiling
    from gpubench.reference import npseg
    scene_s = 0.05

    def fake_scene(*args, **kwargs):
        time.sleep(scene_s)
        return FakeResult()

    monkeypatch.setattr(tiling, "doTiledShepherdSegmentation", fake_scene)
    monkeypatch.setattr(npseg, "histogram", lambda path: np.zeros(8))
    run = bench.Run(small_spec, "s2-cropland.segment", 1, 0.12, 0, "cpu")
    run.state.update(inpath="in", outpath="out", km=None)
    t0 = time.perf_counter()
    e2e = run.job.measure(run)
    elapsed = time.perf_counter() - t0
    # the window ends with the first scene that finishes after 0.12 s
    assert len(run.records) == 3
    npix = 320 * 320
    rate = e2e["scene_mpix_s"]
    # all the pixels of all the scenes over the whole elapsed time
    assert 3 * npix / 1e6 / elapsed <= rate <= 3 * npix / 1e6 / (3 * scene_s)
    # one line a scene with its wall and its main Timers totals
    lines = [ln for ln in capsys.readouterr().err.splitlines()
             if ln.startswith("scene ")]
    assert len(lines) == 3
    assert all("segmentation 1.500" in ln and "stitchfinalize 0.100" in ln
               and "cpu_s" in ln for ln in lines)
    reader = small_spec.metric_reader("stitch_s.scene")
    assert reader.read(run) == pytest.approx(0.4)
    assert small_spec.metric_reader("tile_worker_s.scene").read(
        run) == pytest.approx(1.5)


@pytest.mark.parametrize("n,want", [(1, 1), (19, 19), (20, 19), (21, 20),
                                    (100, 95), (101, 96)])
def test_p95_nearest_rank(n, want):
    values = list(range(1, n + 1))
    np.random.default_rng(n).shuffle(values)
    assert common.p95(values) == want


def test_tile_window_reports_p95_and_count(small_spec, monkeypatch, capsys):
    walls = iter([0.01, 0.03, 0.02, 0.05, 0.04] * 10)

    class Res:
        segimg = np.ones((4, 4), np.uint32)
        singlePixelsEliminated = smallSegmentsEliminated = elimPasses = 0

    def fake_one(run, tile, km):
        time.sleep(next(walls))
        return Res()

    monkeypatch.setattr(common, "segment_one", fake_one)
    run = bench.Run(small_spec, "s2-cropland.tile", 1, 0.1, 0, "cpu")
    run.state.update(tiles=[None] * 3, km=None)
    e2e = run.job.measure(run)
    walls_seen = [r["wall"] for r in run.records]
    assert e2e["tile_s_p95"] == common.p95(walls_seen)
    # the window is whole cycles over every tile: the first that ends
    # after 0.1 s (0.06 s a cycle here)
    assert len(walls_seen) == 6
    assert "tile calls 6 (2 cycles of 3 tiles) " in capsys.readouterr().err
    assert [r["tile"] for r in run.records] == [
        i % 3 for i in range(len(walls_seen))]


def test_busy_union_and_breakdown():
    assert trace.union_seconds([(0, 1), (0.5, 2), (3, 4), (3.5, 3.6)]) == 3
    assert trace.union_seconds([]) == 0
    evs = [("k1", True, 1.0, 2.0), ("k2", True, 1.0, 3.0),
           ("k1", True, 6.0, 6.5), ("aten::sort", False, 3.2, 5.9),
           ("aten::item", False, 4.0, 4.8), ("gpubench.tile", False, 0, 10)]
    s = trace.summarize(evs, 0.0, 10.0)
    assert s["busy_s"] == pytest.approx(2.5)
    assert s["kernels"]["k1"] == [2, pytest.approx(1.5)]
    gaps = s["breakdown"]["idle_gaps"]
    # longest first, each by the innermost host op over its middle
    assert gaps[0] == ["gpubench.tile", pytest.approx(3.5)]
    assert gaps[1] == ["aten::item", pytest.approx(3.0)]
    assert [g[1] for g in gaps] == sorted((g[1] for g in gaps), reverse=True)
    assert sum(g[1] for g in gaps) == pytest.approx(10.0 - 2.5)
    assert s["breakdown"]["device_ops"][0][0] == "k2"


def test_k1_bytes_and_roofline():
    assert roofline.local_ccl_bytes(4096, 4096) == 8 * 4096 * 4096
    nbytes = roofline.local_ccl_bytes(4096, 4096)
    assert roofline.roofline_pct(nbytes, nbytes / 3.35e12) == pytest.approx(
        100.0)


def test_new_cell_mix_and_metric_are_found_by_name(small_root):
    """A later change adds a cell, a mix and a metric as new files and
    BENCHMARK.json entries only."""
    bdir = os.path.join(small_root, "gpubench")
    with open(os.path.join(bdir, "traffic", "cropland.tile.json")) as f:
        mix = json.load(f)
    mix["name"] = "rangeland.tile"
    mix["landscape"] = "rangeland"
    with open(os.path.join(bdir, "traffic", "rangeland.tile.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(bdir, "metrics", "calls.tile.py"), "w") as f:
        f.write("def read(run):\n    return len(run.records)\n")
    path = os.path.join(small_root, "BENCHMARK.json")
    with open(path) as f:
        spec = json.load(f)
    spec["workloads"].append({"name": "landsat-rangeland.tile",
                              "config": "landsat-c2l2-30m",
                              "traffic": "rangeland.tile", "chips": 1,
                              "why": "test"})
    for m in spec["end_to_end"]:
        if m["name"] == "tile_s_p95":
            m["workloads"].append("landsat-rangeland.tile")
    spec["per_layer"].append({"name": "calls.tile", "unit": "count",
                              "better": "higher", "source": "host_clock",
                              "layer": "test", "moves": "tile_s_p95",
                              "workloads": ["landsat-rangeland.tile"]})
    with open(path, "w") as f:
        json.dump(spec, f)
    s = bench.Spec(small_root)
    res = bench.run_cell(s, "landsat-rangeland.tile", 5, 0.05, 1, "cpu")
    assert res["correct"]
    # only the metrics that list the new cell
    assert set(res["metrics"]) == {"calls.tile"}
    assert res["metrics"]["calls.tile"]["value"] == res["attempted"] >= 1
    res = bench.run_cell(s, "landsat-rangeland.tile", 5, 0.05, 0, "cpu")
    assert set(res["metrics"]) == {"tile_s_p95", "setup_s"}
    assert list(res)[-1] == "checks"


def test_benchmark_json_is_consistent():
    spec = bench.Spec(CHECKOUT)
    data = spec.data
    assert set(data) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    names = [m["name"] for m in data["end_to_end"] + data["per_layer"]]
    assert len(names) == len(set(names))
    for cell in data["workloads"]:
        run = bench.Run(spec, cell["name"], 1, 0, 0, "cpu")
        assert hasattr(run.job, "verify") and hasattr(run.job, "control")
        e2e = {m["name"] for m in spec.end_to_end(cell["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        layers = spec.per_layer(cell["name"])
        assert layers and all(m["moves"] in e2e for m in layers)
        for m in layers:
            assert callable(spec.metric_reader(m["name"]).read)
    for cfg in data["configs"]:
        assert cfg["reduced"] == spec.config(cfg["name"])["reduced"] == []


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "pyshepseg_tpu_torch_fake", sys)
    assert bench.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    monkeypatch.setitem(sys.modules, "pyshepseg_tpu.tiling", sys)
    assert bench.forbidden_modules() == ["jax", "pyshepseg_tpu"]


def test_reference_loads_nothing_of_the_program():
    files = glob.glob(os.path.join(CHECKOUT, "gpubench", "reference",
                                   "*.py"))
    assert files
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                tops = [(node.module or "").split(".")[0]]
            else:
                continue
            assert not set(tops) & {"pyshepseg_tpu_torch", "pyshepseg_tpu",
                                    "jax", "gpubench"}, (path, tops)
    code = ("import sys; sys.path.insert(0, %r); "
            "import gpubench.reference.segment, gpubench.reference.stitch, "
            "gpubench.reference.stats, gpubench.reference.npseg; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('pyshepseg_tpu_torch', 'pyshepseg_tpu', 'jax')]; "
            "print(bad); sys.exit(1 if bad else 0)" % CHECKOUT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_a_run_loads_no_jax(small_root):
    """A whole run in a fresh interpreter with JAX importable raising:
    nothing loads it, and the guard finds nothing."""
    fake = os.path.join(small_root, "fakejax")
    for name in ("jax", "pyshepseg_tpu"):
        os.makedirs(os.path.join(fake, name))
        with open(os.path.join(fake, name, "__init__.py"), "w") as f:
            f.write("raise ImportError('%s must not be imported')\n" % name)
    code = ("import sys; sys.path[:0] = [%r, %r]; "
            "from gpubench import bench; "
            "r = bench.run_cell(bench.Spec(%r), 's2-cropland.tile', 3, 0.01,"
            " 0, 'cpu'); print(r['correct'], bench.forbidden_modules())"
            % (fake, CHECKOUT, small_root))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split("\n")[-2] == "True []"


def _metric_that_loads(root, module):
    """A traced cell whose one per-layer metric reader, defined only in
    files under ``root``, imports ``module``; returns the cell's name."""
    bdir = os.path.join(root, "gpubench")
    with open(os.path.join(bdir, "metrics", "loads.tile.py"), "w") as f:
        f.write("def read(run):\n    import %s\n    return 1.0\n" % module)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        spec = json.load(f)
    spec["per_layer"] = [{"name": "loads.tile", "unit": "count",
                          "better": "lower", "source": "program_counter",
                          "layer": "test", "moves": "tile_s_p95",
                          "workloads": ["s2-cropland.tile"]}]
    with open(path, "w") as f:
        json.dump(spec, f)
    return "s2-cropland.tile"


def test_guard_runs_after_the_metric_readers(small_root, monkeypatch):
    """A per-layer reader that loads JAX after the window has closed
    fails the run in process, and in a fresh interpreter the run exits
    non-zero with no result line."""
    fake = os.path.join(small_root, "fakejax")
    os.makedirs(os.path.join(fake, "jax"))
    with open(os.path.join(fake, "jax", "__init__.py"), "w") as f:
        f.write("")
    cell = _metric_that_loads(small_root, "jax")
    monkeypatch.syspath_prepend(fake)
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    with pytest.raises(RuntimeError, match="forbidden modules loaded: jax"):
        bench.run_cell(bench.Spec(small_root), cell, 3, 0.01, 1, "cpu")
    sys.modules.pop("jax", None)
    code = ("import sys; sys.path[:0] = [%r, %r]; "
            "from gpubench import bench; "
            "bench.print_result(bench.run_cell(bench.Spec(%r), %r, 3, 0.01,"
            " 1, 'cpu'))" % (fake, CHECKOUT, small_root, cell))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert "forbidden modules loaded: jax" in out.stderr
    assert '"correct"' not in out.stdout


def test_run_refuses_without_a_card(monkeypatch, capsys):
    import torch
    from gpubench import run as entry
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = entry.main(["--workload", "s2-cropland.tile", "--seed", "1",
                     "--seconds", "1"])
    assert rc != 0
    assert capsys.readouterr().out == ""
