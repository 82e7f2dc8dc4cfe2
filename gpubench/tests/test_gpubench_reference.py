"""The comparison that decides ``correct``: the reference agrees with the
port's CPU path on small scenes; the control (the reference one
precision below) and planted faults of the timed path come out as not
correct."""

import numpy as np
import pytest
import torch

from gpubench import bench, control

CELLS = ["s2-cropland.segment", "landsat-rangeland.segment",
         "s2-cropland.stats", "s2-cropland.tile"]


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_the_port_on_the_cpu(small_spec, cell):
    res = bench.run_cell(small_spec, cell, 2 ** 31 + 99, 0.01, 0, "cpu")
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {m["name"]
                                   for m in small_spec.end_to_end(cell)}
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert all(c["value"] == 0 for c in res["checks"].values())


def test_reference_tile_equals_the_port_at_512():
    """One 512^2 tile of 4 bands: labels and every count equal."""
    from pyshepseg_tpu_torch import shepseg
    from pyshepseg_tpu_torch.ops.kmeans import TorchKMeans
    from gpubench.reference import segment as rseg
    rng = np.random.default_rng(4)
    cells = rng.integers(0, 300, (32, 32)).repeat(16, 0).repeat(16, 1)
    img = (rng.integers(500, 4000, (300, 4))[cells].transpose(2, 0, 1) +
           rng.normal(0, 60, (4, 512, 512))).clip(1, 65535).astype(np.uint16)
    centres = img.reshape(4, -1)[:, rng.choice(512 * 512, 60, False)].T
    centres = centres.astype(np.float32)
    km = TorchKMeans.from_arrays(centres, device="cpu")
    got = shepseg.doShepherdSegmentation(
        img, minSegmentSize=100, maxSpectralDiff="auto", imgNullVal=0,
        kmeansObj=km, device="cpu")
    want, counts = rseg.segment_tile(
        torch.from_numpy(img.astype(np.int32)), torch.from_numpy(centres), 0,
        100, rseg.max_spectral_diff(centres))
    assert np.array_equal(got.segimg, want.numpy().astype(np.uint32))
    assert counts["singlePixelsEliminated"] == got.singlePixelsEliminated
    assert counts["smallSegmentsEliminated"] == got.smallSegmentsEliminated
    assert counts["elimPasses"] == got.elimPasses
    assert counts["maxSegId"] == int(got.segimg.max())


@pytest.mark.parametrize("cell", CELLS)
def test_control_comes_out_not_correct(small_spec, cell, tmp_path):
    run = bench.Run(small_spec, cell, 17, 0, 0, "cpu")
    run.workdir = str(tmp_path)
    run.job.prepare(run)
    checks = control.control_checks(run)
    assert not bench.correct(checks), checks


def _elimination_skipped(monkeypatch):
    from pyshepseg_tpu_torch import shepseg

    def unchanged(ea, eb, size, spect, min_size, max_diff, remap_init=None):
        return remap_init.long(), size, 0, 0
    monkeypatch.setattr(shepseg, "eliminate_small_segments_graph", unchanged)


def _half_the_tiles(monkeypatch):
    from pyshepseg_tpu_torch import shepseg
    real = shepseg.doShepherdSegmentation
    calls = []

    def half(*args, **kwargs):
        res = real(*args, **kwargs)
        calls.append(1)
        if len(calls) % 2 == 0:
            res.segimg = np.zeros_like(res.segimg)
        return res
    monkeypatch.setattr(shepseg, "doShepherdSegmentation", half)


def _one_label_altered(monkeypatch):
    from pyshepseg_tpu_torch import shepseg
    real = shepseg.doShepherdSegmentation

    def altered(*args, **kwargs):
        res = real(*args, **kwargs)
        res.segimg = res.segimg.copy()
        res.segimg[5, 7] += 1
        return res
    monkeypatch.setattr(shepseg, "doShepherdSegmentation", altered)


def _table_left_unwritten(monkeypatch):
    from pyshepseg_tpu_torch import tilingstats
    monkeypatch.setattr(tilingstats, "writeCompletePages",
                        lambda pagedRat, attrTbl, sel: pagedRat.clear())


def _half_the_pixels(monkeypatch):
    from pyshepseg_tpu_torch import tilingstats
    real = tilingstats.compactTile

    def half(tileSegments, tileImageData, *args, **kwargs):
        # the statistics over the first half of the window's rows, every
        # pixel still counted as seen
        seen, nodata = real(tileSegments, tileImageData, *args,
                            **kwargs)[:2]
        seg = tileSegments.copy()
        seg[seg.shape[0] // 2:] = 0
        return (seen, nodata) + real(seg, tileImageData, *args,
                                     **kwargs)[2:]
    monkeypatch.setattr(tilingstats, "compactTile", half)


def _one_value_altered(monkeypatch):
    from pyshepseg_tpu_torch import tilingstats
    real = tilingstats._segmentStatsFromRuns

    def altered(*args, **kwargs):
        out = real(*args, **kwargs)
        if len(out):
            out[0] += 1
        return out
    monkeypatch.setattr(tilingstats, "_segmentStatsFromRuns", altered)


SEGMENT_FAULTS = [_elimination_skipped, _half_the_tiles, _one_label_altered]
STATS_FAULTS = [_table_left_unwritten, _half_the_pixels, _one_value_altered]


@pytest.mark.parametrize("cell,fault", [
    (cell, fault) for cell in CELLS if "stats" not in cell
    for fault in SEGMENT_FAULTS] + [
    ("s2-cropland.stats", fault) for fault in STATS_FAULTS],
    ids=lambda x: x if isinstance(x, str) else x.__name__.strip("_"))
def test_a_broken_timed_path_is_not_correct(small_spec, cell, fault,
                                            monkeypatch):
    """The run's own check, with the harness's look for a card skipped,
    sees each fault the cell can have: a step returning its state
    unchanged, half of the work left out, one answer altered where it is
    produced. (No cell spans chips, so none can drop an exchange.)"""
    fault(monkeypatch)
    res = bench.run_cell(small_spec, cell, 23, 0.01, 0, "cpu")
    assert not res["correct"], res["checks"]
