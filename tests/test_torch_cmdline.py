"""The port's tiling and variograms command lines (``--device cpu``)
against the JAX package's, through their real argv parsers on the same
small scene: the segment raster, the Histogram and every stats column must
be equal bit for bit (the colour columns too, where they come from the
band means), the variogram columns within float32 rounding of the same
float64 numpy sums (equal here)."""

import sys

import numpy as np
import pytest

from pyshepseg_tpu import io as rio
from pyshepseg_tpu.cmdline import tiling as jax_tiling_cli
from pyshepseg_tpu.cmdline import variograms as jax_variograms
from pyshepseg_tpu_torch.cmdline import tiling as tiling_cli
from pyshepseg_tpu_torch.cmdline import variograms
from test_tiling import make_voronoi_raster
import torch_parity  # noqa: F401  (one torch thread)

# the scene of tests/test_cmdline.py; its palette is colinear and well
# separated, so the fixed k-means init converges to it in both packages
# with no float32 score tie
SEG_ARGS = ["-n", "20", "-b", "1,2,3", "-s", "10", "-m", "30",
            "--fixedkmeansinit", "-t", "64", "-l", "16"]


def run_cli(monkeypatch, module, argv):
    monkeypatch.setattr(sys, "argv", [module.__name__] + argv)
    module.mainCmd()


def rat_of(path):
    band = rio.open(path).GetRasterBand(1)
    rat = band.GetDefaultRAT()
    names = [rat.GetNameOfCol(i) for i in range(rat.GetColumnCount())]
    return band.ReadAsArray(), {n: rat.ReadAsArray(i)
                                for i, n in enumerate(names)}


@pytest.fixture
def scene(tmp_path):
    inpath = str(tmp_path / "in.npseg")
    make_voronoi_raster(inpath, np.random.default_rng(42), nodata=65535)
    return inpath


@pytest.mark.parametrize("colours", [False, True])
def test_tiling_cli_matches_jax(scene, tmp_path, monkeypatch, colours):
    stats = ["--statsbands", "1,2,3", "--statspec", "mean",
             "--statspec", "stddev", "--statspec", "percentile,50",
             "--statspec", "min", "--statspec", "mode"]
    if colours:
        stats += ["--colortablebands", "1,2,3"]
    got, want = str(tmp_path / "got.npseg"), str(tmp_path / "want.npseg")
    run_cli(monkeypatch, tiling_cli, ["-i", scene, "-o", got] + SEG_ARGS +
            stats + ["--device", "cpu", "--statsengine", "device"])
    run_cli(monkeypatch, jax_tiling_cli, ["-i", scene, "-o", want] +
            SEG_ARGS + stats + ["--statsengine", "host"])
    seg, cols = rat_of(got)
    wseg, wcols = rat_of(want)
    np.testing.assert_array_equal(seg, wseg)
    assert seg.max() > 1
    stat_cols = ["Band_%d_%s" % (b, s) for b in (1, 2, 3)
                 for s in ("mean", "stddev", "pcnt50", "min", "mode")]
    compared = ["Histogram"] + stat_cols
    if colours:
        compared += ["Red", "Green", "Blue", "Alpha"]
    for name in compared:
        np.testing.assert_array_equal(cols[name], wcols[name], err_msg=name)
    # random colours without --colortablebands, in both packages
    assert {"Red", "Green", "Blue", "Alpha"} <= set(cols)


def test_variograms_cli_matches_jax(scene, tmp_path, monkeypatch):
    seg = str(tmp_path / "seg.npseg")
    run_cli(monkeypatch, tiling_cli, ["-i", scene, "-o", seg] + SEG_ARGS +
            ["--device", "cpu"])
    wseg = str(tmp_path / "wseg.npseg")
    import shutil
    shutil.copytree(seg, wseg)
    run_cli(monkeypatch, variograms, ["-i", scene, "-s", seg, "-n", "2",
                                      "--device", "cpu"])
    run_cli(monkeypatch, jax_variograms, ["-i", scene, "-s", wseg, "-n",
                                          "2"])
    _, cols = rat_of(seg)
    _, wcols = rat_of(wseg)
    for name in ("variogram1", "variogram2"):
        np.testing.assert_array_equal(cols[name], wcols[name])
    assert np.isfinite(cols["variogram1"][1:]).all()


@pytest.fixture
def run_seg_output(scene, tmp_path, monkeypatch):
    """tests/test_cmdline.py's subset input: the scene segmented by the
    port's run_seg CLI (on the CPU)."""
    from pyshepseg_tpu_torch.cmdline import run_seg
    segpath = str(tmp_path / "seg.npseg")
    run_cli(monkeypatch, run_seg, [
        "-i", scene, "-o", segpath, "-n", "20", "-b", "1,2,3", "-s", "10",
        "-m", "30", "-c", "10", "--fixedkmeansinit", "--device", "cpu"])
    return segpath


@pytest.mark.parametrize("window", [
    ["--srcwin", "20", "30", "64", "48", "--origsegidcol", "orig"],
    ["--srcwin", "10", "10", "32", "32"],
    # geotransform (0, 10, 0, 0, 0, -10): pixel (10, 10) -> (100, -100)
    ["--projwin", "100", "-100", "420", "-420"],
    ["--mask"]])
def test_subset_cli_matches_jax(run_seg_output, tmp_path, monkeypatch,
                                window):
    """The subset CLI by pixel window, projected window and mask: raster
    and every RAT column equal to the JAX CLI's."""
    from pyshepseg_tpu.cmdline import subset as jax_subset_cli
    from pyshepseg_tpu_torch.cmdline import subset as subset_cli
    if window == ["--mask"]:
        # a 64 x 48 mask on the segmentation's grid at pixel (20, 30)
        mask = str(tmp_path / "mask.npseg")
        ds = rio.create(mask, 64, 48, 1, np.uint8)
        ds.SetGeoTransform((200.0, 10.0, 0.0, -300.0, 0.0, -10.0))
        ds.SetProjection("FAKE_PROJ")
        ds.GetRasterBand(1).WriteArray(
            (np.random.default_rng(3).random((48, 64)) < 0.7).astype(
                np.uint8))
        ds.FlushCache()
        window = ["--mask", mask, "--origsegidcol", "orig"]
    got, want = str(tmp_path / "got.npseg"), str(tmp_path / "want.npseg")
    run_cli(monkeypatch, subset_cli,
            ["-i", run_seg_output, "-o", got] + window)
    run_cli(monkeypatch, jax_subset_cli,
            ["-i", run_seg_output, "-o", want] + window)
    sub, cols = rat_of(got)
    wsub, wcols = rat_of(want)
    np.testing.assert_array_equal(sub, wsub)
    assert sub.max() >= 1 and list(cols) == list(wcols)
    for name in cols:
        np.testing.assert_array_equal(cols[name], wcols[name], err_msg=name)
    assert (tuple(rio.open(got).GetGeoTransform()) ==
            tuple(rio.open(want).GetGeoTransform()))
    if "orig" in cols:
        full = rio.open(run_seg_output).GetRasterBand(1).ReadAsArray()
        nz = sub != 0
        assert (cols["orig"][sub[nz]] == full[30:78, 20:84][nz]).all()


def test_runtests_cli_on_cpu(tmp_path, monkeypatch, capsys):
    """The golden end-to-end check at a small size on the CPU: every
    oracle holds."""
    from pyshepseg_tpu_torch.cmdline import runtests
    with pytest.raises(SystemExit) as exit_info:
        run_cli(monkeypatch, runtests, [
            "-d", str(tmp_path), "--device", "cpu", "--size", "160",
            "--ncentres", "12", "--tilesize", "96", "--overlapsize", "24"])
    out = capsys.readouterr().out
    assert exit_info.value.code == 0, out
    assert out.strip().splitlines()[-1] == "All tests passed"
    for line in ("Spectral match: 100.0000%", "Spatial stats ok: True",
                 "Streaming spatial routes ok: True", "Subset ok: True"):
        assert line in out, out


def test_tiling_cli_mesh_not_ported(scene, tmp_path, monkeypatch):
    with pytest.raises(NotImplementedError, match="CONC_MESH"):
        run_cli(monkeypatch, tiling_cli, [
            "-i", scene, "-o", str(tmp_path / "o.npseg"), "--device", "cpu",
            "--concurrencytype", "CONC_MESH"] + SEG_ARGS)
