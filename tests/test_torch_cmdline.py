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


def test_tiling_cli_mesh_not_ported(scene, tmp_path, monkeypatch):
    with pytest.raises(NotImplementedError, match="CONC_MESH"):
        run_cli(monkeypatch, tiling_cli, [
            "-i", scene, "-o", str(tmp_path / "o.npseg"), "--device", "cpu",
            "--concurrencytype", "CONC_MESH"] + SEG_ARGS)
