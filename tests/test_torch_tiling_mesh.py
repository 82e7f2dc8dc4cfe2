"""The port's CONC_MESH backend (parallel/mesh) over a list of two CPU
devices: the cases of tests/test_tiling_mesh.py (plain, tilesPerDevice 2
and 3, nodata, the grown grid), each against the port's CONC_NONE run and
against the JAX package's CONC_MESH run on the same raster with the same
centres: output band, maxSegId and RAT histogram equal bit for bit. Then
the tiling command line with ``--concurrencytype CONC_MESH``, and the batch
function and its per-device thread runner on their own."""

import sys
import threading

import numpy as np
import pytest
import torch

from pyshepseg_tpu import tiling as jax_tiling
from pyshepseg_tpu_torch import tiling
from pyshepseg_tpu_torch.cmdline import tiling as tiling_cli
from pyshepseg_tpu_torch.parallel import mesh, pipeline
from test_shardmap_seg import make_image
from test_tiling import make_voronoi_raster, perfect_kmeans
from test_torch_tiling import RUN, make_raster, torch_kmeans
from torch_parity import read_output, to_np

# case -> (raster options, driver options, tilesPerDevice)
CASES = {
    "plain": (dict(), dict(), 1),
    "tpd2": (dict(), dict(), 2),
    "tpd3": (dict(), dict(), 3),
    "nodata": (dict(nodata=0), dict(imgNullVal=0), 1),
    "grow_tpd2": (dict(shape=(130, 100)), dict(tileGrid='grow'), 2),
}


@pytest.fixture
def cpu_mesh(monkeypatch):
    monkeypatch.setattr(mesh.SegMeshMgr, "meshDevices", ["cpu", "cpu"])


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request, tmp_path_factory):
    """One case through the port's CONC_NONE, the port's CONC_MESH over
    two CPU devices and the JAX package's CONC_MESH."""
    rasterOpts, driverOpts, tpd = CASES[request.param]
    tmp = tmp_path_factory.mktemp(request.param)
    inpath = str(tmp / "in.npseg")
    if "shape" in rasterOpts:
        make_voronoi_raster(inpath, np.random.default_rng(42), **rasterOpts)
    else:
        make_raster(inpath, 42, **rasterOpts)
    kw = dict(RUN, **driverOpts)
    runs = {}
    mp = pytest.MonkeyPatch()
    mp.setattr(mesh.SegMeshMgr, "meshDevices", ["cpu", "cpu"])
    try:
        for name, mod, km, extra in [
                ("serial", tiling, torch_kmeans(), dict(device="cpu")),
                ("mesh", tiling, torch_kmeans(), dict(
                    device="cpu",
                    concurrencyCfg=tiling.SegmentationConcurrencyConfig(
                        concurrencyType=tiling.CONC_MESH,
                        tilesPerDevice=tpd))),
                ("jax_mesh", jax_tiling, perfect_kmeans(), dict(
                    concurrencyCfg=jax_tiling.SegmentationConcurrencyConfig(
                        concurrencyType=jax_tiling.CONC_MESH,
                        tilesPerDevice=tpd)))]:
            out = str(tmp / (name + ".npseg"))
            res = mod.doTiledShepherdSegmentation(
                inpath, out, kmeansObj=km, **dict(kw, **extra))
            runs[name] = (res, read_output(out))
    finally:
        mp.undo()
    return dict(name=request.param, **runs)


@pytest.mark.parametrize("other", ["serial", "jax_mesh"])
def test_mesh_output_band_matches(case, other):
    seg = case["mesh"][1][0]
    np.testing.assert_array_equal(seg, case[other][1][0])
    assert seg.dtype == np.uint32 and seg.max() > 1
    if case["name"] == "nodata":
        assert (seg[40:60, 50:80] == 0).all()


@pytest.mark.parametrize("other", ["serial", "jax_mesh"])
def test_mesh_max_seg_id_matches(case, other):
    got, want = case["mesh"][0], case[other][0]
    assert got.maxSegId == want.maxSegId == case["mesh"][1][0].max()
    assert got.hasEmptySegments == want.hasEmptySegments
    assert (got.numTileRows, got.numTileCols) == (want.numTileRows,
                                                  want.numTileCols)
    assert got.maxSpectralDiff == want.maxSpectralDiff


@pytest.mark.parametrize("other", ["serial", "jax_mesh"])
def test_mesh_histogram_matches(case, other):
    np.testing.assert_array_equal(case["mesh"][1][1], case[other][1][1])


def test_mesh_timings_and_temp_files(case):
    summary = case["mesh"][0].timings.makeSummaryDict()
    for name in ("reading", "segmentation", "stitchtiles", "walltime"):
        assert name in summary


def test_mesh_deals_contiguous_runs_to_devices(tmp_path, monkeypatch,
                                               cpu_mesh):
    """Chunks are nDev * tilesPerDevice tiles in row-major order, the last
    one short and not padded; the scene cache feeds them."""
    inpath = str(tmp_path / "in.npseg")
    make_raster(inpath, 42)
    seen = []
    batch_fn = mesh.segment_tile_batch

    def spy(batch, *args, **kwargs):
        seen.append([tuple(t.shape) for t in batch])
        assert all(isinstance(t, torch.Tensor) and t.dtype == torch.uint16
                   for t in batch)
        return batch_fn(batch, *args, **kwargs)

    monkeypatch.setattr(mesh, "segment_tile_batch", spy)
    cfg = tiling.SegmentationConcurrencyConfig(
        concurrencyType=tiling.CONC_MESH, tilesPerDevice=2,
        deviceSceneCache=True)
    res = tiling.doTiledShepherdSegmentation(
        inpath, str(tmp_path / "out.npseg"), kmeansObj=torch_kmeans(),
        device="cpu", concurrencyCfg=cfg, **RUN)
    ntiles = res.numTileRows * res.numTileCols
    assert [len(b) for b in seen] == [4] * (ntiles // 4) + (
        [ntiles % 4] if ntiles % 4 else [])
    assert all(shape == (3, 64, 64) for b in seen for shape in b)


def test_select_concurrency_class_finds_mesh():
    cls = tiling.selectConcurrencyClass(tiling.CONC_MESH,
                                        tiling.SegmentationConcurrencyMgr)
    assert cls is mesh.SegMeshMgr
    assert tiling.SegmentationConcurrencyConfig(
        tilesPerDevice=2).tilesPerDevice == 2


def test_mesh_default_devices(monkeypatch):
    mgr = mesh.SegMeshMgr.__new__(mesh.SegMeshMgr)
    mgr.device = torch.device("cpu")
    assert mgr._devices() == [torch.device("cpu")]
    mgr.meshDevices = ["cpu"] * 3
    assert mgr._devices() == [torch.device("cpu")] * 3
    if not torch.cuda.is_available():
        mgr.meshDevices = None
        mgr.device = torch.device("cuda")
        with pytest.raises(RuntimeError):
            mgr._devices()


def test_segment_tile_batch_matches_segment_tile():
    """The batch function on a list of CPU tiles: numpy (B, H, W) uint32,
    each tile equal to segment_tile's, and None for the buckets."""
    wide, centers = make_image(64, 144, 3, 30, np.random.default_rng(3),
                               nullval=9999, nullmargin=2)
    tiles = [torch.from_numpy(np.ascontiguousarray(
        wide[:, :, i * 48:(i + 1) * 48])) for i in range(3)]
    segs, buckets = mesh.segment_tile_batch(
        tiles, centers, 9999, 200.0, 8, False, True, segCapacity=4096,
        specBuckets=(1, 2, 3, 4, 5))
    assert buckets is None
    assert segs.shape == (3, 64, 48) and segs.dtype == np.uint32
    for tile, seg in zip(tiles, segs):
        want, _ = pipeline.segment_tile(tile, torch.from_numpy(centers),
                                        9999, 200.0, 8, False, True)
        np.testing.assert_array_equal(seg, to_np(want))


def test_run_shares_threads_and_errors():
    """More than one share: each runs in a thread of its own, all are
    joined, and a share's exception is raised in the caller."""
    ran = {}

    def run(device, indices):
        ran[device] = (threading.get_ident(), indices)

    mesh._runShares({"a": [0, 1], "b": [2]}, run)
    assert {k: v[1] for k, v in ran.items()} == {"a": [0, 1], "b": [2]}
    me = threading.get_ident()
    assert ran["a"][0] != me and ran["b"][0] != me
    mesh._runShares({"a": [0]}, run)
    assert ran["a"] == (me, [0])

    def boom(device, indices):
        if device == "b":
            raise RuntimeError("injected share failure")

    with pytest.raises(RuntimeError, match="injected share failure"):
        mesh._runShares({"a": [0], "b": [1]}, boom)


def test_tiling_cli_mesh_matches_serial(tmp_path, monkeypatch, cpu_mesh):
    inpath = str(tmp_path / "in.npseg")
    make_voronoi_raster(inpath, np.random.default_rng(42), nodata=65535)
    args = ["-n", "20", "-b", "1,2,3", "-s", "10", "-m", "30",
            "--fixedkmeansinit", "-t", "64", "-l", "16", "--device", "cpu"]
    outs = {}
    for name, extra in (("serial", []), ("mesh", [
            "--concurrencytype", "CONC_MESH", "--tilesperdevice", "2"])):
        out = str(tmp_path / (name + ".npseg"))
        monkeypatch.setattr(sys, "argv", ["tiling", "-i", inpath, "-o", out]
                            + args + extra)
        tiling_cli.mainCmd()
        outs[name] = read_output(out)
    np.testing.assert_array_equal(outs["mesh"][0], outs["serial"][0])
    np.testing.assert_array_equal(outs["mesh"][1], outs["serial"][1])
    assert outs["mesh"][0].max() > 1
