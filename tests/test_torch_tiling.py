"""The port's tiled driver against pyshepseg_tpu.tiling on the same .npseg
raster, with the same k-means centres (the exact test palette, as in
test_tiling.py): output band, maxSegId, hasEmptySegments and the RAT
histogram must be equal bit for bit. Also the 3-phase API, the tile grid
and the stitch primitives. Every output is an integer: the tolerance is
zero throughout."""

import numpy as np
import pytest
import torch

from pyshepseg_tpu import io as rio
from pyshepseg_tpu import tiling as jax_tiling
from pyshepseg_tpu_torch import tiling
from pyshepseg_tpu_torch.ops.kmeans import TorchKMeans
from test_tiling import make_voronoi_raster, perfect_kmeans
from torch_parity import read_output, voronoi_image, write_raster

RUN = dict(tileSize=64, overlapSize=16, minSegmentSize=10, numClusters=20,
           fourConnected=True, maxSpectralDiff=30.0)

# case -> (raster options, driver options)
CASES = {
    "uniform": ({}, {}),
    "grow": ({}, dict(tileGrid='grow')),
    "nodata": (dict(nodata=0), dict(imgNullVal=None)),
    "simple_recode": ({}, dict(simpleTileRecode=True)),
    "overlap0": ({}, dict(overlapSize=0)),
}


def torch_kmeans():
    """The centres of perfect_kmeans() as the port's k-means object."""
    return TorchKMeans.from_arrays(perfect_kmeans().cluster_centers_,
                                   device="cpu")


def make_raster(path, seed, nodata=None):
    """The 150x180 3-band Voronoi raster of test_tiling.py; with
    ``nodata`` a hole of null pixels is punched into every band."""
    make_voronoi_raster(path, np.random.default_rng(seed), nodata=nodata)
    if nodata is not None:
        ds = rio.open(path, rio.GA_Update)
        for b in range(1, ds.RasterCount + 1):
            band = ds.GetRasterBand(b)
            arr = band.ReadAsArray()
            arr[40:60, 50:80] = nodata
            band.WriteArray(arr)
        ds.FlushCache()


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request, tmp_path_factory):
    """One case run through both drivers (the JAX side once per case)."""
    rasterOpts, driverOpts = CASES[request.param]
    tmp = tmp_path_factory.mktemp(request.param)
    inpath = str(tmp / "in.npseg")
    make_raster(inpath, 42, **rasterOpts)
    kw = dict(RUN, **driverOpts)
    want = jax_tiling.doTiledShepherdSegmentation(
        inpath, str(tmp / "jax.npseg"), kmeansObj=perfect_kmeans(), **kw)
    got = tiling.doTiledShepherdSegmentation(
        inpath, str(tmp / "torch.npseg"), kmeansObj=torch_kmeans(),
        device="cpu", **kw)
    return dict(name=request.param, want=want,
                got=got, want_path=str(tmp / "jax.npseg"),
                got_path=str(tmp / "torch.npseg"),
                want_out=read_output(str(tmp / "jax.npseg")),
                got_out=read_output(str(tmp / "torch.npseg")))


def test_output_band_matches_jax(case):
    seg, _ = case["got_out"]
    np.testing.assert_array_equal(seg, case["want_out"][0])
    assert seg.dtype == np.uint32
    assert seg.max() > 0
    if case["name"] == "nodata":
        assert (seg[40:60, 50:80] == 0).all()


def test_max_seg_id_matches_jax(case):
    assert case["got"].maxSegId == case["want"].maxSegId
    assert case["got"].numTileRows == case["want"].numTileRows
    assert case["got"].numTileCols == case["want"].numTileCols


def test_has_empty_segments_matches_jax(case):
    assert case["got"].hasEmptySegments == case["want"].hasEmptySegments


def test_histogram_matches_jax(case):
    seg, hist = case["got_out"]
    np.testing.assert_array_equal(hist, case["want_out"][1])
    want = np.bincount(seg.ravel(), minlength=len(hist))
    want[0] = 0
    np.testing.assert_array_equal(hist, want[:len(hist)])


def test_calc_histogram_tiled_matches_jax(case):
    """The deprecated tile-wise histogram (updateCounts per 1024^2 block)
    of the port's output equals the JAX package's of its own."""
    got = tiling.calcHistogramTiled(case["got_path"], case["got"].maxSegId,
                                    writeToRat=False)
    want = jax_tiling.calcHistogramTiled(
        case["want_path"], case["want"].maxSegId, writeToRat=False)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, case["got_out"][1][:len(got)])


def test_three_phase_api_matches_monolithic(tmp_path):
    inpath = str(tmp_path / "in.npseg")
    make_raster(inpath, 42)
    res1 = tiling.doTiledShepherdSegmentation(
        inpath, str(tmp_path / "mono.npseg"), kmeansObj=torch_kmeans(),
        device="cpu", **RUN)
    seg1, hist1 = read_output(str(tmp_path / "mono.npseg"))

    (inDs, bandNumbers, kmeansObj, subsamplePcnt, imgNullVal, tileInfo) = (
        tiling.doTiledShepherdSegmentation_prepare(
            inpath, tileSize=64, overlapSize=16, numClusters=20,
            kmeansObj=torch_kmeans(), device="cpu"))
    tileFilenames = {}
    for (col, row) in sorted(tileInfo.tiles.keys()):
        fn = str(tmp_path / f"tile_{col}_{row}.npseg")
        tiling.doTiledShepherdSegmentation_doOne(
            inDs, fn, tileInfo, col, row, bandNumbers, imgNullVal,
            kmeansObj, minSegmentSize=10, maxSpectralDiff=30.0,
            device="cpu")
        tileFilenames[(col, row)] = fn
    out3 = str(tmp_path / "out3.npseg")
    (maxSegId, hasEmpty, outDs) = tiling.doTiledShepherdSegmentation_finalize(
        inDs, out3, tileFilenames, tileInfo, 16, str(tmp_path))
    seg3, hist3 = read_output(out3)
    np.testing.assert_array_equal(seg3, seg1)
    np.testing.assert_array_equal(hist3, hist1)
    assert maxSegId == res1.maxSegId
    assert hasEmpty == res1.hasEmptySegments


def test_three_phase_prepare_matches_jax(tmp_path):
    """_prepare's own whole-file k-means fit (fixed init, on the CPU) and
    grid, on a noisy raster whose seed holds no float32 score tie: at a
    tie the two packages may assign a point differently, and Lloyd's
    iterations then part (see test_torch_kmeans and ROADMAP.md)."""
    inpath = str(tmp_path / "in.npseg")
    img, _ = voronoi_image(np.random.default_rng(0), shape=(150, 180),
                           ncentres=8)
    write_raster(inpath, img)
    kw = dict(tileSize=48, overlapSize=16, numClusters=8,
              fixedKMeansInit=True, tileGrid='grow')
    got = tiling.doTiledShepherdSegmentation_prepare(inpath, device="cpu",
                                                     **kw)
    want = jax_tiling.doTiledShepherdSegmentation_prepare(inpath, **kw)
    assert list(got[1]) == list(want[1])
    np.testing.assert_allclose(got[2].cluster_centers_,
                               want[2].cluster_centers_, rtol=1e-4)
    assert got[3] == want[3] and got[4] == want[4]
    assert got[5].tiles == want[5].tiles


class FakeDs:
    def __init__(self, x, y):
        self.RasterXSize = x
        self.RasterYSize = y


@pytest.mark.parametrize("grid", ['uniform', 'grow'])
@pytest.mark.parametrize("size,tile,overlap", [
    ((100, 70), 40, 10), ((95, 40), 40, 10), ((25, 30), 40, 10),
    ((180, 150), 64, 16), ((128, 128), 64, 0), ((1000, 613), 256, 64),
    ((8000, 8000), 4096, 1024), ((257, 129), 64, 30)])
def test_tile_grid_matches_jax(size, tile, overlap, grid):
    ds = FakeDs(*size)
    got = tiling.getTilesForFile(ds, tile, overlap, tileGrid=grid)
    want = jax_tiling.getTilesForFile(ds, tile, overlap, tileGrid=grid)
    assert got.tiles == want.tiles
    assert (got.ncols, got.nrows) == (want.ncols, want.nrows)
    for (col, row) in got.tiles:
        if col > 0:
            assert (got.pairOverlap(col, row, 'left') ==
                    want.pairOverlap(col, row, 'left'))
        if row > 0:
            assert (got.pairOverlap(col, row, 'top') ==
                    want.pairOverlap(col, row, 'top'))


def test_tile_grid_rejects_bad_arguments():
    with pytest.raises(tiling.PyShepSegTilingError):
        tiling.getTilesForFile(FakeDs(100, 100), 40, 40)
    with pytest.raises(tiling.PyShepSegTilingError):
        tiling.getTilesForFile(FakeDs(100, 100), 40, 10, tileGrid='other')


@pytest.mark.parametrize("seed", range(6))
def test_stitch_primitives_match_jax(seed):
    """_segsCrossingMidline and _modeMatch on random strips, where a few
    ids make ties in the mode common, and B holds null pixels."""
    rng = np.random.default_rng(seed)
    shape = (16, 40) if seed % 2 else (40, 16)
    a = rng.integers(0, 6, size=shape).astype(np.uint32)
    b = rng.integers(0, 4, size=shape).astype(np.uint32)
    for orientation in (tiling.HORIZONTAL, tiling.VERTICAL):
        crossing = tiling._segsCrossingMidline(a, orientation)
        np.testing.assert_array_equal(
            crossing, jax_tiling._segsCrossingMidline(a, orientation))
        got = tiling._modeMatch(a, b, crossing)
        assert got == jax_tiling._modeMatch(a, b, crossing)
        assert 0 not in got.values()


@pytest.mark.parametrize("native", [True, False])
def test_relabel_segments_matches_jax(native, monkeypatch):
    """The stitch relabel (window-presence ownership, counter-advanced
    maxSegId, new-id window histogram) through the native C++ loops and
    through the numpy path, against the JAX package's."""
    rng = np.random.default_rng(5)
    tileData = rng.integers(0, 40, size=(96, 96)).astype(np.uint32)
    args = ({3: 1007, 7: 1003, 12: 1007}, 2000, 8, 88, 4, 92)
    want = jax_tiling.SegmentationConcurrencyMgr.relabelSegments(
        tileData.copy(), *args)
    if not native:
        monkeypatch.setattr(tiling.native, "stitch_mapping",
                            lambda *a, **k: None)
    got = tiling.SegmentationConcurrencyMgr.relabelSegments(
        tileData.copy(), *args)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] > 2000
    np.testing.assert_array_equal(got[2], want[2])


def test_crosses_midline_matches_vectorized():
    overlap = np.random.default_rng(2).integers(
        0, 9, size=(16, 24)).astype(np.uint32)
    for orientation in (tiling.HORIZONTAL, tiling.VERTICAL):
        crossing = set(tiling._segsCrossingMidline(overlap, orientation))
        for segId in range(1, 9):
            rowcols = np.argwhere(overlap == segId)
            if len(rowcols):
                got = tiling.SegmentationConcurrencyMgr.crossesMidline(
                    overlap, rowcols, orientation)
                assert bool(got) == (segId in crossing)


@pytest.mark.parametrize("size", [1024, 2048, 4096, 8000, 8192])
def test_overview_levels_match_jax(size):
    class DS:
        def BuildOverviews(self, meth, levels):
            pass

    levels = []
    for mod in (tiling, jax_tiling):
        mgr = mod.SegNoConcurrencyMgr.__new__(mod.SegNoConcurrencyMgr)
        mgr.inXsize = mgr.inYsize = size
        mgr.setupOverviews(DS())
        levels.append(mgr.overviewLevels)
    assert levels[0] == levels[1]


def test_mode_match_tie_goes_to_smallest():
    a = np.array([[7, 7, 7, 7, 7, 7]], dtype=np.uint32)
    b = np.array([[3, 3, 2, 2, 0, 0]], dtype=np.uint32)
    crossing = np.array([7], dtype=np.uint32)
    assert tiling._modeMatch(a, b, crossing) == {7: 2}
    assert jax_tiling._modeMatch(a, b, crossing) == {7: 2}
    # only null pixels under the segment: no identity, no entry
    assert tiling._modeMatch(a, np.zeros_like(b), crossing) == {}


def test_cuda_device_without_cuda_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    inpath = str(tmp_path / "in.npseg")
    make_raster(inpath, 1)
    with pytest.raises(RuntimeError):
        tiling.doTiledShepherdSegmentation(
            inpath, str(tmp_path / "out.npseg"), kmeansObj=torch_kmeans(),
            **RUN)
    with pytest.raises(RuntimeError):
        tiling.doTiledShepherdSegmentation_prepare(
            inpath, kmeansObj=torch_kmeans())
