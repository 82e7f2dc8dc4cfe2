"""The port's host-side compatibility surface against the JAX package's:
``clump(maxClumpSize=...)``, ``SegmentLocations``/``makeSegmentLocations``,
the six shepseg compat functions (on the inputs of
test_shepseg_compat.py), and the Timers self-tests. Every output is an
integer or an exact copy: the tolerance is zero."""

import unittest

import numpy as np
import pytest

from pyshepseg_tpu import shepseg as jax_shepseg
from pyshepseg_tpu.ops import segreduce as jax_segreduce
from pyshepseg_tpu.ops.clump import clump as jax_clump
from pyshepseg_tpu_torch import shepseg, timinghooks
from pyshepseg_tpu_torch.ops import segreduce
from pyshepseg_tpu_torch.ops.clump import clump
from test_shepseg import _voronoi_image
from torch_parity import random_clusters


@pytest.mark.parametrize("four", [True, False])
@pytest.mark.parametrize("cap,clumpId", [(1, 1), (7, 1), (40, 5)])
def test_max_clump_size_matches_jax(four, cap, clumpId):
    clusters = random_clusters(np.random.default_rng(cap), (37, 53),
                               nclusters=2)
    got, got_next = clump(clusters, 0, fourConnected=four, clumpId=clumpId,
                          maxClumpSize=cap, device="cpu")
    want, want_next = jax_clump(clusters, 0, fourConnected=four,
                                clumpId=clumpId, maxClumpSize=cap)
    assert got.dtype == np.uint32
    assert got_next == want_next
    np.testing.assert_array_equal(got, want)
    # the cap splits clumps: more ids than without it
    _, uncapped_next = clump(clusters, 0, fourConnected=four,
                             clumpId=clumpId, device="cpu")
    assert got_next > uncapped_next


@pytest.mark.parametrize("seed", [0, 1])
def test_segment_locations_match_jax(seed):
    seg = random_clusters(np.random.default_rng(seed), (23, 31),
                          nclusters=9)
    got = segreduce.makeSegmentLocations(seg)
    want = jax_segreduce.makeSegmentLocations(seg)
    assert isinstance(got, shepseg.SegmentLocations)
    assert got.maxSegId == want.maxSegId
    np.testing.assert_array_equal(got.starts, want.starts)
    np.testing.assert_array_equal(got.order, want.order)
    for segId in range(0, got.maxSegId + 2):
        assert (segId in got) == (segId in want)
        if segId in got:
            np.testing.assert_array_equal(got.rowcols(segId),
                                          want.rowcols(segId))
            rows, cols = got.getSegmentIndices(segId)
            assert (seg[rows, cols] == segId).all()


@pytest.fixture(scope="module")
def compat_inputs():
    """A pre-elimination clump image made as in test_shepseg_compat.py
    (48x48, 9 cells, k-means with the fixed init, clump), with noise 20
    so that 29 single pixels and 19 segments of 2-7 pixels occur. Built
    with the port: (img, seg, maxSegId)."""
    img, _ = _voronoi_image(np.random.default_rng(42), shape=(48, 48),
                            ncentres=9, noise=20)
    km = shepseg.fitSpectralClusters(img, 9, 100, None, True, device="cpu")
    clusters = shepseg.applySpectralClusters(km, img, None, device="cpu")
    seg, nxt = clump(clusters, 0, fourConnected=True, device="cpu")
    return img, seg, nxt - 1


def test_segment_locations_dict_matches_jax(compat_inputs):
    img, seg, maxSegId = compat_inputs
    size = shepseg.makeSegSize(seg, maxSegId)
    got = shepseg.makeSegmentLocationsDict(seg, size)
    want = jax_shepseg.makeSegmentLocationsDict(seg, size)
    assert sorted(got) == sorted(want)
    for segId in got:
        assert isinstance(got[segId], shepseg.RowColArray)
        assert got[segId].idx == want[segId].idx
        np.testing.assert_array_equal(got[segId].rowcols,
                                      want[segId].rowcols)
    rca = shepseg.RowColArray(2)
    rca.append(3, 4)
    np.testing.assert_array_equal(rca.getSegmentIndices()[0], [3])


@pytest.mark.parametrize("four", [True, False])
def test_single_pixel_compat_matches_jax(compat_inputs, four):
    """findNearestNeighbourPixel at every single-pixel segment, then
    mergeSinglePixels to its fixpoint, in both packages."""
    img, seg, maxSegId = compat_inputs
    size = shepseg.makeSegSize(seg, maxSegId)
    singles = np.argwhere(size[seg] == 1)
    assert len(singles) > 0
    for (i, j) in singles:
        assert (shepseg.findNearestNeighbourPixel(
            img, seg, int(i), int(j), size, four) ==
            jax_shepseg.findNearestNeighbourPixel(
                img, seg, int(i), int(j), size, four))
    results = []
    for mod in (shepseg, jax_shepseg):
        s = seg.copy()
        sz = shepseg.makeSegSize(s, maxSegId)
        segToElim = np.empty((3, maxSegId + 1), dtype=np.int64)
        counts = []
        while True:
            n = mod.mergeSinglePixels(img, s, sz, segToElim, four)
            counts.append(n)
            if not n:
                break
        results.append((s, sz, counts))
    np.testing.assert_array_equal(results[0][0], results[1][0])
    np.testing.assert_array_equal(results[0][1], results[1][1])
    assert results[0][2] == results[1][2]


def _small_elim(mod, seg, img, maxSegId, minSegSize, four):
    """The reference's sequential small-segment loop through ``mod``'s
    findMergeSegment / doMerge (as in test_shepseg_compat.py)."""
    spectSum = shepseg.buildSegmentSpectra(seg, img, maxSegId, device="cpu")
    segSize = shepseg.makeSegSize(seg, maxSegId)
    segLoc = mod.makeSegmentLocationsDict(seg, segSize)
    merges = []
    for targetSize in range(1, minSegSize):
        for segId in range(1, maxSegId + 1):
            if segSize[segId] == targetSize:
                nbr = mod.findMergeSegment(segId, segLoc, seg, segSize,
                                           spectSum, 1e9, four)
                if nbr != shepseg.SEGNULLVAL:
                    mod.doMerge(segId, nbr, seg, segSize, segLoc, spectSum)
                    merges.append((segId, int(nbr)))
    return merges, segSize, spectSum, segLoc


@pytest.mark.parametrize("four", [True, False])
def test_merge_compat_matches_jax(compat_inputs, four):
    img, seg0, maxSegId = compat_inputs
    out = []
    for mod in (shepseg, jax_shepseg):
        seg = seg0.copy()
        merges, size, spect, loc = _small_elim(mod, seg, img, maxSegId, 8,
                                               four)
        out.append((seg, merges, size, spect, loc))
    (segA, mA, sA, pA, lA), (segB, mB, sB, pB, lB) = out
    assert mA and mA == mB
    np.testing.assert_array_equal(segA, segB)
    np.testing.assert_array_equal(sA, sB)
    np.testing.assert_array_equal(pA, pB)
    assert sorted(lA) == sorted(lB)
    for segId in lA:
        np.testing.assert_array_equal(lA[segId].rowcols, lB[segId].rowcols)


def test_find_merge_segment_at_image_corner():
    seg = np.full((4, 4), 2, dtype=np.uint32)
    seg[0, 0] = 1
    seg[0, 1] = 1
    img = np.full((2, 4, 4), 100, dtype=np.int64)
    segSize = shepseg.makeSegSize(seg, 2)
    spectSum = shepseg.buildSegmentSpectra(seg, img, 2, device="cpu")
    segLoc = shepseg.makeSegmentLocationsDict(seg, segSize)
    got = shepseg.findMergeSegment(np.uint32(1), segLoc, seg, segSize,
                                   spectSum, 1e9, True)
    assert got == 2


@pytest.mark.parametrize("name", sorted(
    n for n in dir(timinghooks.AllTests) if n.startswith("test_")))
def test_timers_self_test(name):
    result = unittest.TestResult()
    timinghooks.AllTests(name).run(result)
    assert result.wasSuccessful(), result.failures + result.errors


def test_utils_match_jax(tmp_path):
    """formatTimingRpt and estimateStatsFromHisto of the port's utils
    against the JAX package's, on the same timings and histogram."""
    from pyshepseg_tpu import io as rio
    from pyshepseg_tpu import utils as jax_utils
    from pyshepseg_tpu_torch import utils
    t = timinghooks.Timers()
    for name in ('spectralclusters', 'reading', 'segmentation', 'walltime'):
        with t.interval(name):
            pass
    summary = t.makeSummaryDict()
    assert utils.formatTimingRpt(summary) == jax_utils.formatTimingRpt(
        summary)
    hist = np.array([0, 5, 0, 9, 2, 7], dtype=np.int64)
    meta = []
    for i, mod in enumerate((utils, jax_utils)):
        ds = rio.create(str(tmp_path / f"s{i}.npseg"), 4, 4, 1, np.uint32)
        band = ds.GetRasterBand(1)
        mod.estimateStatsFromHisto(band, hist)
        meta.append({k: band.GetMetadataItem(k) for k in (
            "STATISTICS_MINIMUM", "STATISTICS_MAXIMUM", "STATISTICS_MEAN",
            "STATISTICS_STDDEV", "STATISTICS_MODE", "STATISTICS_MEDIAN")})
    assert meta[0] == meta[1]
    assert meta[0]["STATISTICS_MAXIMUM"] == "5"


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_raster_format_shared_with_jax(tmp_path, writer):
    """The port's raster driver and the JAX package's read each other's
    ``.npseg`` files: bands, nodata, metadata, the RAT and overviews."""
    from pyshepseg_tpu import io as jax_rio
    from pyshepseg_tpu_torch import io as port_rio
    w_rio, r_rio = ((port_rio, jax_rio) if writer == "port"
                    else (jax_rio, port_rio))
    rng = np.random.default_rng(3)
    img = rng.integers(0, 5000, size=(2, 37, 45)).astype(np.uint16)
    path = str(tmp_path / "r.npseg")
    ds = w_rio.create(path, 45, 37, 2, np.uint16)
    for b in range(2):
        band = ds.GetRasterBand(b + 1)
        band.WriteArray(img[b])
        band.SetNoDataValue(7)
        band.SetMetadataItem("LAYER_TYPE", "thematic")
    rat = ds.GetRasterBand(1).GetDefaultRAT()
    rat.CreateColumn("Histogram", w_rio.GFT_Real, w_rio.GFU_PixelCount)
    rat.WriteArray(np.arange(6, dtype=np.float64), 0)
    ds.BuildOverviews("NEAREST", [4])
    ds.FlushCache()

    got = r_rio.open(path)
    assert (got.RasterXSize, got.RasterYSize, got.RasterCount) == (45, 37, 2)
    for b in range(2):
        band = got.GetRasterBand(b + 1)
        np.testing.assert_array_equal(band.ReadAsArray(), img[b])
        np.testing.assert_array_equal(band.ReadAsArray(3, 5, 10, 4),
                                      img[b, 5:9, 3:13])
        assert band.GetNoDataValue() == 7
        assert band.GetMetadataItem("LAYER_TYPE") == "thematic"
        np.testing.assert_array_equal(band.GetOverview(0).ReadAsArray(),
                                      img[b, 2::4, 2::4][:9, :11])
    rat = got.GetRasterBand(1).GetDefaultRAT()
    col = rat.GetColOfUsage(r_rio.GFU_PixelCount)
    np.testing.assert_array_equal(rat.ReadAsArray(col), np.arange(6))
