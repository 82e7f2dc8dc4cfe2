"""The port's per-segment statistics engine (tilingstats, non-spatial part)
against pyshepseg_tpu.tilingstats: the same rasters (made with numpy from a
seed) go through both packages on both engines, the port's device engine
on the CPU, and every RAT column must be equal bit for bit (the float32
mean and stddev columns included: both packages compute them with the same
numpy arithmetic from the same runs). Stats tiles are shrunk to 48 pixels
so segments stream across tiles."""

import shutil

import numpy as np
import pytest
import torch

from pyshepseg_tpu import io as rio
from pyshepseg_tpu import tiling as jax_tiling
from pyshepseg_tpu import tilingstats as jax_tilingstats
from pyshepseg_tpu_torch import tiling, tilingstats
from test_tilingstats import NODATA, fake_rios, make_seg_and_img  # noqa: F401
import torch_parity  # noqa: F401  (one torch thread)

STATS = [("mn", "min"), ("mx", "max"), ("mean", "mean"), ("sd", "stddev"),
         ("med", "median"), ("mode", "mode"), ("p0", "percentile", 0),
         ("p25", "percentile", 25), ("p100", "percentile", 100),
         ("n", "pixcount")]


@pytest.fixture
def small_tiles(monkeypatch):
    """48-pixel stats tiles in both packages."""
    monkeypatch.setattr(jax_tiling, "TILESIZE", 48)
    monkeypatch.setattr(tiling, "TILESIZE", 48)


def copy_seg(segpath, tmp_path, name):
    """A copy of the segmentation raster (.npseg datasets are
    directories), so each run writes its own RAT."""
    path = str(tmp_path / (name + ".npseg"))
    shutil.copytree(segpath, path)
    return path


def read_cols(path, names):
    rat = rio.open(path).GetRasterBand(1).GetDefaultRAT()
    have = [rat.GetNameOfCol(i) for i in range(rat.GetColumnCount())]
    return {n: rat.ReadAsArray(have.index(n)) for n in names}


def assert_same_cols(pathA, pathB, names):
    a, b = read_cols(pathA, names), read_cols(pathB, names)
    for n in names:
        np.testing.assert_array_equal(a[n], b[n], err_msg=n)


def multiband_image(tmp_path, rng, img1, dtype=np.uint16):
    """A 3-band image: band 1 as given (nodata NODATA), band 2 without
    nodata, band 3 with its own nodata value 49."""
    h, w = img1.shape
    img2 = rng.integers(0, 500, size=(h, w)).astype(dtype)
    img3 = rng.integers(0, 50, size=(h, w)).astype(dtype)
    img3[rng.random((h, w)) < 0.1] = 49
    path = str(tmp_path / "multi.npseg")
    ds = rio.create(path, w, h, 3, dtype)
    for i, (arr, nd) in enumerate([(img1.astype(dtype), NODATA),
                                   (img2, None), (img3, 49)], start=1):
        band = ds.GetRasterBand(i)
        band.WriteArray(arr)
        if nd is not None:
            band.SetNoDataValue(nd)
    ds.FlushCache()
    return path


@pytest.mark.parametrize("engine", ["host", "device"])
def test_single_band_every_stat_matches_jax(tmp_path, rng, small_tiles,
                                            engine):
    """Every statistic, percentile 0 (the reference's quirk) and 100
    included, over segments that stream across 48-pixel tiles, with
    nodata pixels and a null strip."""
    segpath, imgpath, seg, img = make_seg_and_img(tmp_path, rng)
    got, want, host = (copy_seg(segpath, tmp_path, n)
                       for n in ("got", "want", "host"))
    res = tilingstats.calcPerSegmentStatsTiled(
        imgpath, 1, got, STATS, engine=engine, device="cpu")
    jax_tilingstats.calcPerSegmentStatsTiled(imgpath, 1, want, STATS,
                                             engine=engine)
    jax_tilingstats.calcPerSegmentStatsTiled(imgpath, 1, host, STATS,
                                             engine="host")
    names = [s[0] for s in STATS]
    assert_same_cols(got, want, names)
    assert_same_cols(got, host, names)
    timers = res.timings.makeSummaryDict()
    assert {"reading", "accumulation", "statscompletion",
            "writing"} <= set(timers)
    if engine == "device":
        # the CPU engages the scene-resident feed
        assert "compaction" in timers
    n = read_cols(got, ["n"])["n"]
    counts = np.bincount(seg[img != NODATA], minlength=len(n))
    counts[0] = 0
    np.testing.assert_array_equal(n, counts)


@pytest.mark.parametrize("feed", ["scene", "tiles", "host"])
def test_multiband_matches_jax(tmp_path, rng, small_tiles, monkeypatch,
                               feed):
    """Three bands with their own nodata values in one pass: the device
    engine's scene-resident feed, its per-tile feed (the scene forced
    over the memory budget) and the host engine all equal the JAX
    package's host engine, and the port's single-band calls."""
    segpath, imgpath, seg, img1 = make_seg_and_img(tmp_path, rng,
                                                   shape=(90, 110))
    multipath = multiband_image(tmp_path, rng, img1)
    if feed == "tiles":
        monkeypatch.setattr(tiling, "SCENE_CACHE_HBM_FRACTION", 0)
    engine = "host" if feed == "host" else "device"
    sel = [[("b1_" + s[0],) + s[1:] for s in STATS],
           [("b2_mean", "mean"), ("b2_max", "max"), ("b2_p0", "percentile",
                                                     0)],
           [("b3_mode", "mode"), ("b3_sd", "stddev"), ("b3_n", "pixcount")]]
    names = [s[0] for band in sel for s in band]
    got, want, single = (copy_seg(segpath, tmp_path, n)
                         for n in ("got", "want", "single"))
    res = tilingstats.calcPerSegmentStatsTiledMultiBand(
        multipath, [1, 2, 3], got, sel, engine=engine, device="cpu")
    assert ("compaction" in res.timings.makeSummaryDict()) == (
        feed == "scene")
    jax_tilingstats.calcPerSegmentStatsTiledMultiBand(
        multipath, [1, 2, 3], want, sel, engine="host")
    for band, s in zip([1, 2, 3], sel):
        tilingstats.calcPerSegmentStatsTiled(multipath, band, single, s,
                                             engine=engine, device="cpu")
    assert_same_cols(got, want, names)
    assert_same_cols(got, single, names)


@pytest.mark.parametrize("dtype", [np.int16, np.uint8])
def test_device_engine_other_dtypes(tmp_path, rng, small_tiles, dtype):
    """int16 imagery (negative values) and uint8 through the device
    engine equal the JAX host engine."""
    segpath, _, seg, img = make_seg_and_img(tmp_path, rng, shape=(60, 70),
                                            nseg=10)
    data = rng.integers(-300 if dtype == np.int16 else 0,
                        250, size=img.shape).astype(dtype)
    imgpath = str(tmp_path / "img_other.npseg")
    ds = rio.create(imgpath, 70, 60, 1, dtype)
    ds.GetRasterBand(1).WriteArray(data)
    ds.GetRasterBand(1).SetNoDataValue(int(data[10, 10]))
    ds.FlushCache()
    got, want = (copy_seg(segpath, tmp_path, n) for n in ("got", "want"))
    tilingstats.calcPerSegmentStatsTiled(imgpath, 1, got, STATS,
                                         engine="device", device="cpu")
    jax_tilingstats.calcPerSegmentStatsTiled(imgpath, 1, want, STATS,
                                             engine="host")
    assert_same_cols(got, want, [s[0] for s in STATS])


@pytest.mark.parametrize("engine", ["host", "device"])
@pytest.mark.parametrize("whole", [False, True])
def test_all_nodata_segments_match_jax(tmp_path, rng, small_tiles, engine,
                                       whole):
    """One segment, or the whole image, all nodata: missingStatsValue in
    every statistic but pixcount (0), as in the JAX package."""
    segpath, imgpath, seg, img = make_seg_and_img(tmp_path, rng,
                                                  shape=(60, 60), nseg=6)
    band = rio.open(imgpath, rio.GA_Update).GetRasterBand(1)
    data = band.ReadAsArray()
    data[(seg == 3) | whole] = NODATA
    band.WriteArray(data)
    got, want = (copy_seg(segpath, tmp_path, n) for n in ("got", "want"))
    tilingstats.calcPerSegmentStatsTiled(imgpath, 1, got, STATS,
                                         missingStatsValue=-42,
                                         engine=engine, device="cpu")
    jax_tilingstats.calcPerSegmentStatsTiled(imgpath, 1, want, STATS,
                                             missingStatsValue=-42,
                                             engine=engine)
    names = [s[0] for s in STATS]
    assert_same_cols(got, want, names)
    cols = read_cols(got, names)
    assert cols["med"][3] == -42 and cols["n"][3] == 0
    if whole:
        assert (cols["mean"][1:] == -42).all()


@pytest.mark.parametrize("engine", ["host", "device"])
def test_read_workers_match_serial(tmp_path, rng, small_tiles, monkeypatch,
                                   engine):
    """Reads and compactions on two worker threads (the device engine's
    per-tile feed: each thread sends its own tiles) equal the serial
    run."""
    monkeypatch.setattr(tiling, "SCENE_CACHE_HBM_FRACTION", 0)
    segpath, imgpath, seg, img = make_seg_and_img(tmp_path, rng)
    a, b = (copy_seg(segpath, tmp_path, n) for n in ("serial", "threads"))
    for path, workers in ((a, 0), (b, 2)):
        tilingstats.calcPerSegmentStatsTiled(
            imgpath, 1, path, STATS, numReadWorkers=workers,
            engine=engine, device="cpu")
    assert_same_cols(a, b, [s[0] for s in STATS])


def _float_image(tmp_path, rng):
    path = str(tmp_path / "f.npseg")
    ds = rio.create(path, 40, 40, 1, np.float32)
    ds.GetRasterBand(1).WriteArray(np.zeros((40, 40), np.float32))
    return path


def _wide_image(tmp_path, rng, dtype):
    path = str(tmp_path / "wide.npseg")
    ds = rio.create(path, 40, 40, 1, dtype)
    ds.GetRasterBand(1).WriteArray(np.zeros((40, 40), dtype))
    return path


@pytest.mark.parametrize("case", ["float", "histogram", "size", "align",
                                  "nobands", "engine", "uint32"])
def test_validation_errors(tmp_path, rng, case):
    """The port raises PyShepSegStatsError where the JAX package does."""
    segpath, imgpath, seg, img = make_seg_and_img(tmp_path, rng,
                                                  shape=(40, 40), nseg=4)
    args = dict(imgfile=imgpath, bandNumbers=[1], segfile=segpath,
                statsSelectionList=[[("m", "mean")]])
    kw = {}
    if case == "float":
        args["imgfile"] = _float_image(tmp_path, rng)
    elif case == "histogram":
        args["segfile"] = str(tmp_path / "seg2.npseg")
        ds = rio.create(args["segfile"], 40, 40, 1, np.uint32)
        ds.GetRasterBand(1).WriteArray(seg)
    elif case == "size":
        args["imgfile"] = str(tmp_path / "other.npseg")
        ds = rio.create(args["imgfile"], 30, 30, 1, np.uint16)
        ds.GetRasterBand(1).WriteArray(np.zeros((30, 30), np.uint16))
    elif case == "align":
        args["bandNumbers"] = [1, 2]
    elif case == "nobands":
        args["bandNumbers"], args["statsSelectionList"] = [], []
    elif case == "engine":
        kw["engine"] = "tpu"
    else:
        # values of uint32 imagery may not fit the int32 key
        args["imgfile"] = _wide_image(tmp_path, rng, np.uint32)
        kw["engine"] = "device"
    with pytest.raises(tilingstats.PyShepSegStatsError):
        tilingstats.calcPerSegmentStatsTiledMultiBand(**args, device="cpu",
                                                      **kw)
    with pytest.raises(jax_tilingstats.PyShepSegStatsError):
        jax_tilingstats.calcPerSegmentStatsTiledMultiBand(**args, **kw)


def test_engine_resolution(tmp_path, rng):
    """'auto' takes the device engine exactly on a CUDA device for
    imagery that fits the key; 'host' never; 'device' on any device."""
    _, imgpath, _, _ = make_seg_and_img(tmp_path, rng, shape=(20, 20),
                                        nseg=3)
    band = rio.open(imgpath).GetRasterBand(1)
    wide = rio.open(_wide_image(tmp_path, rng, np.uint32)).GetRasterBand(1)
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    resolve = tilingstats._resolveStatsEngine
    assert resolve("auto", band, cuda)
    assert not resolve("auto", band, cpu)
    assert not resolve("auto", wide, cuda)
    assert not resolve("host", band, cuda)
    assert resolve("device", band, cpu)


def test_scene_budget(monkeypatch):
    cpu = torch.device("cpu")
    assert tilingstats._sceneFitsDeviceStats(120, 130, 3, cpu)
    monkeypatch.setattr(tiling, "SCENE_CACHE_HBM_FRACTION", 0)
    assert not tilingstats._sceneFitsDeviceStats(120, 130, 3, cpu)


def test_default_device_raises_without_cuda(tmp_path, rng):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    segpath, imgpath, _, _ = make_seg_and_img(tmp_path, rng, shape=(20, 20),
                                              nseg=3)
    with pytest.raises(RuntimeError):
        tilingstats.calcPerSegmentStatsTiled(imgpath, 1, segpath,
                                             [("m", "mean")])


def test_rios_driver_matches_jax_and_tiled(tmp_path, rng, small_tiles,
                                           fake_rios):
    """The RIOS driver (temp RAT, copyRAT back) equals the JAX package's
    RIOS driver and the port's tiled path; compute workers are
    refused."""
    segpath, imgpath, seg, img = make_seg_and_img(tmp_path, rng)
    got, want, tiled = (copy_seg(segpath, tmp_path, n)
                        for n in ("got", "want", "tiled"))
    from rios import applier
    style = applier.ConcurrencyStyle(numReadWorkers=2)
    tilingstats.calcPerSegmentStatsRIOS(imgpath, 1, got, STATS,
                                        concurrencyStyle=style)
    jax_tilingstats.calcPerSegmentStatsRIOS(imgpath, 1, want, STATS,
                                            concurrencyStyle=style)
    tilingstats.calcPerSegmentStatsTiled(imgpath, 1, tiled, STATS,
                                         engine="host", device="cpu")
    names = [s[0] for s in STATS]
    assert_same_cols(got, want, names)
    assert_same_cols(got, tiled, names)
    bad = applier.ConcurrencyStyle(numComputeWorkers=2,
                                   computeWorkerKind="CW_THREADS")
    with pytest.raises(tilingstats.PyShepSegStatsError):
        tilingstats.calcPerSegmentStatsRIOS(imgpath, 1, got, STATS,
                                            concurrencyStyle=bad)


def test_rios_missing_package_raises(tmp_path, rng):
    segpath, imgpath, _, _ = make_seg_and_img(tmp_path, rng, shape=(20, 20),
                                              nseg=3)
    with pytest.raises(tilingstats.PyShepSegStatsError):
        tilingstats.calcPerSegmentStatsRIOS(imgpath, 1, segpath,
                                            [("m", "mean")])


def _dict_pipeline(mod, seg, img, imgNullVal, statsSelection):
    """accumulateSegDict over two half tiles, then
    calcStatsForCompletedSegs; returns (pagedRat, complete after the
    first half)."""
    segSize = np.bincount(seg.ravel(), minlength=10)
    segSize[0] = 0
    segDict, noDataDict = mod.createSegDict(), mod.createNoDataDict()
    pagedRat = mod.createPagedRat()
    sel, nInt, nFloat = mod.makeFastStatsSelection(
        list(range(len(statsSelection))), statsSelection)
    mod.accumulateSegDict(segDict, noDataDict, imgNullVal, seg[:, :30],
                          img[:, :30])
    first = [s for s in segDict
             if mod.checkSegComplete(segDict, noDataDict, segSize, s)]
    mod.accumulateSegDict(segDict, noDataDict, imgNullVal, seg[:, 30:],
                          img[:, 30:])
    mod.calcStatsForCompletedSegs(segDict, noDataDict, -9999, pagedRat, sel,
                                  segSize, nInt, nFloat)
    assert segDict == {} and noDataDict == {}
    return pagedRat, first


def test_dict_compat_layer_matches_jax(rng):
    """The reference-style dict kernels give the JAX package's paged RAT
    (all-nodata segment and the p=0 quirk included)."""
    seg = rng.integers(1, 9, size=(40, 60)).astype(np.uint32)
    seg[0, :5] = 0
    img = rng.integers(0, 50, size=(40, 60)).astype(np.int64)
    img[seg == 3] = 7
    sel = [("mn", "mean"), ("p0", "percentile", 0), ("md", "median"),
           ("sd", "stddev"), ("mo", "mode"), ("cnt", "pixcount")]
    got, gotFirst = _dict_pipeline(tilingstats, seg, img, 7, sel)
    want, wantFirst = _dict_pipeline(jax_tilingstats, seg, img, 7, sel)
    assert gotFirst == wantFirst == []
    assert list(got) == list(want) == [0]
    # rows never completed (id 9 has no pixel) hold uninitialised values
    done = got[0].complete
    np.testing.assert_array_equal(done, want[0].complete)
    assert done[1:9].all()
    np.testing.assert_array_equal(got[0].intcols[:, done],
                                  want[0].intcols[:, done])
    np.testing.assert_array_equal(got[0].floatcols[:, done],
                                  want[0].floatcols[:, done])


@pytest.mark.parametrize("hist", [{10: 3, 5: 2, 20: 1}, {-4: 1, 9: 5},
                                  {7: 2, 3: 2}, {}])
def test_segment_stats_class_matches_jax(hist):
    got = tilingstats.SegmentStats(hist, -9999)
    want = jax_tilingstats.SegmentStats(hist, -9999)
    for attr in ("pixCount", "min", "max", "mean", "stddev", "mode",
                 "median"):
        assert getattr(got, attr) == getattr(want, attr), attr
    for statID, param in [(tilingstats.STATID_PERCENTILE, 0),
                          (tilingstats.STATID_PERCENTILE, 25),
                          (tilingstats.STATID_PERCENTILE, 100),
                          (tilingstats.STATID_PIXCOUNT, 0)]:
        assert got.getStat(statID, param) == want.getStat(statID, param)
    np.testing.assert_array_equal(
        tilingstats.getSortedKeysAndValuesForDict(hist)[0],
        jax_tilingstats.getSortedKeysAndValuesForDict(hist)[0])


def test_stats_from_runs_matches_jax(rng):
    """The grouped statistics from runs, on random groups with ties,
    empty groups and every statistic."""
    lengths = rng.integers(0, 12, size=150)
    vals = np.concatenate([np.sort(rng.choice(np.arange(-50, 50), n,
                                              replace=False))
                           for n in lengths]).astype(np.int64)
    counts = rng.integers(1, 9, size=len(vals)).astype(np.int64)
    end = np.cumsum(lengths)
    start = end - lengths
    for statID in range(8):
        for param in (0, 25, 100):
            np.testing.assert_array_equal(
                tilingstats._segmentStatsFromRuns(vals, counts, start, end,
                                                  statID, param, -9999),
                jax_tilingstats._segmentStatsFromRuns(
                    vals, counts, start, end, statID, param, -9999),
                err_msg=f"statID={statID} p={param}")
