"""The port's spatial statistics (ops/spatialstats.py and the spatial part
of tilingstats) against the JAX package's, on the same numpy inputs made
from a seed. Edge-pixel counts and every integer column are equal bit for
bit. Float32 device results (variogram sums, device variograms and mean
coordinates) differ from the JAX package's only in float32 accumulation
order: PARITY.md deviation 6 puts that at ~1e-5 relative, so they are
held to rtol 1e-5 (atol 1e-3 on a variogram, atol 1e-2 on a mean
coordinate of magnitude ~1e3). Float64 host routes are numpy in both
packages and equal bit for bit."""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyshepseg_tpu import io as rio
from pyshepseg_tpu import tilingstats as jax_tilingstats
from pyshepseg_tpu.ops import spatialstats as jax_sps
from pyshepseg_tpu_torch import tilingstats
from pyshepseg_tpu_torch.ops import spatialstats as sps
from test_tilingstats import NODATA, fake_rios, make_seg_and_img  # noqa: F401
from test_torch_tilingstats import copy_seg, read_cols, small_tiles  # noqa: F401
import torch_parity  # noqa: F401  (one torch thread)

RTOL = 1e-5


def columns(path, names):
    """The RAT columns ``names`` of a segmentation, as a list."""
    return list(read_cols(path, names).values())


def random_masks(rng, shape=(5, 16, 24), p=0.7):
    return rng.random(shape) < p


@pytest.mark.parametrize("four", [True, False])
def test_edge_pixel_counts_match_jax(rng, four):
    masks = random_masks(rng)
    masks[0] = True                      # a full box: only its border
    masks[1, :, :3] = False
    got = sps.edge_pixel_counts(torch.from_numpy(masks), four)
    want = np.asarray(jax_sps.edge_pixel_counts(jnp.asarray(masks),
                                                four_connected=four))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0] == 2 * (16 + 24) - 4


@pytest.mark.parametrize("maxDist", [1, 3, 5])
@pytest.mark.parametrize("kind", ["integer", "float"])
def test_variogram_sums_match_jax(rng, maxDist, kind):
    """Counts exact; sums to rtol 1e-5 (float32 accumulation order). A
    box narrower than an offset skips it, as in the JAX package."""
    shape = (4, 16, 8)
    if kind == "integer":
        vals = rng.integers(0, 3000, size=shape).astype(np.float32)
    else:
        vals = rng.normal(100, 30, size=shape).astype(np.float32)
    valid = random_masks(rng, shape, p=0.8)
    cnt, sums = sps.variogram_sums(torch.from_numpy(vals),
                                   torch.from_numpy(valid), maxDist)
    wcnt, wsums = jax_sps.variogram_sums(jnp.asarray(vals),
                                         jnp.asarray(valid),
                                         max_dist=maxDist)
    assert cnt.dtype == torch.int32 and sums.dtype == torch.float32
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(wcnt))
    np.testing.assert_allclose(sums.numpy(), np.asarray(wsums), rtol=RTOL)


def test_box_functions_vmap_one_box_at_a_time(rng):
    """Under torch.func.vmap over single boxes (the DeviceSpatialUserFunc
    route) both functions give the batched result."""
    masks = torch.from_numpy(random_masks(rng))
    vals = torch.from_numpy(rng.integers(0, 100, size=(5, 16, 24)).astype(
        np.float32))
    one = torch.func.vmap(lambda m: sps.edge_pixel_counts(m[None], False))
    np.testing.assert_array_equal(one(masks)[:, 0].numpy(),
                                  sps.edge_pixel_counts(masks, False).numpy())
    vone = torch.func.vmap(
        lambda v, m: sps.variogram_sums(v[None], m[None], 3))
    c1, s1 = vone(vals, masks)
    c2, s2 = sps.variogram_sums(vals, masks, 3)
    np.testing.assert_array_equal(c1[:, 0].numpy(), c2.numpy())
    np.testing.assert_allclose(s1[:, 0].numpy(), s2.numpy(), rtol=RTOL)


def test_box_helpers_match_jax(rng):
    for h, w in [(1, 1), (8, 9), (100, 3), (513, 64)]:
        assert sps.pad_box_shape(h, w) == jax_sps.pad_box_shape(h, w)
    pts = []
    for n in (5, 9):
        x = rng.integers(100, 120, size=n).astype(np.uint32)
        y = rng.integers(40, 50, size=n).astype(np.uint32)
        pts.append(tilingstats.makePtsArray(x, y, rng.integers(0, 9, n)))
    for fill, dtype, valueOf in [(-1, np.float32, lambda p: p['val']),
                                 (0, np.uint8, None)]:
        np.testing.assert_array_equal(
            sps.scatter_boxes(pts, fill, dtype, valueOf),
            jax_sps.scatter_boxes(pts, fill, dtype, valueOf))


# ---------------------------------------- calcPerSegmentSpatialStatsTiled


def run_both(tmp_path, rng, cols, userFunc, jaxUserFunc, userParam, engine,
             jaxEngine=None, shape=(120, 130), nseg=40, **kw):
    """One spatial stats run through each package on copies of the same
    segmentation; returns (port columns, JAX columns, seg, img)."""
    segpath, imgpath, seg, img = make_seg_and_img(tmp_path, rng,
                                                  shape=shape, nseg=nseg)
    got, want = (copy_seg(segpath, tmp_path, n) for n in ("got", "want"))
    tilingstats.calcPerSegmentSpatialStatsTiled(
        imgpath, 1, got, cols, userFunc, userParam, engine=engine,
        device="cpu", **kw)
    jax_tilingstats.calcPerSegmentSpatialStatsTiled(
        imgpath, 1, want, cols, jaxUserFunc, userParam,
        engine=jaxEngine or engine, **kw)
    names = [c[0] for c in cols]
    return columns(got, names), columns(want, names), seg, img


@pytest.mark.parametrize("engine", ["host", "device"])
@pytest.mark.parametrize("four", [True, False])
def test_edge_pixels_match_jax(tmp_path, rng, small_tiles, engine, four):
    """Host engine: the 1-pixel-halo streaming route; device engine: the
    batched box function. Equal to the JAX package's on the same engine
    and to each other (the host run of JAX)."""
    got, want, seg, img = run_both(
        tmp_path, rng, [("edge", rio.GFT_Integer)],
        tilingstats.userFuncNumEdgePixels,
        jax_tilingstats.userFuncNumEdgePixels, four, engine)
    np.testing.assert_array_equal(got[0], want[0])
    segpath = str(tmp_path / "host_jax.npseg")
    shutil.copytree(str(tmp_path / "seg.npseg"), segpath)
    jax_tilingstats.calcPerSegmentSpatialStatsTiled(
        str(tmp_path / "img.npseg"), 1, segpath, [("edge", rio.GFT_Integer)],
        jax_tilingstats.userFuncNumEdgePixels, four, engine="host")
    np.testing.assert_array_equal(got[0], columns(segpath, ["edge"])[0])


@pytest.mark.parametrize("engine", ["host", "device"])
def test_variogram_matches_jax(tmp_path, rng, small_tiles, engine):
    """maxDist 3: the host engine's maxDist-halo streaming route is
    numpy float64 in both packages (bit for bit); the device engine's
    float32 box function to rtol 1e-5. Missing bins agree exactly."""
    cols = [("v%d" % d, rio.GFT_Real) for d in (1, 2, 3)]
    got, want, _, _ = run_both(tmp_path, rng, cols,
                               tilingstats.userFuncVariogram,
                               jax_tilingstats.userFuncVariogram, 3,
                               engine)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g == -9999, w == -9999)
        if engine == "host":
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=1e-3)


def test_large_maxdist_variogram_point_route(tmp_path, rng, small_tiles):
    """maxDist 9, past the streaming cut-off: the point route's host
    callback in both packages."""
    cols = [("v%d" % d, rio.GFT_Real) for d in range(1, 10)]
    got, want, _, _ = run_both(tmp_path, rng, cols,
                               tilingstats.userFuncVariogram,
                               jax_tilingstats.userFuncVariogram, 9, "host",
                               shape=(60, 60), nseg=4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("route", ["host", "device"])
def test_mean_coord_matches_jax(tmp_path, rng, small_tiles, route):
    """userFuncMeanCoord streams (float64, bit for bit with the JAX
    package); deviceFuncMeanCoord on the device engine is float32 (rtol
    1e-5 against the JAX package's device run)."""
    transform = np.array([1000.0, 2.0, 0.0, 500.0, 0.0, -2.0])
    cols = [("east", rio.GFT_Real), ("north", rio.GFT_Real)]
    if route == "host":
        fns = (tilingstats.userFuncMeanCoord,
               jax_tilingstats.userFuncMeanCoord)
    else:
        fns = (tilingstats.deviceFuncMeanCoord,
               jax_tilingstats.deviceFuncMeanCoord)
    got, want, _, _ = run_both(tmp_path, rng, cols, fns[0], fns[1],
                               transform, route)
    for g, w in zip(got, want):
        if route == "host":
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=1e-2)


def test_mean_coord_streams(tmp_path, rng, small_tiles, monkeypatch):
    """userFuncMeanCoord never goes through the point accumulator."""
    def boom(*a, **k):
        raise AssertionError("point-list path used for userFuncMeanCoord")

    monkeypatch.setattr(tilingstats, "compactTileSpatial", boom)
    segpath, imgpath, _, _ = make_seg_and_img(tmp_path, rng, shape=(60, 60),
                                              nseg=5)
    tilingstats.calcPerSegmentSpatialStatsTiled(
        imgpath, 1, segpath, [("e", rio.GFT_Real), ("n", rio.GFT_Real)],
        tilingstats.userFuncMeanCoord, np.array([0, 1, 0, 0, 0, 1.0]),
        device="cpu")


def _masked_mean_torch(vals, mask, scale):
    m = mask.to(torch.float32)
    n = m.sum()
    mean = torch.where(n > 0, (vals * m).sum() / torch.clamp(n, min=1),
                       torch.nan)
    return n.to(torch.int32).reshape(1), (mean * scale).reshape(1)


def _masked_mean_jax(vals, mask, scale):
    m = mask.astype(jnp.float32)
    n = jnp.sum(m)
    mean = jnp.where(n > 0, jnp.sum(vals * m) / jnp.maximum(n, 1), jnp.nan)
    return jnp.stack([n.astype(jnp.int32)]), jnp.stack([mean * scale])


def _masked_mean_host(pts, imgNullVal, intArr, floatArr, scale):
    intArr[0] = len(pts)
    if len(pts) > 0:
        floatArr[0] = np.float32(pts['val'].astype(np.float32).sum() /
                                 np.float32(len(pts))) * scale


@pytest.mark.parametrize("maxBox", [2048, 8])
def test_custom_torch_device_func(tmp_path, rng, small_tiles, maxBox):
    """A custom DeviceSpatialUserFunc written in torch (masked pixel
    count and masked mean) on the device engine equals the same function
    written in JAX through the JAX package, and a host callback; with
    maxBox 8 every box is oversized and runs as a batch of one."""
    cols = [("npx", rio.GFT_Integer), ("smean", rio.GFT_Real)]
    devFunc = tilingstats.DeviceSpatialUserFunc(_masked_mean_torch,
                                                maxBox=maxBox)
    jaxFunc = jax_tilingstats.DeviceSpatialUserFunc(_masked_mean_jax,
                                                    maxBox=maxBox)
    got, want, seg, img = run_both(tmp_path, rng, cols, devFunc, jaxFunc,
                                   2.0, "device")
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=RTOL, atol=1e-3)
    hostpath = str(tmp_path / "host.npseg")
    shutil.copytree(str(tmp_path / "seg.npseg"), hostpath)
    tilingstats.calcPerSegmentSpatialStatsTiled(
        str(tmp_path / "img.npseg"), 1, hostpath, cols, _masked_mean_host,
        2.0, engine="host", device="cpu")
    host = columns(hostpath, ["npx", "smean"])
    np.testing.assert_array_equal(got[0], host[0])
    np.testing.assert_allclose(got[1], host[1], rtol=RTOL, atol=1e-3)


def test_device_func_on_host_engine_with_origin(tmp_path, rng, small_tiles):
    """A DeviceSpatialUserFunc without hostFallback on the host engine
    evaluates its torch function one box at a time on the CPU; with
    wantsOrigin the origin is in whole-image coordinates."""
    def fn(vals, mask, origin, _param):
        m = mask.to(torch.float32)
        yy = torch.arange(mask.shape[0], dtype=torch.float32)[:, None]
        return None, ((m * yy).sum() / torch.clamp(m.sum(), min=1) +
                      origin[0]).reshape(1)

    segpath, imgpath, seg, img = make_seg_and_img(tmp_path, rng)
    tilingstats.calcPerSegmentSpatialStatsTiled(
        imgpath, 1, segpath, [("ymean", rio.GFT_Real)],
        tilingstats.DeviceSpatialUserFunc(fn, wantsOrigin=True), None,
        engine="host", device="cpu")
    got = columns(segpath, ["ymean"])[0]
    for sid in range(1, int(seg.max()) + 1):
        ys, _ = np.nonzero((seg == sid) & (img != NODATA))
        if len(ys):
            np.testing.assert_allclose(got[sid], ys.mean(), atol=1e-3)


def test_streaming_variogram_hook_without_nodata(rng):
    """The port's streamingVariogram hook takes imgNullVal=None (every
    value is data); the JAX package's copy raises there, the one place
    the two packages differ (ROADMAP queue 3)."""
    h = 2
    seg = rng.integers(1, 4, size=(10 + 2 * h, 12 + 2 * h)).astype(np.uint32)
    seg[:h] = 0
    val = rng.integers(0, 50, size=seg.shape).astype(np.uint16)
    got = tilingstats.streamingVariogram(h).tileContrib2D(seg, val, 0, 0,
                                                          None)
    with pytest.raises(TypeError):
        jax_tilingstats.streamingVariogram(h).tileContrib2D(seg, val, 0, 0,
                                                            None)
    # a null value that never occurs is the same as none at all
    want = jax_tilingstats.streamingVariogram(h).tileContrib2D(
        seg, val, 0, 0, 65535)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # brute force over the core's pixels
    cnt = np.zeros((4, h), np.int64)
    for y in range(h, seg.shape[0] - h):
        for x in range(h, seg.shape[1] - h):
            for dy in range(1, h + 1):
                for dx in range(1, h + 1):
                    d = int(np.sqrt(dy * dy + dx * dx))
                    if (1 <= d <= h and seg[y, x] != 0 and
                            seg[y + dy, x + dx] == seg[y, x]):
                        cnt[seg[y, x], d - 1] += 1
    np.testing.assert_array_equal(got[0], cnt[:len(got[0])])


def _custom_streaming(mod):
    """Per-segment value sum and pixel count via running bincounts."""
    def initState(numSeg):
        return {'sum': np.zeros(numSeg, np.float64),
                'cnt': np.zeros(numSeg, np.int64)}

    def tileContrib(segIds, xx, yy, vals):
        hi = int(segIds.max()) + 1
        return (np.bincount(segIds, weights=vals.astype(np.float64),
                            minlength=hi),
                np.bincount(segIds, minlength=hi))

    def mergeContrib(state, contrib):
        s, c = contrib
        k = min(len(c), len(state['cnt']))
        state['sum'][:k] += s[:k]
        state['cnt'][:k] += c[:k]

    def finalizeRows(state, segIds):
        return (state['cnt'][segIds][:, None],
                state['sum'][segIds][:, None])

    return mod.StreamingSpatialUserFunc(initState, tileContrib,
                                        mergeContrib, finalizeRows)


@pytest.mark.parametrize("workers", [0, 2])
def test_custom_streaming_func_matches_jax(tmp_path, rng, small_tiles,
                                           workers):
    cols = [("st_cnt", rio.GFT_Integer), ("st_sum", rio.GFT_Real)]
    got, want, _, _ = run_both(tmp_path, rng, cols,
                               _custom_streaming(tilingstats),
                               _custom_streaming(jax_tilingstats), None,
                               "host", numReadWorkers=workers)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_spatial_read_workers_match_serial(tmp_path, rng, small_tiles):
    """Halo reads and point lists on worker threads equal serial."""
    segpath, imgpath, _, _ = make_seg_and_img(tmp_path, rng)
    a, b = (copy_seg(segpath, tmp_path, n) for n in ("serial", "threads"))
    cols = [("edge", rio.GFT_Integer)]
    for path, workers in ((a, 0), (b, 2)):
        tilingstats.calcPerSegmentSpatialStatsTiled(
            imgpath, 1, path, cols, tilingstats.userFuncNumEdgePixels,
            False, numReadWorkers=workers, engine="device", device="cpu")
    np.testing.assert_array_equal(columns(a, ["edge"])[0],
                                  columns(b, ["edge"])[0])


def test_spatial_needs_nodata(tmp_path, rng):
    segpath, imgpath, _, _ = make_seg_and_img(tmp_path, rng, shape=(20, 20),
                                              nseg=3)
    rio.open(imgpath, rio.GA_Update).GetRasterBand(1).SetNoDataValue(None)
    with pytest.raises(tilingstats.PyShepSegStatsError):
        tilingstats.calcPerSegmentSpatialStatsTiled(
            imgpath, 1, segpath, [("e", rio.GFT_Integer)],
            tilingstats.userFuncNumEdgePixels, True, device="cpu")


def test_rios_spatial_driver_matches_jax(tmp_path, rng, small_tiles,
                                         fake_rios):
    """The RIOS spatial driver (point accumulator, temp RAT) equals the
    JAX package's; a streaming user function is refused."""
    segpath, imgpath, _, _ = make_seg_and_img(tmp_path, rng)
    got, want = (copy_seg(segpath, tmp_path, n) for n in ("got", "want"))
    cols = [("edge", rio.GFT_Integer)]
    tilingstats.calcPerSegmentSpatialStatsRIOS(
        imgpath, 1, got, cols, tilingstats.userFuncNumEdgePixels, True)
    jax_tilingstats.calcPerSegmentSpatialStatsRIOS(
        imgpath, 1, want, cols, jax_tilingstats.userFuncNumEdgePixels, True)
    np.testing.assert_array_equal(columns(got, ["edge"])[0],
                                  columns(want, ["edge"])[0])
    with pytest.raises(tilingstats.PyShepSegStatsError):
        tilingstats.calcPerSegmentSpatialStatsRIOS(
            imgpath, 1, got, cols, tilingstats.streamingNumEdgePixels(True))


def _spatial_dict_pipeline(mod, seg, img):
    segSize = np.bincount(seg.ravel(), minlength=6)
    segSize[0] = 0
    segDict, noDataDict = mod.createSegSpatialDataDict(), {}
    pagedRat = mod.createPagedRat()
    sel = np.array([[0, 0, mod.STAT_DTYPE_FLOAT, 0, 0],
                    [1, 0, mod.STAT_DTYPE_FLOAT, 1, 0]], dtype=np.uint32)
    transform = np.array([0, 1, 0, 0, 0, -1], dtype=np.float64)
    mod.accumulateSegSpatial(segDict, noDataDict, 7, seg[:15], img[:15], 0, 0)
    mod.accumulateSegSpatial(segDict, noDataDict, 7, seg[15:], img[15:], 15,
                             0)
    mod.calcStatsForCompletedSegsSpatial(
        segDict, noDataDict, -9999, pagedRat, segSize,
        mod.userFuncMeanCoord, transform, sel, np.zeros(0, np.int64),
        np.zeros(2, np.float64), 7)
    assert segDict == {}
    return pagedRat[0]


def test_spatial_dict_compat_matches_jax(rng):
    seg = rng.integers(1, 5, size=(30, 40)).astype(np.uint32)
    img = rng.integers(1, 50, size=(30, 40)).astype(np.int64)
    img[seg == 2] = 7                     # an all-nodata segment
    got = _spatial_dict_pipeline(tilingstats, seg, img)
    want = _spatial_dict_pipeline(jax_tilingstats, seg, img)
    np.testing.assert_array_equal(got.complete, want.complete)
    np.testing.assert_array_equal(got.floatcols[:, 1:5],
                                  want.floatcols[:, 1:5])
    assert (got.floatcols[:, 2] == -9999).all()


@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_auto_streams_builtins_on_every_device(tmp_path, rng, device):
    """The route is chosen from the device's name alone, so "cuda" is
    asked here without a card: 'auto' and 'host' stream edge pixels and
    variograms up to maxDist 8 on every device (the device engine still
    serves custom torch functions on a CUDA device), and only an explicit
    'device' takes the two built-ins to the box functions."""
    _, imgpath, _, _ = make_seg_and_img(tmp_path, rng, shape=(20, 20),
                                        nseg=3)
    band = rio.open(imgpath).GetRasterBand(1)
    route = tilingstats._spatialRoute
    onCuda = device == "cuda"
    for engine in ("auto", "host"):
        wantDevice = engine == "auto" and onCuda
        for fn, param, halo in [(tilingstats.userFuncNumEdgePixels, True, 1),
                                (tilingstats.userFuncVariogram, 8, 8),
                                (tilingstats.userFuncMeanCoord,
                                 np.zeros(6), 0)]:
            useDevice, streamFn = route(engine, fn, param, device, band)
            assert useDevice == wantDevice
            assert isinstance(streamFn, tilingstats.StreamingSpatialUserFunc)
            assert streamFn.haloPixels == halo
        assert route(engine, tilingstats.userFuncVariogram, 9, device,
                     band) == (wantDevice, None)
        custom = tilingstats.DeviceSpatialUserFunc(_masked_mean_torch)
        assert route(engine, custom, 2.0, device, band) == (wantDevice, None)
    for fn, param in [(tilingstats.userFuncNumEdgePixels, True),
                      (tilingstats.userFuncVariogram, 3)]:
        assert route("device", fn, param, device, band) == (True, None)
    useDevice, streamFn = route("device", tilingstats.userFuncMeanCoord,
                                np.zeros(6), device, band)
    assert useDevice and streamFn is not None
    with pytest.raises(tilingstats.PyShepSegStatsError):
        route("gpu", tilingstats.userFuncNumEdgePixels, True, device, band)
