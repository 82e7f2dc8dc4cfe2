"""The CUDA kernels and the port on the card, against their plain PyTorch
versions and the CPU run, in memory and through the tiled driver. Each
test skips where there is no CUDA device.

This file imports no JAX and uses no conftest fixture, so it also runs on
a machine that has only torch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from pyshepseg_tpu_torch import shepseg, tiling
from pyshepseg_tpu_torch.ops import clump, local_ccl, lut
from torch_parity import (need_cuda, padded_clusters, random_clusters,
                          read_output, voronoi_image, write_raster)

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("block", [32, None])
@pytest.mark.parametrize("four_connected", [True, False])
def test_local_ccl_kernel_matches_plain(block, four_connected):
    need_cuda()
    img = torch.from_numpy(padded_clusters(
        np.random.default_rng(5), (250, 380), 128)).cuda()
    before = local_ccl.local_ccl_blocks.launches
    got = local_ccl.local_ccl_blocks(img, 0, four_connected, block=block)
    want = local_ccl.local_ccl_blocks_reference(img, 0, four_connected,
                                                block=block)
    assert torch.equal(got, want)
    assert local_ccl.local_ccl_blocks.launches == before + 1


def test_local_ccl_kernel_rejects_wrong_dtype():
    need_cuda()
    with pytest.raises(ValueError):
        local_ccl.local_ccl_blocks(
            torch.zeros((64, 64), dtype=torch.int64, device="cuda"), 0, True)


@pytest.mark.parametrize("shape,c", [((1024, 1024), 4096), ((13,), 7),
                                     ((777, 1031), 32768)])
def test_lut_kernel_matches_plain(shape, c):
    need_cuda()
    rng = np.random.default_rng(2)
    idx = torch.from_numpy(rng.integers(0, c, size=shape).astype(
        np.int32)).cuda()
    table = torch.from_numpy(rng.integers(0, 2 ** 32, size=c,
                                          dtype=np.int64)).cuda()
    before = lut.lut_gather.launches
    assert torch.equal(lut.lut_gather(idx, table),
                       lut.lut_gather_reference(idx, table))
    assert lut.lut_gather.launches == before + 1


def _lut_case(rng, n, c, idx_dtype, table_dtype, offset=0):
    """Indices and a table on the card, both sliced at ``offset`` (a view
    whose data pointer is not 16-byte aligned when offset > 0); table
    values use all 32 or 63 bits of the type."""
    hi = 2 ** 31 - 1 if table_dtype == torch.int32 else 2 ** 62
    table = torch.from_numpy(rng.integers(0, hi, size=c + offset)).to(
        "cuda", table_dtype)[offset:]
    idx = torch.from_numpy(rng.integers(0, c, size=n + offset)).to(
        "cuda", idx_dtype)[offset:]
    return idx, table


@pytest.mark.parametrize("route", ["direct", "staged"])
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("table_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("n,c", [(1, 1), (13, 7), (72000, 24000),
                                 (300001, 4096)])
def test_lut_kernel_routes_match_plain(route, idx_dtype, table_dtype, n, c):
    need_cuda()
    idx, table = _lut_case(np.random.default_rng(3), n, c, idx_dtype,
                           table_dtype)
    before = (lut.lut_gather.launches,
              getattr(lut.lut_gather, route + "_launches"))
    got = lut.lut_gather(idx, table, route=route)
    assert got.dtype == table_dtype
    assert torch.equal(got, lut.lut_gather_reference(idx, table))
    assert (lut.lut_gather.launches,
            getattr(lut.lut_gather, route + "_launches")) == (
                before[0] + 1, before[1] + 1)


def test_lut_kernel_takes_a_large_table():
    """100 000 entries: above the JAX kernel's table and above shared
    memory, so the direct route serves it at any reuse."""
    need_cuda()
    idx, table = _lut_case(np.random.default_rng(4), 2 ** 22, 100000,
                           torch.int32, torch.int64)
    before = lut.lut_gather.direct_launches
    assert torch.equal(lut.lut_gather(idx, table),
                       lut.lut_gather_reference(idx, table))
    assert lut.lut_gather.direct_launches == before + 1


@pytest.mark.parametrize("route", ["direct", "staged"])
@pytest.mark.parametrize("table_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_lut_kernel_misaligned_views(route, table_dtype, offset):
    need_cuda()
    for idx_dtype in (torch.int32, torch.int64):
        idx, table = _lut_case(np.random.default_rng(offset), 100003, 5001,
                               idx_dtype, table_dtype, offset=offset)
        assert torch.equal(lut.lut_gather(idx, table, route=route),
                           lut.lut_gather_reference(idx, table))


def test_lut_kernel_rejects_float_table():
    need_cuda()
    idx = torch.zeros(8, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError):
        lut.lut_gather(idx, torch.zeros(16, device="cuda"))


def test_lut_kernel_rejects_staging_an_oversize_table():
    need_cuda()
    idx = torch.zeros(8, dtype=torch.int32, device="cuda")
    table = torch.zeros(lut.smem_limit("cuda") // 4, dtype=torch.int32,
                        device="cuda")
    with pytest.raises(ValueError):
        lut.lut_gather(idx, table, route="staged")


@pytest.mark.parametrize("four_connected", [True, False])
def test_clump_on_card_matches_cpu(four_connected):
    need_cuda()
    clusters = random_clusters(np.random.default_rng(9), (300, 421))
    got, n_got = clump.clump(clusters, 0, four_connected, device="cuda")
    want, n_want = clump.clump(clusters, 0, four_connected, device="cpu")
    assert n_got == n_want
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("four_connected,min_size", [(True, 20), (False, 1)])
def test_segmentation_on_card_matches_cpu(four_connected, min_size):
    need_cuda()
    img, _ = voronoi_image(np.random.default_rng(5), shape=(200, 240))
    kw = dict(numClusters=12, minSegmentSize=min_size,
              fourConnected=four_connected)
    km = shepseg.fitSpectralClusters(img, 12, 100, None, True, device="cuda")
    before = (local_ccl.local_ccl_blocks.launches, lut.lut_gather.launches)
    got = shepseg.doShepherdSegmentation(img, kmeansObj=km, device="cuda",
                                         **kw)
    assert local_ccl.local_ccl_blocks.launches > before[0]
    assert lut.lut_gather.launches > before[1]
    want = shepseg.doShepherdSegmentation(img, kmeansObj=km, device="cpu",
                                          **kw)
    np.testing.assert_array_equal(got.segimg, want.segimg)
    assert got.singlePixelsEliminated == want.singlePixelsEliminated
    assert got.smallSegmentsEliminated == want.smallSegmentsEliminated


@pytest.mark.parametrize("block", [32, 128, (256, 256), (128, 256), (40, 72)])
@pytest.mark.parametrize("pattern", ["uniform", "stripes", "checker",
                                     "columns", "spiral"])
def test_local_ccl_kernel_under_contention(block, pattern):
    """Shapes that stress the union-find: one component per block (every
    thread hooks into the same tree), long thin components across rows and
    across warp segments, a spiral, and diagonal-only connections
    (8-connected checkerboard)."""
    need_cuda()
    by, bx = (block, block) if isinstance(block, int) else block
    h, w = -(-256 // by) * by, -(-384 // bx) * bx
    yy, xx = np.mgrid[0:h, 0:w]
    img = {"uniform": np.ones_like(yy),
           "stripes": 1 + (yy // 2) % 2,
           "checker": 1 + (yy + xx) % 2,
           "columns": 1 + (xx // 3) % 2,
           "spiral": _spiral(h, w)}[pattern].astype(np.int32)
    img_t = torch.from_numpy(img).cuda()
    for four_connected in (True, False):
        got = local_ccl.local_ccl_blocks(img_t, 0, four_connected,
                                         block=block)
        want = local_ccl.local_ccl_blocks_reference(img_t, 0, four_connected,
                                                    block=block)
        assert torch.equal(got, want)


def _spiral(h, w):
    """A one-pixel-wide spiral of 1s on 2s."""
    img = np.full((h, w), 2)
    y0, x0, y1, x1 = 0, 0, h - 1, w - 1
    while y0 <= y1 and x0 <= x1:
        img[y0, x0:x1 + 1] = 1
        img[y0:y1 + 1, x1] = 1
        if y1 - y0 >= 2:
            img[y1, x0:x1 + 1] = 1
        if x1 - x0 >= 2:
            img[y0 + 2:y1 + 1, x0] = 1
        y0, x0, y1, x1 = y0 + 2, x0 + 2, y1 - 2, x1 - 2
    return img


@pytest.mark.parametrize("block", [(256, 256), (128, 256), (64, 64),
                                   (40, 72), (8, 8), (104, 64)])
@pytest.mark.parametrize("four_connected", [True, False])
def test_local_ccl_kernel_block_shapes(block, four_connected):
    """Every block shape K1 takes: BLOCK, 256 x 256, non-square and
    non-power-of-two blocks (a small image's one block), ragged images
    padded to whole blocks; one launch each."""
    need_cuda()
    by, bx = block
    shape = (3 * by - 5, 2 * bx + 3)
    padded = np.zeros((-(-shape[0] // by) * by, -(-shape[1] // bx) * bx),
                      np.int32)
    padded[:shape[0], :shape[1]] = random_clusters(
        np.random.default_rng(6), shape)
    img = torch.from_numpy(padded).cuda()
    before = local_ccl.local_ccl_blocks.launches
    got = local_ccl.local_ccl_blocks(img, 0, four_connected, block=block)
    want = local_ccl.local_ccl_blocks_reference(img, 0, four_connected,
                                                block=block)
    assert torch.equal(got, want)
    assert local_ccl.local_ccl_blocks.launches == before + 1


def test_local_ccl_occupancy():
    need_cuda()
    threads, smem, per_sm = local_ccl.occupancy((128, 128))
    assert (threads, smem) == (512, local_ccl.shared_bytes(128, 128))
    assert per_sm >= 1
    threads, smem, per_sm = local_ccl.occupancy((256, 256), False)
    assert smem == 3 * 256 * 256 and per_sm >= 1


@pytest.mark.parametrize("two_level", [None, False])
@pytest.mark.parametrize("four_connected", [True, False])
def test_clump_labels_on_card_matches_cpu(two_level, four_connected):
    """The two-level merge and the sweeps on the card, each equal to the
    CPU run, with K1 launched once a call."""
    need_cuda()
    clusters = torch.from_numpy(random_clusters(
        np.random.default_rng(12), (300, 421), nclusters=2).astype(np.int32))
    before = local_ccl.local_ccl_blocks.launches
    stats = {}
    got = clump.clump_labels(clusters.cuda(), 0, four_connected,
                             two_level=two_level, stats=stats)
    assert local_ccl.local_ccl_blocks.launches == before + 1
    want = clump.clump_labels(clusters, 0, four_connected,
                              two_level=two_level)
    assert torch.equal(got[0].cpu(), want[0])
    assert got[1] == want[1]
    assert stats["two_level"] == (two_level is None)
    assert not stats["fallback"]


def test_clump_labels_on_card_falls_back():
    """A seed that is not block-converged: the verify fails on the card
    too, and the sweeps give the CPU's answer."""
    need_cuda()
    clusters = torch.from_numpy(random_clusters(
        np.random.default_rng(13), (260, 300), nclusters=2).astype(np.int32))

    def own_index(img, ignore_val, four_connected, block=None):
        flat = torch.arange(img.numel(), dtype=torch.int32,
                            device=img.device).reshape(img.shape)
        return torch.where(img != ignore_val, flat, local_ccl.INT32_MAX)

    stats = {}
    got = clump.clump_labels(clusters.cuda(), 0, True, local_ccl=own_index,
                             stats=stats)
    want = clump.clump_labels(clusters, 0, True, two_level=False)
    assert stats["fallback"] and stats["sweeps"] > 0
    assert torch.equal(got[0].cpu(), want[0])


def _tiled(tmp_path, name, km, device, **kw):
    """A tiled run of the raster ``in.npseg`` in 4 x 3 tiles; returns
    (result, (segment band, RAT histogram))."""
    out = str(tmp_path / (name + ".npseg"))
    res = tiling.doTiledShepherdSegmentation(
        str(tmp_path / "in.npseg"), out, tileSize=128, overlapSize=32,
        minSegmentSize=20, numClusters=12, kmeansObj=km, device=device,
        **kw)
    return res, read_output(out)


def _tiled_case(tmp_path):
    """Write a 300x340 3-band raster; returns k-means fitted on the CPU."""
    img, _ = voronoi_image(np.random.default_rng(4), shape=(300, 340),
                           ncentres=30)
    write_raster(str(tmp_path / "in.npseg"), img)
    return shepseg.fitSpectralClusters(img, 12, 100, None, True,
                                       device="cpu")


def test_tiled_on_card_matches_cpu(tmp_path):
    need_cuda()
    km = _tiled_case(tmp_path)
    before = (local_ccl.local_ccl_blocks.launches, lut.lut_gather.launches)
    got, (seg_g, hist_g) = _tiled(tmp_path, "card", km, "cuda")
    assert local_ccl.local_ccl_blocks.launches >= before[0] + 12
    assert lut.lut_gather.launches > before[1]
    want, (seg_w, hist_w) = _tiled(tmp_path, "cpu", km, "cpu")
    np.testing.assert_array_equal(seg_g, seg_w)
    np.testing.assert_array_equal(hist_g, hist_w)
    assert got.maxSegId == want.maxSegId
    assert got.hasEmptySegments == want.hasEmptySegments


def test_tiled_threads_on_card_match_serial(tmp_path):
    need_cuda()
    km = _tiled_case(tmp_path)
    want, (seg_w, hist_w) = _tiled(tmp_path, "none", km, "cuda")
    cfg = tiling.SegmentationConcurrencyConfig(
        concurrencyType=tiling.CONC_THREADS, numWorkers=2,
        workerDevices='all', tileCompletionTimeout=300)
    got, (seg_g, hist_g) = _tiled(tmp_path, "threads", km, "cuda",
                                  concurrencyCfg=cfg)
    np.testing.assert_array_equal(seg_g, seg_w)
    np.testing.assert_array_equal(hist_g, hist_w)
    assert got.maxSegId == want.maxSegId


def test_tiled_threads_with_tf32_on_match_serial(tmp_path):
    """With the user's TF32 on, the worker threads' k-means products stay
    full float32 (one thread leaving must not turn TF32 back on under
    another), and the user's setting is back afterwards."""
    need_cuda()
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        km = _tiled_case(tmp_path)
        want, (seg_w, hist_w) = _tiled(tmp_path, "none", km, "cuda")
        torch.backends.cuda.matmul.allow_tf32 = True
        cfg = tiling.SegmentationConcurrencyConfig(
            concurrencyType=tiling.CONC_THREADS, numWorkers=4,
            tileCompletionTimeout=300)
        got, (seg_g, hist_g) = _tiled(tmp_path, "threads", km, "cuda",
                                      concurrencyCfg=cfg)
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    np.testing.assert_array_equal(seg_g, seg_w)
    np.testing.assert_array_equal(hist_g, hist_w)
    assert got.maxSegId == want.maxSegId


# ------------------------------------------------ the stats engine


_STATS_DTYPES = {np.uint8: (0, 256), np.uint16: (0, 65536),
                 np.int8: (-128, 128), np.int16: (-32768, 32768),
                 np.int32: (-2 ** 31, 2 ** 31 - 1)}


@pytest.mark.parametrize("segBase", [0, 70000])
@pytest.mark.parametrize("dtype", sorted(_STATS_DTYPES, key=str))
def test_compaction_on_card_matches_cpu(dtype, segBase):
    """Every supported imagery dtype, segment ids below and above 0xFFFF,
    one band and three: the card's runs equal the CPU's."""
    need_cuda()
    from pyshepseg_tpu_torch.ops import segstats
    rng = np.random.default_rng(6)
    seg = (rng.integers(1, 200, size=(300, 310)) + segBase).astype(np.uint32)
    seg[rng.random(seg.shape) < 0.1] = 0
    lo, hi = _STATS_DTYPES[dtype]
    bands = [rng.integers(lo, hi, size=seg.shape).astype(dtype)
             for _ in range(3)]
    bands[0][:, :40] = bands[0][0, 0]
    nulls = [int(bands[0][0, 0]), None, int(bands[2][5, 5])]
    numSeg = int(seg.max()) + 1
    before = segstats.windowRuns.cuda_calls
    got = segstats.compactTileDeviceMultiBand(seg, bands, nulls, numSeg,
                                              device="cuda")
    assert segstats.windowRuns.cuda_calls == before + 1
    want = segstats.compactTileDeviceMultiBand(seg, bands, nulls, numSeg,
                                               device="cpu")
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            if b is None:
                assert a is None
            else:
                np.testing.assert_array_equal(a, b)


def _stats_rasters(tmp_path):
    """A 300x340 segmentation (Voronoi cells, a null strip, Histogram
    column) and a 3-band uint16 image with a nodata value on band 1."""
    from pyshepseg_tpu_torch import io as rio
    rng = np.random.default_rng(8)
    _, cells = voronoi_image(rng, shape=(300, 340), ncentres=60)
    seg = (cells + 1).astype(np.uint32)
    seg[:5] = 0
    segpath = str(tmp_path / "seg.npseg")
    ds = rio.create(segpath, 340, 300, 1, np.uint32)
    ds.GetRasterBand(1).WriteArray(seg)
    hist = np.bincount(seg.ravel()).astype(np.float64)
    hist[0] = 0
    rat = ds.GetRasterBand(1).GetDefaultRAT()
    rat.CreateColumn("Histogram", rio.GFT_Real, rio.GFU_PixelCount)
    rat.WriteArray(hist, 0)
    img = rng.integers(0, 3000, size=(3, 300, 340)).astype(np.uint16)
    img[0, rng.random((300, 340)) < 0.05] = 7
    imgpath = str(tmp_path / "img.npseg")
    write_raster(imgpath, img)
    rio.open(imgpath, rio.GA_Update).GetRasterBand(1).SetNoDataValue(7)
    return segpath, imgpath


def _rat_cols(path, names):
    from pyshepseg_tpu_torch import io as rio
    rat = rio.open(path).GetRasterBand(1).GetDefaultRAT()
    have = [rat.GetNameOfCol(i) for i in range(rat.GetColumnCount())]
    return [rat.ReadAsArray(have.index(n)) for n in names]


def test_stats_feeds_on_card_match_host(tmp_path, monkeypatch):
    """The scene-resident feed and the per-tile feed (two read workers)
    on the card write the host engine's columns."""
    need_cuda()
    from pyshepseg_tpu_torch import tilingstats
    monkeypatch.setattr(tiling, "TILESIZE", 128)
    segpath, imgpath = _stats_rasters(tmp_path)
    stats = [("mn", "min"), ("mean", "mean"), ("sd", "stddev"),
             ("med", "median"), ("mode", "mode"), ("p0", "percentile", 0),
             ("n", "pixcount")]
    names = []
    for run, engine, fraction, workers in [
            ("scene", "device", 0.25, 0), ("tiles", "device", 0, 2),
            ("host", "host", 0.25, 0)]:
        monkeypatch.setattr(tiling, "SCENE_CACHE_HBM_FRACTION", fraction)
        sel = [[(run + str(b) + s[0],) + s[1:] for s in stats]
               for b in (1, 2, 3)]
        res = tilingstats.calcPerSegmentStatsTiledMultiBand(
            imgpath, [1, 2, 3], segpath, sel, numReadWorkers=workers,
            engine=engine, device="cuda")
        assert ("compaction" in res.timings.makeSummaryDict()) == (
            run == "scene")
        names.append([s[0] for band in sel for s in band])
    scene, tiles, host = (_rat_cols(segpath, n) for n in names)
    for a, b, c in zip(scene, tiles, host):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, c)


@pytest.mark.parametrize("four", [True, False])
def test_spatial_box_functions_on_card_match_cpu(four):
    need_cuda()
    from pyshepseg_tpu_torch.ops import spatialstats as sps
    rng = np.random.default_rng(9)
    masks = torch.from_numpy(rng.random((6, 64, 128)) < 0.7)
    vals = torch.from_numpy(rng.integers(0, 3000, size=(6, 64, 128)).astype(
        np.float32))
    assert torch.equal(sps.edge_pixel_counts(masks.cuda(), four).cpu(),
                       sps.edge_pixel_counts(masks, four))
    cnt_g, sum_g = sps.variogram_sums(vals.cuda(), masks.cuda(), 4)
    cnt_c, sum_c = sps.variogram_sums(vals, masks, 4)
    assert torch.equal(cnt_g.cpu(), cnt_c)
    # float32 sums in another order: PARITY.md deviation 6 (~1e-5)
    np.testing.assert_allclose(sum_g.cpu().numpy(), sum_c.numpy(),
                               rtol=1e-5)


def test_spatial_device_engine_on_card_matches_cpu(tmp_path):
    """Edge pixels and variograms through the device engine's box
    functions on the card equal the CPU run."""
    need_cuda()
    from pyshepseg_tpu_torch import io as rio, tilingstats
    segpath, imgpath = _stats_rasters(tmp_path)
    for device in ("cuda", "cpu"):
        tilingstats.calcPerSegmentSpatialStatsTiled(
            imgpath, 1, segpath, [("e_" + device, rio.GFT_Integer)],
            tilingstats.userFuncNumEdgePixels, True, engine="device",
            device=device)
        tilingstats.calcPerSegmentSpatialStatsTiled(
            imgpath, 1, segpath, [("v1_" + device, rio.GFT_Real),
                                  ("v2_" + device, rio.GFT_Real)],
            tilingstats.userFuncVariogram, 2, engine="device",
            device=device)
    e_g, e_c, v_g, v_c = _rat_cols(segpath, ["e_cuda", "e_cpu", "v2_cuda",
                                             "v2_cpu"])
    np.testing.assert_array_equal(e_g, e_c)
    np.testing.assert_allclose(v_g, v_c, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("fixed", [True, False])
def test_kmeans_fit_on_card_is_reproducible(fixed):
    """Two fits of the same points on the card, fixed init or k-means++
    from one seed, give centres equal bit for bit (the per-cluster float
    sums are order-fixed), and inertia and iterations equal too."""
    need_cuda()
    from pyshepseg_tpu_torch.ops import kmeans
    rng = np.random.default_rng(12)
    centres = rng.uniform(0, 4000, size=(60, 4))
    x = (centres[rng.integers(0, 60, size=300000)] +
         rng.normal(0, 40, size=(300000, 4))).astype(np.float32)
    init = shepseg.diagonalClusterCentres(x, 60) if fixed else "k-means++"
    fits = [kmeans.TorchKMeans(n_clusters=60, n_init=1 if fixed else 2,
                               init=init, random_state=3,
                               device="cuda").fit(x) for _ in range(2)]
    assert np.array_equal(fits[0].cluster_centers_,
                          fits[1].cluster_centers_)
    assert fits[0].inertia_ == fits[1].inertia_
    assert fits[0].n_iter_ == fits[1].n_iter_ > 1


def test_float_image_segments_the_same_twice_on_card():
    """A float32 image, its k-means fitted inside each call: two calls on
    the card give the same segimg (order-fixed k-means, spectral and
    graph-pass sums)."""
    need_cuda()
    img, _ = voronoi_image(np.random.default_rng(6), shape=(768, 640),
                           ncentres=300, noise=60)
    img = img.astype(np.float32) + np.float32(0.37)
    kw = dict(numClusters=30, clusterSubsamplePcnt=50, minSegmentSize=30,
              fixedKMeansInit=True, device="cuda")
    a = shepseg.doShepherdSegmentation(img, **kw)
    b = shepseg.doShepherdSegmentation(img, **kw)
    assert a.smallSegmentsEliminated > 0
    np.testing.assert_array_equal(a.kmeans.cluster_centers_,
                                  b.kmeans.cluster_centers_)
    np.testing.assert_array_equal(a.segimg, b.segimg)


def test_timing_helpers_on_card():
    need_cuda()
    img, _ = voronoi_image(np.random.default_rng(2), shape=(256, 256))
    km = shepseg.fitSpectralClusters(img, 12, 100, None, True,
                                     device="cuda")
    mpix = shepseg.deviceResidentThroughput(img, km, 'auto', repeats=2)
    secs, rtt = shepseg.deviceOnlySeconds(img, km, 'auto', k=2, repeats=2)
    for v in (mpix, secs, rtt):
        assert np.isfinite(v) and v > 0


def test_spatial_auto_streams_on_card(tmp_path):
    """'auto' on the card takes the halo streaming route for the two
    built-ins and writes the box route's columns (edges exact, variograms
    rtol 1e-5)."""
    need_cuda()
    from pyshepseg_tpu_torch import io as rio, tilingstats
    segpath, imgpath = _stats_rasters(tmp_path)
    band = rio.open(imgpath).GetRasterBand(1)
    for fn, param in [(tilingstats.userFuncNumEdgePixels, True),
                      (tilingstats.userFuncVariogram, 2)]:
        useDevice, streamFn = tilingstats._spatialRoute(
            "auto", fn, param, "cuda", band)
        assert useDevice and streamFn is not None
    for engine in ("auto", "device"):
        tilingstats.calcPerSegmentSpatialStatsTiled(
            imgpath, 1, segpath, [("e_" + engine, rio.GFT_Integer)],
            tilingstats.userFuncNumEdgePixels, True, engine=engine)
        tilingstats.calcPerSegmentSpatialStatsTiled(
            imgpath, 1, segpath, [("v1_" + engine, rio.GFT_Real),
                                  ("v2_" + engine, rio.GFT_Real)],
            tilingstats.userFuncVariogram, 2, engine=engine)
    e_a, e_d, v_a, v_d = _rat_cols(segpath, ["e_auto", "e_device", "v2_auto",
                                             "v2_device"])
    np.testing.assert_array_equal(e_a, e_d)
    np.testing.assert_array_equal(v_a == -9999, v_d == -9999)
    np.testing.assert_allclose(v_a, v_d, rtol=1e-5, atol=1e-3)
