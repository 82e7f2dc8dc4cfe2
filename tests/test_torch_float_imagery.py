"""Float32 imagery in the port on the CPU: Sentinel-2 bottom-of-atmosphere
reflectance tiles and scenes segment to the labels of the benchmark's
plain float reference (gpubench/reference/segment_f32.py, which imports
nothing of the port nor JAX), with and without fill; K4's plain version
is a serial sum, and leaves out bin 0 where asked. The movers-only apply
has no plain form of its own: on CPU tensors it is merge_apply_reference.
The card's side is in test_torch_cuda.py."""

import json
import os

import numpy as np
import pytest
import torch

from gpubench import landscape as land
from gpubench.reference import segment_f32 as rseg32
from gpubench.reference import stitch as rstitch
from pyshepseg_tpu_torch import io as rio
from pyshepseg_tpu_torch import shepseg, tiling
from pyshepseg_tpu_torch.ops import segreduce
from pyshepseg_tpu_torch.ops.kmeans import TorchKMeans

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NODATA = -9999.0


def _load(*parts):
    with open(os.path.join(ROOT, "gpubench", *parts)) as f:
        return json.load(f)


def reflectance_raster(seed, height, width):
    """The benchmark's float32 Sentinel-2 configuration cut to a small
    grid: its cropland DNs as reflectance (DN - 1000) / 10000 in float32,
    bands B03 B04 B08 (the segmentation bands), (3, height, width)."""
    cfg = _load("configs", "s2-l2a-10m-f32.json")
    cfg["grid"].update(height=height, width=width)
    dn = land.Landscape(cfg, _load("landscapes", "cropland.json")).generate(
        seed, "cpu")
    v = cfg["values"]
    refl = ((dn.to(torch.float32) + float(v["boa_add_offset"])) /
            torch.full((1,), float(v["quantification_value"])))
    return refl[[b - 1 for b in cfg["segmentation"]["bandNumbers"]]]


def centres_of(img, k, seed):
    """k distinct pixels of the image as (k, bands) float32 centres."""
    rng = np.random.default_rng(seed)
    px = np.unique(img.reshape(img.shape[0], -1).T.numpy(), axis=0)
    return px[np.sort(rng.choice(px.shape[0], k, replace=False))].copy()


def with_fill(img, share):
    """The image with its first ``share`` of columns set to the nodata
    value in every band, as at a scene's edge."""
    img = img.clone()
    img[:, :, :int(img.shape[2] * share)] = NODATA
    return img


def check_tile(img, seed):
    c = centres_of(img[:, img[0] != NODATA], 12, seed)
    got = shepseg.doShepherdSegmentation(
        img.numpy(), minSegmentSize=100, maxSpectralDiff="auto",
        imgNullVal=NODATA, kmeansObj=TorchKMeans.from_arrays(c, device="cpu"),
        device="cpu")
    want, counts = rseg32.segment_tile(img, torch.from_numpy(c), NODATA, 100,
                                       rseg32.max_spectral_diff(c))
    assert counts["smallSegmentsEliminated"] > 0
    np.testing.assert_array_equal(got.segimg,
                                  want.numpy().astype(np.uint32))
    assert int(got.segimg.max()) == counts["maxSegId"]
    assert got.singlePixelsEliminated == counts["singlePixelsEliminated"]
    assert got.smallSegmentsEliminated == counts["smallSegmentsEliminated"]
    assert got.elimPasses == counts["elimPasses"]


@pytest.mark.parametrize("seed,shape", [(3, (130, 120)), (11, (100, 90)),
                                        (2 ** 33 + 5, (128, 128))])
def test_float_tile_equals_the_reference(seed, shape):
    check_tile(reflectance_raster(seed, *shape), seed)


@pytest.mark.parametrize("seed,share", [(4, 0.39), (2 ** 32 + 9, 0.7)])
def test_float_tile_with_fill_equals_the_reference(seed, share):
    """A tile whose null segment holds much of it (Landsat's 39 % fill):
    the port leaves that segment out of its sums, which no merge reads."""
    check_tile(with_fill(reflectance_raster(seed, 130, 120), share), seed)


def check_scene(tmp_path, img, seed):
    """A 130 x 120 float32 scene in tiles of 64 / 16 through
    doTiledShepherdSegmentation, against the reference's tiles stitched
    by the reference's stitch."""
    h, w, tile, overlap = 130, 120, 64, 16
    c = centres_of(img[:, img[0] != NODATA], 12, seed)
    inpath, outpath = str(tmp_path / "in.npseg"), str(tmp_path / "out.npseg")
    ds = rio.create(inpath, w, h, img.shape[0], np.float32)
    for b in range(img.shape[0]):
        band = ds.GetRasterBand(b + 1)
        band.WriteArray(img[b].numpy())
        band.SetNoDataValue(NODATA)
    ds.FlushCache()
    del ds
    res = tiling.doTiledShepherdSegmentation(
        inpath, outpath, tileSize=tile, overlapSize=overlap,
        minSegmentSize=100, maxSpectralDiff="auto",
        kmeansObj=TorchKMeans.from_arrays(c, device="cpu"),
        tileGrid="uniform", device="cpu")
    msd = rseg32.max_spectral_diff(c)
    tiles = {}
    for key, (x, y, xs, ys) in rstitch.grid(h, w, tile, overlap).items():
        out, _ = rseg32.segment_tile(img[:, y:y + ys, x:x + xs].contiguous(),
                                     torch.from_numpy(c), NODATA, 100, msd)
        tiles[key] = out.numpy().astype(np.uint32)
    mosaic, last = rstitch.stitch(tiles, h, w, tile, overlap)
    got = rio.open(outpath).GetRasterBand(1).ReadAsArray()
    np.testing.assert_array_equal(got, mosaic)
    assert res.maxSegId == last


@pytest.mark.parametrize("seed", [5, 2 ** 31 + 3])
def test_float_scene_through_the_tiled_driver_equals_the_reference(
        tmp_path, seed):
    check_scene(tmp_path, reflectance_raster(seed, 130, 120), seed)


def test_float_scene_with_fill_through_the_tiled_driver(tmp_path):
    """As above, with its left 39 % nodata: two of its tiles are mostly
    fill."""
    check_scene(tmp_path, with_fill(reflectance_raster(6, 130, 120), 0.39),
                6)


def _serial(size, index, source, dim):
    """A serial sum in NumPy: each bin from +0.0, one float32 add an
    element in position order."""
    src = np.moveaxis(source.numpy(), dim, 0)
    out = np.zeros((size,) + src.shape[1:], dtype=np.float32)
    for i, k in enumerate(index.numpy()):
        out[k] = out[k] + src[i]
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(out, 0, dim)))


@pytest.mark.parametrize("n,size", [(0, 4), (1, 4), (2, 1), (7, 3),
                                    (1000, 1), (1000, 13), (4097, 4096),
                                    (3000, 60)])
@pytest.mark.parametrize("cols,dim", [(None, 0), (4, 0), (4, 1)])
def test_ordered_sum_plain_is_a_serial_sum(n, size, cols, dim):
    """K4's plain version (and index_sum on the CPU) give the bits of a
    serial NumPy loop, on values whose sums round in float32 and with
    -0.0 among them; a bin that gets only -0.0 reads +0.0."""
    rng = np.random.default_rng(n * 31 + size)
    index = torch.from_numpy(rng.integers(0, size, size=n))
    shape = (n,) if cols is None else ((n, cols) if dim == 0 else (cols, n))
    source = torch.from_numpy(
        (0.3 + 1e-3 * rng.normal(size=shape)).astype(np.float32))
    source.view(-1)[::5] = -0.0
    want = _serial(size, index, source, dim)
    got = segreduce.ordered_sum(size, index, source, dim)
    assert got.dtype == torch.float32
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(segreduce.index_sum(size, index, source, dim), got)


def test_ordered_sum_of_negative_zeros_is_positive_zero():
    got = segreduce.ordered_sum(2, torch.tensor([1, 1]),
                                torch.tensor([-0.0, -0.0]))
    assert torch.equal(got.view(torch.int32),
                       torch.zeros(2, dtype=torch.int32))


def test_reference_sums_are_serial():
    """The reference's host sums are the same serial loop."""
    rng = np.random.default_rng(2)
    index = torch.from_numpy(rng.integers(0, 50, size=3000))
    values = torch.from_numpy((0.2 + 1e-3 * rng.normal(size=(3, 3000))
                               ).astype(np.float32))
    want = _serial(50, index, values, 1)
    assert torch.equal(rseg32.serial_sums(index, values, 50), want)


@pytest.mark.parametrize("n,size,cols,dim", [
    (0, 4, None, 0), (1, 4, None, 0), (1000, 1, 4, 0), (3000, 60, 4, 1),
    (4097, 4096, None, 0), (5000, 3, 3, 0)])
def test_ordered_sum_can_leave_out_bin_0(n, size, cols, dim):
    """With skip_bin0 bin 0 reads +0.0 and every other bin the serial
    sum's bits; most elements fall in bin 0, as a tile's fill does."""
    rng = np.random.default_rng(n + 7 * size)
    index = torch.from_numpy(np.where(rng.random(n) < 0.6, 0,
                                      rng.integers(0, size, size=n)))
    shape = (n,) if cols is None else ((n, cols) if dim == 0 else (cols, n))
    source = torch.from_numpy(
        (0.3 + 1e-3 * rng.normal(size=shape)).astype(np.float32))
    want = _serial(size, index, source, dim)
    want.select(dim, 0).zero_()
    got = segreduce.ordered_sum(size, index, source, dim, skip_bin0=True)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("dtype", [np.float32, np.uint16])
def test_tile_sums_leave_out_the_null_segment_for_floats(dtype):
    """seg_spectral_sums_tile: float row 0 is +0.0 and every other row
    the bits of seg_spectral_sums_planes; integer sums are the same."""
    rng = np.random.default_rng(9)
    seg = torch.from_numpy(rng.integers(0, 40, size=(60, 50)))
    seg[:, :20] = 0
    planes = tuple(torch.from_numpy((rng.random((60, 50)) * 3000).astype(
        dtype)).to(torch.float32 if dtype == np.float32 else torch.int32)
        for _ in range(3))
    want = segreduce.seg_spectral_sums_planes(seg, planes, 40)
    got = segreduce.seg_spectral_sums_tile(seg, planes, 40)
    assert got.dtype == want.dtype
    if dtype == np.float32:
        assert torch.all(got[0] == 0) and bool((want[0] != 0).all())
        want[0] = 0
    assert torch.equal(got, want)
