"""
Set-up shared by the jobs: the device and the program's kernels, the
scene from the seed, the input rasters, the centres and the warm-up; and
the small statistics of the window (rate, p95).
"""

import glob
import math
import os

import numpy as np
import torch

from . import centres as kmeans
from . import landscape as land
from .reference import stitch as rstitch


def start(run):
    """Initialise the device and load (building on the first run in a
    checkout) the program's kernel library and host library. The
    compile's seconds are a part of their own, ``compile``."""
    with run.part("import_port"):
        from pyshepseg_tpu_torch import _kernels, native, tiling  # noqa
    if run.device.type == "cuda":
        with run.part("cuda_init"):
            torch.zeros(1, device=run.device)
        with run.part("kernels"):
            run.parts["compile"] = _kernels.build()
            _kernels.lib()
    with run.part("kernels"):
        native.available()


def scene(run, keys=False):
    """The cell's scene (uint16 (bands, H, W) on the device) from the
    seed; with ``keys`` also its patch keys."""
    with run.part("generate"):
        gen = land.Landscape(run.config, run.landscape)
        return gen.generate(run.seed, run.device, keys=keys)


def segmentation(run):
    return run.config["segmentation"]


def seg_band_index(run):
    """0-based indices of the segmentation bands."""
    return [b - 1 for b in segmentation(run)["bandNumbers"]]


def write_image(run, path, img):
    """Write the (bands, H, W) scene as the program's raster format,
    with the configuration's nodata on every band."""
    from pyshepseg_tpu_torch import io as rio
    nb, h, w = img.shape
    px = run.config["grid"]["pixel_size_m"]
    with run.part("write"):
        ds = rio.create(path, w, h, nb, np.uint16)
        ds.SetGeoTransform((0.0, px, 0.0, 0.0, 0.0, -px))
        for b in range(nb):
            band = ds.GetRasterBand(b + 1)
            band.WriteArray(img[b].cpu().numpy())
            band.SetNoDataValue(run.config["nodata"])
        ds.FlushCache()
        del ds
    count_mapped(run, path)


def write_segments(run, path, ids):
    """Write a (H, W) segment-id tensor as a thematic uint32 raster with
    its 'Histogram' column, ready for the statistics pass."""
    from pyshepseg_tpu_torch import io as rio
    h, w = ids.shape
    px = run.config["grid"]["pixel_size_m"]
    with run.part("write"):
        hist = torch.bincount(ids.reshape(-1)).cpu().numpy().astype(
            np.float64)
        hist[0] = 0
        ds = rio.create(path, w, h, 1, np.uint32)
        ds.SetGeoTransform((0.0, px, 0.0, 0.0, 0.0, -px))
        band = ds.GetRasterBand(1)
        band.WriteArray(ids.to(torch.int32).cpu().numpy().view(np.uint32))
        band.SetNoDataValue(0)
        band.SetMetadataItem("LAYER_TYPE", "thematic")
        rat = band.GetDefaultRAT()
        rat.SetRowCount(len(hist))
        rat.CreateColumn("Histogram", rio.GFT_Real, rio.GFU_PixelCount)
        rat.WriteArray(hist, rat.GetColumnCount() - 1)
        ds.FlushCache()
        del ds
    count_mapped(run, path)


def fit(run, img):
    """The benchmark's centres (numpy float32 (K, bands)) and the
    program's k-means object holding them."""
    from pyshepseg_tpu_torch.ops.kmeans import TorchKMeans
    seg, km = segmentation(run), run.config["kmeans"]
    with run.part("centres"):
        c = kmeans.fit_centres(img, seg_band_index(run), run.config["nodata"],
                               seg["numClusters"], km["subsample"],
                               km["iterations"], run.seed)
    return c, TorchKMeans.from_arrays(c, device=str(run.device))


def tile_grid(run):
    """{(col, row): (x, y, xsize, ysize)} of the configuration's grid."""
    seg, grid = segmentation(run), run.config["grid"]
    if seg.get("tileGrid", "uniform") != "uniform":
        raise ValueError("only the uniform tile grid is benchmarked")
    return rstitch.grid(grid["height"], grid["width"], seg["tileSize"],
                        seg["overlapSize"])


def segment_one(run, tile, km):
    """One ``doShepherdSegmentation`` of a tile with the configuration's
    settings (the warm-up, and the tile job's call)."""
    from pyshepseg_tpu_torch import shepseg
    seg = segmentation(run)
    return shepseg.doShepherdSegmentation(
        tile, minSegmentSize=seg["minSegmentSize"],
        maxSpectralDiff=seg["maxSpectralDiff"],
        imgNullVal=run.config["nodata"], fourConnected=seg["fourConnected"],
        kmeansObj=km, spectDistPcntile=seg["spectDistPcntile"],
        device=str(run.device))


def host_tile(run, img, x, y, xs, ys):
    """The segmentation bands of one window of the scene, as a host
    numpy array (bands, ys, xs)."""
    return np.stack([img[b, y:y + ys, x:x + xs].cpu().numpy()
                     for b in seg_band_index(run)])


def warm_tile(run, img, km):
    """Warm the per-tile path up on one tile of the cell's own shape."""
    tile = host_tile(run, img, *tile_grid(run)[(0, 0)])
    with run.part("warmup"):
        segment_one(run, tile, km)


def totals(timings):
    """{interval: total seconds} of a program's Timers."""
    return {k: v["total"] for k, v in timings.makeSummaryDict().items()}


def p95(values):
    """The 95th percentile by nearest rank (the smallest value with at
    least 95 % of the values at or below it)."""
    ordered = sorted(values)
    return ordered[max(0, math.ceil(0.95 * len(ordered)) - 1)]


def release(run):
    """Drop the program's state and cached device memory."""
    run.state.pop("km", None)
    if run.device.type == "cuda":
        torch.cuda.empty_cache()


def path(run, name):
    return os.path.join(run.workdir, name)


def count_mapped(run, raster):
    """Add to the run's reckoning of bytes written the band and overview
    files of a ``.npseg`` raster just written: they are written through
    memory maps, which the process's write count does not see."""
    n = sum(os.path.getsize(f) for pat in ("band_*.npy", "ovr_*.npy")
            for f in glob.glob(os.path.join(raster, pat)))
    run.counters["mapped_bytes"] = run.counters.get("mapped_bytes", 0) + n
