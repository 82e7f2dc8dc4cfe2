"""
The segment job on float32 imagery: whole scenes of bottom-of-atmosphere
reflectance through ``tiling.doTiledShepherdSegmentation`` in a closed
loop. The window, its scene lines and the release are ``jobs/segment.py``'s
(imported, not copied); set-up and the check are this file's:

- set-up makes the scene's DNs as ``common.scene`` does and turns them
  into float32 reflectance by the configuration's rule, ``(DN +
  boa_add_offset) / quantification_value`` (the Sentinel-2 L2A rule for
  processing baseline 04.00 and later), divided elementwise in float32 on
  the device, so every value is the float32 nearest a multiple of 10^-4;
  it writes them as a float32 raster with the configuration's nodata,
  fits the centres on the float bands (:func:`fit_centres`) and warms up
  with one whole scene through the window's own call
  (:func:`warm_scene`), so every tile shape, the scene cache and the
  stitch have run once before the window;
- the check is ``jobs/segment.py``'s against ``reference/segment_f32.py``:
  the last scene's output raster pixel for pixel, and every scene's
  'Histogram' column and largest id. The control writes that reference's
  mosaic with the assignment's product in TF32.
"""

import numpy as np
import torch

from gpubench import common
from gpubench.jobs.segment import measure, release, scene_line  # noqa: F401
from gpubench.reference import npseg
from gpubench.reference import segment_f32 as rseg
from gpubench.reference import stitch as rstitch

# float32 reflectance (|x| < 2) lies on multiples of 2^-40 wherever |x| is
# at least 10^-4 (its unit in the last place is 2^-37 or more), so the
# fit's sums are exact in int64 at this scale and do not depend on the
# order of the card's atomics
FIXED = 2.0 ** 40


def reflectance(run, dn):
    """float32 reflectance (bands, H, W) on the device from the uint16
    DNs, by the configuration's ``values`` rule."""
    v = run.config["values"]
    with run.part("reflectance"):
        out = torch.empty(dn.shape, dtype=torch.float32, device=dn.device)
        # a tensor divisor: a Python scalar would multiply by its
        # reciprocal on the card, which is not the correctly rounded quotient
        q = torch.full((1,), float(v["quantification_value"]),
                       dtype=torch.float32, device=dn.device)
        for b in range(dn.shape[0]):
            torch.div(dn[b].to(torch.float32) + float(v["boa_add_offset"]),
                      q, out=out[b])
    return out


def write_image(run, path, img):
    """Write the (bands, H, W) float32 scene as the program's raster
    format, with the configuration's nodata on every band."""
    from pyshepseg_tpu_torch import io as rio
    nb, h, w = img.shape
    px = run.config["grid"]["pixel_size_m"]
    with run.part("write"):
        ds = rio.create(path, w, h, nb, np.float32)
        ds.SetGeoTransform((0.0, px, 0.0, 0.0, 0.0, -px))
        for b in range(nb):
            band = ds.GetRasterBand(b + 1)
            band.WriteArray(img[b].cpu().numpy())
            band.SetNoDataValue(run.config["nodata"])
        ds.FlushCache()
        del ds
    common.count_mapped(run, path)


def fit_centres(img, band_index, nodata, k, subsample, iterations, seed):
    """``centres.fit_centres`` on a float (nbands, H, W) scene: the same
    seeded subsample, initialisation and Lloyd iterations, with the
    per-cluster sums exact in int64 on a 2^-40 grid (raises for values
    off that grid or of 2 or more), so the same seed gives the same
    (k, len(band_index)) float32 centres, as a numpy array."""
    dev = img.device
    gen = torch.Generator(device=dev)
    gen.manual_seed((int(seed) * 7919 + 13) & (2 ** 63 - 1))
    h, w = img.shape[1:]
    flat = torch.randint(0, h * w, (subsample,), generator=gen, device=dev)
    pix = torch.stack([band.reshape(-1)[flat] for band in img])
    valid = ~(pix == nodata).any(dim=0)
    x = pix[band_index].T[valid].to(torch.float64)
    fixed = x * FIXED
    if not (torch.equal(fixed, fixed.round()) and
            bool((x.abs() < 2).all())):
        raise ValueError("values off the 2^-40 grid or of 2 or more")
    fixed = fixed.to(torch.int64)
    uniq = torch.unique(x, dim=0)
    if uniq.shape[0] < k:
        raise ValueError("fewer than %d distinct pixels in the subsample"
                         % k)
    pick = torch.randperm(uniq.shape[0], generator=gen, device=dev)[:k]
    c = uniq[pick.sort().values]
    for _ in range(iterations):
        labels = torch.argmin(torch.cdist(x, c), dim=1)
        counts = torch.bincount(labels, minlength=k).to(torch.float64)
        sums = torch.zeros(c.shape, dtype=torch.int64, device=dev).index_add_(
            0, labels, fixed).to(torch.float64) / FIXED
        c = torch.where(counts[:, None] > 0,
                        sums / counts.clamp_min(1)[:, None], c)
    return c.to(torch.float32).cpu().numpy()


def fit(run, img):
    """The centres and the program's k-means object holding them."""
    from pyshepseg_tpu_torch.ops.kmeans import TorchKMeans
    seg, km = common.segmentation(run), run.config["kmeans"]
    with run.part("centres"):
        c = fit_centres(img, common.seg_band_index(run), run.config["nodata"],
                        seg["numClusters"], km["subsample"], km["iterations"],
                        run.seed)
    return c, TorchKMeans.from_arrays(c, device=str(run.device))


def warm_scene(run):
    """One scene of the window, before it: ``measure`` with no time
    left runs exactly one, whose record is then dropped."""
    seconds, run.seconds = run.seconds, 0
    try:
        with run.part("warmup"):
            measure(run)
    finally:
        run.seconds = seconds
        run.records.clear()


def prepare(run):
    common.start(run)
    img = reflectance(run, common.scene(run))
    run.state["inpath"] = common.path(run, "scene.npseg")
    run.state["outpath"] = common.path(run, "segments.npseg")
    write_image(run, run.state["inpath"], img)
    run.state["centres"], run.state["km"] = fit(run, img)
    del img
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    warm_scene(run)


def reference_mosaic(run, tf32=False):
    """The float reference's mosaic of the input file, and its largest
    id."""
    seg, grid = common.segmentation(run), run.config["grid"]
    bands = [npseg.band(run.state["inpath"], b) for b in seg["bandNumbers"]]
    centres = torch.from_numpy(run.state["centres"]).to(run.device)
    msd = rseg.max_spectral_diff(run.state["centres"],
                                 seg["spectDistPcntile"])
    tiles = {}
    for key, (x, y, xs, ys) in common.tile_grid(run).items():
        img = torch.from_numpy(np.stack(
            [b[y:y + ys, x:x + xs] for b in bands]).astype(np.float32)).to(
                run.device)
        out, _ = rseg.segment_tile(img, centres, run.config["nodata"],
                                   seg["minSegmentSize"], msd, tf32)
        tiles[key] = out.cpu().numpy().astype(np.uint32)
    return rstitch.stitch(tiles, grid["height"], grid["width"],
                          seg["tileSize"], seg["overlapSize"])


def control(run):
    mosaic, last = reference_mosaic(run, tf32=True)
    common.write_segments(run, run.state["outpath"],
                          torch.from_numpy(mosaic.astype(np.int64)))
    run.records = [dict(maxSegId=last, hist=rstitch.histogram(mosaic))]


def verify(run):
    mosaic, last = reference_mosaic(run)
    hist = rstitch.histogram(mosaic)
    got = npseg.band(run.state["outpath"])
    pixels = int(np.count_nonzero(got != mosaic))
    wrong = sum(1 for r in run.records
                if r["maxSegId"] != last or not np.array_equal(r["hist"],
                                                               hist))
    return ([("pixels_differ", pixels, 0), ("scenes_differ", wrong, 0)],
            len(run.records), wrong)
