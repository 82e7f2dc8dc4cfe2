"""The landscape generator: deterministic by seed, patch sizes and the
Landsat fill share as the configurations and landscapes state."""

import json
import os

import numpy as np
import pytest
import torch

from gpubench.bench import CHECKOUT
from gpubench import centres, landscape

CPU = torch.device("cpu")


def load(kind, name):
    with open(os.path.join(CHECKOUT, "gpubench", kind, name + ".json")) as f:
        return json.load(f)


def small(config, land, size):
    cfg = load("configs", config)
    grid = cfg["grid"]
    if cfg.get("footprint"):
        fp = cfg["footprint"]
        fp["width"] *= size / grid["width"]
        fp["height"] *= size / grid["height"]
    grid["width"] = grid["height"] = size
    return landscape.Landscape(cfg, load("landscapes", land))


def test_same_seed_same_scene_other_seed_other_scene():
    gen = small("s2-l2a-10m", "cropland", 256)
    a, ka = gen.generate(2 ** 31 + 7, CPU, keys=True)
    b, kb = gen.generate(2 ** 31 + 7, CPU, keys=True)
    c = gen.generate(2 ** 31 + 8, CPU)
    assert torch.equal(a, b) and torch.equal(ka, kb)
    assert not torch.equal(a, c)
    assert a.dtype == torch.uint16 and a.shape == (4, 256, 256)
    # DN = reflectance * 10000 + 1000 over land-cover reflectances
    assert 1 <= int(a.int().min()) and int(a.int().max()) < 8000


@pytest.mark.parametrize("config,land,size,mean_px,lo,hi", [
    # fields of about 4 ha at 10 m
    ("s2-l2a-10m", "cropland", 1536, 400, 0.75, 1.25),
    # patches of about 100 ha at 30 m
    ("landsat-c2l2-30m", "rangeland", 2048, 1111, 0.7, 1.3),
])
def test_patch_size_mean(config, land, size, mean_px, lo, hi):
    gen = small(config, land, size)
    _, keys = gen.generate(3, CPU, keys=True)
    ids, n = landscape.patch_ids(keys)
    sizes = torch.bincount(ids.reshape(-1))[1:].double()
    assert lo * mean_px <= float(sizes.mean()) <= hi * mean_px
    assert n == int((sizes > 0).sum())


@pytest.mark.parametrize("config,land", [
    ("s2-l2a-10m", "cropland"), ("landsat-c2l2-30m", "rangeland")])
def test_texture_is_the_sensor_noise(config, land):
    """Within a patch, away from its boundary, a band varies by the
    sensor's noise alone: the configuration's SNR as reflectance."""
    gen = small(config, land, 512)
    img, keys = gen.generate(2 ** 31 + 3, CPU, keys=True)
    # pixels whose 5 x 5 neighbourhood is one patch
    k = torch.nn.functional.pad(keys[None].double(), (2, 2, 2, 2),
                                mode="replicate")[0]
    inner = torch.ones_like(keys, dtype=torch.bool)
    for dy in range(5):
        for dx in range(5):
            inner &= k[dy:dy + 512, dx:dx + 512] == keys
    inner &= keys >= 0
    ids, n = landscape.patch_ids(torch.where(inner, keys, -1))
    flat = ids.reshape(-1)
    cnt = torch.bincount(flat, minlength=n + 1).double().clamp_min(1)
    cfg = load("configs", config)
    dn = cfg["values"]["dn_per_reflectance"]
    for b, band in enumerate(cfg["bands"]):
        v = img[b].reshape(-1).double()
        mean = torch.zeros(n + 1, dtype=torch.float64).index_add_(
            0, flat, v) / cnt
        resid = (v - mean[flat])[flat > 0]
        want = landscape.noise_sigma(band) * dn
        # the per-patch mean takes one degree of freedom of some hundreds
        assert 0.93 * want < float(resid.std()) < 1.07 * want, band


def test_boundary_pixels_mix_by_area():
    """Only pixels that a boundary crosses mix two spectra: with the
    noise off, every pixel whose 3 x 3 neighbourhood is one patch has its
    patch's value."""
    cfg = load("configs", "s2-l2a-10m")
    for band in cfg["bands"]:
        band["lref"] = 0
    cfg["grid"]["width"] = cfg["grid"]["height"] = 256
    gen = landscape.Landscape(cfg, load("landscapes", "cropland"))
    img, keys = gen.generate(9, CPU, keys=True)
    k = torch.nn.functional.pad(keys[None].double(), (1, 1, 1, 1),
                                mode="replicate")[0]
    inner = torch.ones_like(keys, dtype=torch.bool)
    for dy in range(3):
        for dx in range(3):
            inner &= k[dy:dy + 256, dx:dx + 256] == keys
    # a boundary may pass just outside the scene's edge
    inner[[0, -1], :] = False
    inner[:, [0, -1]] = False
    ids, n = landscape.patch_ids(keys)
    for b in range(img.shape[0]):
        v = img[b].long()
        lo = torch.full((n + 1,), 1 << 20).scatter_reduce(
            0, ids[inner], v[inner], "amin")
        hi = torch.full((n + 1,), -1).scatter_reduce(
            0, ids[inner], v[inner], "amax")
        seen = hi >= 0
        assert bool((lo[seen] == hi[seen]).all())
    # and the boundary pixels hold values between patches'
    assert int((~inner).sum()) > 0


def test_landsat_fill_share():
    cfg = load("configs", "landsat-c2l2-30m")
    gen = landscape.Landscape(cfg, load("landscapes", "rangeland"))
    step = 4
    yy = (torch.arange(0, gen.height, step, dtype=torch.float64) + 0.5)
    xx = (torch.arange(0, gen.width, step, dtype=torch.float64) + 0.5)
    inside = gen._inside(yy[:, None], xx[None, :])
    fill = 1 - float(inside.double().mean())
    fp = cfg["footprint"]
    want = 1 - fp["width"] * fp["height"] / (gen.width * gen.height)
    assert abs(want - 0.3918) < 1e-3
    assert abs(fill - want) < 2e-3


def test_fill_pixels_are_nodata_in_every_band():
    gen = small("landsat-c2l2-30m", "rangeland", 256)
    img, keys = gen.generate(5, CPU, keys=True)
    fill = keys < 0
    assert 0.3 < float(fill.double().mean()) < 0.5
    img = img.int()
    assert bool((img[:, fill] == 0).all()) and bool((img[:, ~fill] > 0).all())


def test_centres_deterministic():
    gen = small("s2-l2a-10m", "cropland", 256)
    img = gen.generate(11, CPU)
    a = centres.fit_centres(img, [1, 2, 3], 0, 60, 20000, 10, 11)
    b = centres.fit_centres(img, [1, 2, 3], 0, 60, 20000, 10, 11)
    assert a.dtype == np.float32 and a.shape == (60, 3)
    assert np.array_equal(a, b)
