"""
Seeded synthetic landscapes: a multi-band uint16 scene of land-cover
patches, made on the device from ``--seed`` by one general generator
whose parameters are a landscape file (``landscapes/<name>.json``) and a
configuration (``configs/<config>.json``).

- Patches are the cells of a jittered-grid Voronoi at one of a few
  nested grid spacings (``patch_levels_m``, fine to coarse). Each cell of
  the coarsest grid takes one level from ``level_weights``, blended by a
  smooth seeded field, so the patch density varies smoothly over the
  scene; every patch ends at its coarse cell's boundary. A pixel checks
  the 3 x 3 grid cells around it at each level, so the cost does not
  grow with the number of patches.
- Each patch draws a land-cover class (``classes``: weight and
  reflectance by generic band name) and a per-band offset of
  ``patch_sigma`` from integer hashes of its key.
- A pixel that a patch boundary crosses holds both patches by area: its
  own share is 0.5 plus its centre's distance to the boundary in pixels
  (exact for a boundary along a row or a column).
- Each pixel adds the sensor's noise, Gaussian with the per-band
  reflectance ``noise_sigma(band)`` that the configuration's published
  signal-to-noise ratio gives; nothing else varies within a patch.
- A ``footprint`` in the configuration (size and angle) leaves the rest
  of the grid at the fill value, as a rotated Landsat scene does.

Reflectance becomes DN = (reflectance + ``reflectance_add``) *
``dn_per_reflectance``, rounded and clipped to 1..65535 (0 is nodata).
"""

import math

import numpy as np
import torch

M32 = 0xFFFFFFFF
# odd multipliers below 2**31: products of 32-bit values stay in int64
_C1, _C2 = 0x7FEB352D, 0x6C8E9CF5
# pixels per block of rows: bounds the device memory of the generator
BLOCK_PIXELS = 1 << 22


def _mix(h):
    """A 32-bit integer hash of ``h`` (an int64 tensor or a Python int
    below 2**32)."""
    h = ((h ^ (h >> 16)) * _C1) & M32
    h = ((h ^ (h >> 15)) * _C2) & M32
    return h ^ (h >> 16)


def _salt(seed, *tags):
    """A 32-bit salt from the seed (any size) and integer tags."""
    h = _mix((seed ^ (seed >> 32) ^ (seed >> 64)) & M32)
    for tag in tags:
        h = _mix(h ^ tag)
    return h


def _uniform(h):
    """Floats in (0, 1) from 32-bit hashes."""
    return (h.to(torch.float64) + 0.5) / 4294967296.0


def _normal(h1, h2):
    """Standard normal floats from two 32-bit hashes (Box-Muller)."""
    u1, u2 = _uniform(h1), _uniform(h2)
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2 * math.pi * u2)


def _key_hash(key, salt):
    """A 32-bit hash of an int64 key below 2**62."""
    return _mix(_mix((key & M32) ^ salt) ^ (key >> 32))


class Landscape:
    """The generator for one (configuration, landscape) pair."""

    def __init__(self, config, landscape):
        grid = config["grid"]
        self.height = int(grid["height"])
        self.width = int(grid["width"])
        self.pixel_m = float(grid["pixel_size_m"])
        self.kinds = [b["kind"] for b in config["bands"]]
        values = config["values"]
        self.add = float(values["reflectance_add"])
        self.dn_per_refl = float(values["dn_per_reflectance"])
        self.nodata = int(config["nodata"])
        self.footprint = config.get("footprint")
        self.levels_px = [m / self.pixel_m
                          for m in landscape["patch_levels_m"]]
        self.level_low = np.asarray(landscape["level_weights"]["low"],
                                    dtype=np.float64)
        self.level_high = np.asarray(landscape["level_weights"]["high"],
                                     dtype=np.float64)
        self.field_m = landscape["field_wavelength_m"]
        classes = landscape["classes"]
        names = sorted(classes)
        weights = np.asarray([classes[n]["weight"] for n in names])
        self.class_cum = np.cumsum(weights / weights.sum())
        self.class_refl = np.asarray(
            [[classes[n]["reflectance"][k] for k in self.kinds]
             for n in names], dtype=np.float64)
        self.patch_sigma = float(landscape["patch_sigma"])
        self.noise = [noise_sigma(b) for b in config["bands"]]
        if len(self.levels_px) != len(self.level_low):
            raise ValueError("one level weight a patch level")

    @property
    def nbands(self):
        return len(self.kinds)

    def _field_terms(self, seed):
        """The smooth field's cosines: (kx, ky, phase) in pixel units."""
        rng = np.random.default_rng([seed & M32, seed >> 32, 17])
        terms = []
        for _ in range(4):
            wave = rng.uniform(*self.field_m) / self.pixel_m
            angle = rng.uniform(0, 2 * math.pi)
            terms.append((2 * math.pi * math.cos(angle) / wave,
                          2 * math.pi * math.sin(angle) / wave,
                          rng.uniform(0, 2 * math.pi)))
        return terms

    def _field(self, terms, y, x):
        """The smooth field in [0, 1] at pixel coordinates."""
        acc = torch.zeros_like(y)
        for kx, ky, phase in terms:
            acc = acc + torch.cos(kx * x + ky * y + phase)
        return 0.5 + 0.5 * acc / len(terms)

    def _nearest(self, yy, xx, grid, salt):
        """The two nearest jittered-grid seeds of every pixel: their cell
        ids (flat indices of the padded grid), the nearest's position, the
        distance in pixels to the two seeds' bisector, and the second's
        position."""
        ncols = int(self.width // grid) + 3
        ci = torch.floor(yy / grid).long()
        cj = torch.floor(xx / grid).long()
        inf = torch.full(torch.broadcast_shapes(yy.shape, xx.shape),
                         float("inf"), dtype=yy.dtype, device=yy.device)
        d1, d2 = inf, inf.clone()
        zero = torch.zeros_like(inf, dtype=torch.long)
        id1, id2 = zero, zero.clone()
        y1 = x1 = y2 = x2 = torch.zeros_like(inf)
        for di in (-1, 0, 1):
            for dj in (-1, 0, 1):
                i, j = ci + di, cj + dj
                cell = (i + 1) * ncols + (j + 1)
                h = _mix((cell & M32) ^ salt)
                sy = (i.to(yy.dtype) + _uniform(_mix(h ^ 1)).to(yy.dtype)
                      ) * grid
                sx = (j.to(yy.dtype) + _uniform(_mix(h ^ 2)).to(yy.dtype)
                      ) * grid
                d = (yy - sy) ** 2 + (xx - sx) ** 2
                first = d < d1
                second = ~first & (d < d2)
                d2 = torch.where(first, d1, torch.where(second, d, d2))
                id2 = torch.where(first, id1, torch.where(second, cell, id2))
                y2 = torch.where(first, y1, torch.where(second, sy, y2))
                x2 = torch.where(first, x1, torch.where(second, sx, x2))
                d1 = torch.where(first, d, d1)
                id1 = torch.where(first, cell, id1)
                y1 = torch.where(first, sy, y1)
                x1 = torch.where(first, sx, x1)
        # distance to the bisector of the two seeds
        sep = torch.sqrt((y2 - y1) ** 2 + (x2 - x1) ** 2).clamp_min(1e-6)
        edge = (d2 - d1) / (2 * sep)
        return id1, id2, y1, x1, edge, y2, x2

    def _level(self, cell, sy, sx, terms, low, high, salt):
        """The patch level of coarse cells with seeds at (sy, sx)."""
        f = self._field(terms, sy, sx)[..., None]
        cum = torch.cumsum((1 - f) * low + f * high, dim=-1)
        cum = cum / cum[..., -1:]
        u = _uniform(_mix((cell & M32) ^ salt))[..., None]
        return (u > cum[..., :-1]).sum(dim=-1)

    def _spectra(self, key, salt, dtype):
        """Per-patch reflectance (nbands, ...) of int64 keys."""
        u = _uniform(_key_hash(key, salt))
        cum = torch.as_tensor(self.class_cum, device=key.device)
        cls = torch.searchsorted(cum, u.contiguous()).clamp_max(
            len(self.class_cum) - 1)
        refl = torch.as_tensor(self.class_refl, device=key.device)[cls]
        out = []
        for b in range(self.nbands):
            n = _normal(_key_hash(key, salt ^ (2 * b + 11)),
                        _key_hash(key, salt ^ (2 * b + 12)))
            out.append((refl[..., b] + self.patch_sigma * n).to(dtype))
        return torch.stack(out)

    def _inside(self, yy, xx):
        """The footprint mask, or None when the whole grid is scene."""
        fp = self.footprint
        if not fp:
            return None
        cy, cx = self.height / 2.0, self.width / 2.0
        a = math.radians(fp["angle_deg"])
        u = (xx - cx) * math.cos(a) + (yy - cy) * math.sin(a)
        v = -(xx - cx) * math.sin(a) + (yy - cy) * math.cos(a)
        return (u.abs() <= fp["width"] / 2.0) & (v.abs() <= fp["height"] / 2.0)

    def generate(self, seed, device, keys=False):
        """The scene as a uint16 tensor (nbands, H, W) on ``device``;
        with ``keys`` also the int64 (H, W) patch keys (-1 on fill)."""
        seed = int(seed)
        dt = torch.float32
        H, W = self.height, self.width
        nlev = len(self.levels_px)
        salts = [_salt(seed, 101 + lev) for lev in range(nlev)]
        salt_level = _salt(seed, 201)
        salt_spec = _salt(seed, 301)
        terms = self._field_terms(seed)
        noise = torch.as_tensor(self.noise, device=device, dtype=dt)[
            :, None, None]
        low = torch.as_tensor(self.level_low, device=device)
        high = torch.as_tensor(self.level_high, device=device)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed & (2 ** 63 - 1))
        img = torch.empty((self.nbands, H, W), dtype=torch.uint16,
                          device=device)
        keymap = (torch.empty((H, W), dtype=torch.int64, device=device)
                  if keys else None)
        rows = max(1, BLOCK_PIXELS // W)
        xx = (torch.arange(W, device=device, dtype=dt) + 0.5)[None, :]
        for y0 in range(0, H, rows):
            y1 = min(H, y0 + rows)
            yy = (torch.arange(y0, y1, device=device, dtype=dt) + 0.5)[:, None]
            near = [self._nearest(yy, xx, g, s)
                    for g, s in zip(self.levels_px, salts)]
            top_id, top_id2, top_y, top_x, top_edge, top_y2, top_x2 = (
                near[-1])
            # the level of each coarse cell, and of the nearest other one,
            # from the smooth field at their seeds
            level = self._level(top_id, top_y, top_x, terms, low, high,
                                salt_level)
            level2 = self._level(top_id2, top_y2, top_x2, terms, low, high,
                                 salt_level)
            fine = torch.zeros_like(top_id)
            fine2 = torch.zeros_like(top_id)
            across = torch.zeros_like(top_id)
            edge = torch.zeros_like(top_edge)
            for lev in range(nlev):
                id1, id2, _, _, e = near[lev][:5]
                sel = level == lev
                fine = torch.where(sel, id1, fine)
                fine2 = torch.where(sel, id2, fine2)
                edge = torch.where(sel, e, edge)
                across = torch.where(level2 == lev, id1, across)
            # a patch is a cell of its level's grid within one coarse cell:
            # the nearest boundary is its own grid's or the coarse cell's
            coarse = top_edge <= edge
            edge = torch.minimum(edge, top_edge)
            key = (top_id << 40) | (fine << 2) | level
            other = torch.where(coarse, (top_id2 << 40) | (across << 2) |
                                level2, (top_id << 40) | (fine2 << 2) | level)
            refl = self._spectra(key, salt_spec, dt)
            own = (0.5 + edge).clamp(max=1.0)
            refl = torch.where(own < 1, own * refl + (1 - own) *
                               self._spectra(other, salt_spec, dt), refl)
            refl = refl + noise * torch.randn(
                refl.shape, generator=gen, device=device, dtype=dt)
            dn = torch.round((refl + self.add) * self.dn_per_refl)
            dn = dn.clamp(1, 65535)
            inside = self._inside(yy, xx)
            if inside is not None:
                dn = torch.where(inside, dn, float(self.nodata))
                key = torch.where(inside, key, -1)
            img[:, y0:y1] = dn.to(torch.int32).to(torch.uint16)
            if keys:
                keymap[y0:y1] = key
        return (img, keymap) if keys else img


def noise_sigma(band):
    """The sensor's noise in reflectance of a configuration's band entry:
    the radiance noise at the reference radiance ``lref`` (the radiance
    over its signal-to-noise ratio ``snr``) as reflectance under the
    band's solar irradiance ``esun``, the sun at the zenith."""
    return math.pi * band["lref"] / (band["snr"] * band["esun"])


def patch_ids(keymap):
    """Contiguous patch ids 1..N (uint32-ready int64) of a key map, 0 on
    fill, and N."""
    valid = keymap >= 0
    uniq, inv = torch.unique(keymap[valid], return_inverse=True)
    ids = torch.zeros_like(keymap)
    ids[valid] = inv + 1
    return ids, int(uniq.numel())
