"""
Shared setup of the tests that hold pyshepseg_tpu_torch against
pyshepseg_tpu: inputs made with numpy from a seed, handed to both
packages as numpy arrays. The JAX side runs on the CPU as the JAX
package's own tests run it; the port runs with device="cpu", i.e. the
plain versions of its kernels.
"""

import numpy as np
import pytest
import torch

# one intra-op thread: the suite runs several pytest workers at once
torch.set_num_threads(1)


def need_cuda():
    """Skip the calling test unless a CUDA device is present (decided
    when the test runs, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")


def random_clusters(rng, shape, nclusters=4, null_frac=0.1):
    """Random cluster ids 1..nclusters with ~null_frac null (0) pixels."""
    clusters = rng.integers(1, nclusters + 1, size=shape).astype(np.uint32)
    clusters[rng.random(shape) < null_frac] = 0
    return clusters


def padded_clusters(rng, shape, block):
    """Random int32 clusters zero-padded up to whole blocks of ``block``."""
    clusters = random_clusters(rng, shape).astype(np.int32)
    hp = -(-shape[0] // block) * block
    wp = -(-shape[1] // block) * block
    img = np.zeros((hp, wp), np.int32)
    img[:shape[0], :shape[1]] = clusters
    return img


def voronoi_image(rng, shape=(80, 80), ncentres=12, nbands=3, noise=2):
    """Voronoi cells with distinct colours + slight noise, uint16 (the
    image of tests/test_shepseg.py)."""
    h, w = shape
    centres = rng.uniform(0, [h, w], size=(ncentres, 2))
    yy, xx = np.mgrid[0:h, 0:w]
    d = ((yy[..., None] - centres[:, 0]) ** 2 +
         (xx[..., None] - centres[:, 1]) ** 2)
    true_seg = d.argmin(axis=-1)
    palette = rng.integers(50, 900, size=(ncentres, nbands))
    img = palette[true_seg].transpose(2, 0, 1).astype(np.int64)
    img += rng.integers(-noise, noise + 1, size=img.shape)
    return img.astype(np.uint16), true_seg


def write_raster(path, img):
    """Write a (nBands, H, W) image as a raster through the port's
    raster driver (no JAX, so usable where JAX is absent)."""
    from pyshepseg_tpu_torch import io as rio
    nbands, h, w = img.shape
    ds = rio.create(path, w, h, nbands, img.dtype)
    for b in range(nbands):
        ds.GetRasterBand(b + 1).WriteArray(img[b])
    ds.FlushCache()


def read_output(path):
    """(segment band, RAT histogram column as int64) of a tiled output
    raster."""
    from pyshepseg_tpu_torch import io as rio
    band = rio.open(path).GetRasterBand(1)
    rat = band.GetDefaultRAT()
    hist = rat.ReadAsArray(rat.GetColOfUsage(rio.GFU_PixelCount))
    return band.ReadAsArray(), np.asarray(hist, dtype=np.int64)


def to_np(t):
    """A tensor (or tuple of tensors) as numpy."""
    if isinstance(t, tuple):
        return tuple(to_np(x) for x in t)
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def merge_apply_case(rng, capacity, nbands, share, target=5,
                     max_diff_sqr=100.0):
    """
    Inputs of a graph pass's apply step (ops/elim_small.merge_apply) as
    CPU tensors (size, sums, best_nbr, d_best), laid out as a pass leaves
    them: candidates have size ``target``, and every best neighbour is a
    segment larger than ``target``. ``share`` is the share of candidates
    that move: "none", "sparse" (about 5 %) or "all". Row 0 and some
    non-candidates carry a neighbour within the limit too, and some
    candidates one just beyond it, so the predicate is tested; sums are
    signed and use 41 bits.
    """
    from pyshepseg_tpu_torch.ops import elim_small
    big = elim_small._BIG_ID
    size = rng.integers(0, 3 * target, size=capacity)
    size[rng.random(capacity) < 0.3] = target
    size[0] = target
    ids = np.arange(capacity)
    cand = (size == target) & (ids >= 1)
    pool = ids[(size > target) & (ids >= 1)]
    best_nbr = np.full(capacity, big, np.int64)
    d_best = np.full(capacity, np.inf, np.float32)
    within = rng.uniform(0, max_diff_sqr, size=capacity).astype(np.float32)
    within[::7] = max_diff_sqr
    beyond = np.nextafter(np.float32(max_diff_sqr), np.float32(np.inf))
    moves = {"none": np.zeros(capacity, bool),
             "sparse": rng.random(capacity) < 0.05,
             "all": np.ones(capacity, bool)}[share] & cand
    near = moves | (~cand & (rng.random(capacity) < 0.2))
    near[0] = True
    far = cand & ~moves & (rng.random(capacity) < 0.5)
    for mask, d in ((near, within), (far, beyond)):
        best_nbr[mask] = rng.choice(pool, size=int(mask.sum()))
        d_best[mask] = d if np.ndim(d) == 0 else d[mask]
    sums = rng.integers(-2 ** 40, 2 ** 40, size=(nbands, capacity))
    return (torch.from_numpy(size.astype(np.int64)),
            torch.from_numpy(sums.astype(np.int64)),
            torch.from_numpy(best_nbr), torch.from_numpy(d_best))
