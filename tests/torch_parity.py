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


def to_np(t):
    """A tensor (or tuple of tensors) as numpy."""
    if isinstance(t, tuple):
        return tuple(to_np(x) for x in t)
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
