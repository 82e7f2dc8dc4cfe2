"""End to end: the port's doShepherdSegmentation against the JAX
package's, with the JAX-fitted centres shared through kmeansObj."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pyshepseg_tpu import shepseg as jax_shepseg
from pyshepseg_tpu.ops import kmeans as jax_kmeans
from pyshepseg_tpu_torch import shepseg
from pyshepseg_tpu_torch.ops.kmeans import kmeansFromReference
from torch_parity import voronoi_image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("four_connected,null,min_size", [
    (True, None, 50), (True, 65535, 1), (False, None, 1),
    (False, 65535, 50)])
def test_segmentation_matches_jax(four_connected, null, min_size):
    # a seed where no pixel's two nearest centres are closer together
    # than the float32 rounding of the scores: there the two packages may
    # assign a pixel differently (the assignment contract below)
    rng = np.random.default_rng(0)
    img, _ = voronoi_image(rng)
    if null is not None:
        img[:, :6, :9] = null
    kw = dict(numClusters=12, clusterSubsamplePcnt=100,
              minSegmentSize=min_size, imgNullVal=null,
              fourConnected=four_connected)
    want = jax_shepseg.doShepherdSegmentation(img, fixedKMeansInit=True,
                                              **kw)
    got = shepseg.doShepherdSegmentation(
        img, kmeansObj=kmeansFromReference(want.kmeans, device="cpu"),
        device="cpu", **kw)
    assert got.segimg.dtype == np.uint32
    np.testing.assert_array_equal(got.segimg, want.segimg)
    assert got.singlePixelsEliminated == want.singlePixelsEliminated
    assert got.smallSegmentsEliminated == want.smallSegmentsEliminated
    assert got.maxSpectralDiff == want.maxSpectralDiff
    if min_size == 1:
        assert got.smallSegmentsEliminated == 0
    if null is not None:
        assert (got.segimg[:6, :9] == 0).all()


# ---- the assignment contract
#
# Both packages pick a pixel's cluster as the argmin over the centres of
# the float32 score s_k = 0.5*|c_k|^2 - x.c_k, which orders the centres as
# the squared distance d_k^2 = |x|^2 + 2*s_k does. Its two terms are far
# larger than their difference and cancel, and each package rounds them
# its own way (XLA's jitted CPU product, PyTorch's CPU product, cuBLAS on
# the card), so two centres whose squared distances differ by less than
# the rounding of the scores may be ordered either way. That is not only
# an exact tie: for offset or large-valued data it is a gap of percents.
# With u = 2^-24 and n bands, a float32 dot product of n terms is within
# n*u*sum|x_b*c_b| of the exact one, 0.5*|c|^2 within n*u*0.5*|c|^2, and
# the subtraction adds u*|s|: each score is within
#     (n + 1) * u * A_k,   A_k = 0.5*|c_k|^2 + sum_b |x_b * c_kb|
# of its exact value. One package can order centres i and j wrongly only
# where |s_i - s_j| <= (n + 1)*u*(A_i + A_j), that is where
#     |d_i^2 - d_j^2| <= 2 * (n + 1) * u * (A_i + A_j).
# The contract: wherever the two packages' cluster images differ, each
# took one of the pixel's two nearest centres (in float64) and those two
# squared distances differ by less than that bound. From an identical
# cluster image everything downstream is equal bit for bit.
#
# Of the cases below, float32 imagery at seed 0 is where the two packages
# differ on this CPU: 38 pixels, whose two nearest centres lie 0.06-0.10
# squared units away and up to 0.0055 apart (the bound there is 0.04), and
# 3168 segment pixels differ end to end if each package keeps its own
# assignment. The other cases assign every pixel alike.

# (seed, noise of voronoi_image)
SCENES = [(0, 2), (1, 8), (2, 30), (3, 60)]


def _float32_imagery(img):
    return (img / 7.0).astype(np.float32), None


def _int16_negative_null(img):
    out = (img.astype(np.int32) - 500).astype(np.int16)
    out[:, :5, :7] = -999
    return out, -999


# variant -> (image transform giving (img, imgNullVal), extra arguments)
VARIANTS = {
    "uint16": (lambda img: (img, None), {}),
    "float32": (_float32_imagery, {}),
    "int16_null": (_int16_negative_null, {}),
    "one_band": (lambda img: (img[:1], None), {}),
    "maxdiff40_8conn": (lambda img: (img, None),
                        dict(maxSpectralDiff=40, fourConnected=False)),
    "pcntile25": (lambda img: (img, None), dict(spectDistPcntile=25)),
}


def assert_within_score_rounding(got, want, img, centers, what):
    """``got`` and ``want`` are cluster images (ids from 1, 0 null) of
    ``img`` under ``centers``. Returns the number of pixels that differ,
    after holding each to the contract above."""
    rows, cols = np.nonzero(got != want)
    nbands = img.shape[0]
    c = centers.astype(np.float64)
    u = 2.0 ** -24
    for r, q in zip(rows, cols):
        x = img[:, r, q].astype(np.float64)
        d2 = ((c - x) ** 2).sum(axis=1)
        first, second = np.argsort(d2, kind="stable")[:2]
        assert {int(got[r, q]) - 1, int(want[r, q]) - 1} == {first, second}, (
            "%s: pixel (%d, %d) went to a centre that is not one of its "
            "two nearest" % (what, r, q))
        amp = sum(0.5 * (c[k] ** 2).sum() + np.abs(x * c[k]).sum()
                  for k in (first, second))
        bound = 2 * (nbands + 1) * u * amp
        assert d2[second] - d2[first] < bound, (
            "%s: pixel (%d, %d): squared distances %r and %r differ by "
            "more than the scores' float32 rounding %r"
            % (what, r, q, d2[first], d2[second], bound))
    return len(rows)


@pytest.mark.parametrize("seed,noise", SCENES)
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_assignment_contract_and_downstream_equality(variant, seed, noise,
                                                     monkeypatch):
    transform, extra = VARIANTS[variant]
    # 12 cells into 10 clusters: some clusters hold two colours, so their
    # borders pass near the data
    base, _ = voronoi_image(np.random.default_rng(seed), shape=(64, 72),
                            noise=noise)
    img, null = transform(base)
    kw = dict(numClusters=10, clusterSubsamplePcnt=50, minSegmentSize=10,
              imgNullVal=null, **extra)
    want = jax_shepseg.doShepherdSegmentation(img, fixedKMeansInit=True,
                                              **kw)
    km = kmeansFromReference(want.kmeans, device="cpu")
    centers = np.asarray(want.kmeans.cluster_centers_, dtype=np.float32)

    # the assignment: the port's one arithmetic against the JAX package's
    # two (applySpectralClusters' point-major product, and the band-major
    # one of the segmentation itself, jitted as it runs there)
    port = shepseg.applySpectralClusters(km, img, null, device="cpu")
    jaxApply = jax_shepseg.applySpectralClusters(want.kmeans, img, null)
    hasNull = null is not None
    jaxAssign = np.asarray(jax.jit(
        jax_kmeans.assign_clusters, static_argnames="has_null")(
            jnp.asarray(img), jnp.asarray(centers),
            jax_kmeans.null_scalar(null if hasNull else 0, img.dtype),
            has_null=hasNull))
    assert port.dtype == jaxApply.dtype == np.uint32
    np.testing.assert_array_equal(port == 0, jaxAssign == 0)
    assert_within_score_rounding(port, jaxApply, img, centers,
                                 "against applySpectralClusters")
    assert_within_score_rounding(port, jaxAssign, img, centers,
                                 "against assign_clusters")

    # downstream of an identical cluster image (the JAX package's, handed
    # to the port in place of its own assignment): clump, both
    # eliminations, relabel, counts and maxSpectralDiff, bit for bit
    monkeypatch.setattr(
        shepseg, "assign_clusters",
        lambda *args: torch.from_numpy(jaxAssign.astype(np.int32)))
    got = shepseg.doShepherdSegmentation(img, kmeansObj=km, device="cpu",
                                         **kw)
    np.testing.assert_array_equal(got.segimg, want.segimg)
    assert got.singlePixelsEliminated == want.singlePixelsEliminated
    assert got.smallSegmentsEliminated == want.smallSegmentsEliminated
    assert got.maxSpectralDiff == want.maxSpectralDiff
    if hasNull:
        assert (got.segimg[:5, :7] == 0).all()


def test_fits_its_own_kmeans_and_tensor_input():
    rng = np.random.default_rng(8)
    img, true_seg = voronoi_image(rng, shape=(48, 48), ncentres=6, noise=0)
    res = shepseg.doShepherdSegmentation(
        img, numClusters=6, clusterSubsamplePcnt=100, minSegmentSize=10,
        fixedKMeansInit=True, device="cpu")
    used = np.unique(res.segimg)
    np.testing.assert_array_equal(used, np.arange(1, len(used) + 1))
    for sid in used:
        assert len(np.unique(true_seg[res.segimg == sid])) == 1
    # a tensor image runs on its own device and gives the same result
    again = shepseg.doShepherdSegmentation(
        torch.from_numpy(img.astype(np.int32)), numClusters=6,
        minSegmentSize=10, kmeansObj=res.kmeans)
    np.testing.assert_array_equal(again.segimg, res.segimg)


def test_cuda_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    img = np.zeros((1, 8, 8), np.uint16)
    with pytest.raises(RuntimeError):
        shepseg.doShepherdSegmentation(img, numClusters=2)


def test_port_never_imports_jax():
    code = ("import sys, numpy as np\n"
            "from pyshepseg_tpu_torch import shepseg\n"
            "img = np.random.default_rng(0).integers(0, 50, (2, 16, 16))\n"
            "r = shepseg.doShepherdSegmentation(img.astype(np.uint16), "
            "numClusters=4, clusterSubsamplePcnt=100, minSegmentSize=3, "
            "fixedKMeansInit=True, device='cpu')\n"
            "assert r.segimg.max() > 0\n"
            "assert 'jax' not in sys.modules, 'jax imported'\n"
            "assert 'pyshepseg_tpu' not in sys.modules\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_timing_helpers_on_cpu():
    """deviceResidentThroughput and deviceOnlySeconds time the warm call
    with time.perf_counter off the card: finite, positive, and the call
    they time (a uint16 tensor on the device, the given k-means) gives
    the numpy call's segimg."""
    img, _ = voronoi_image(np.random.default_rng(4), shape=(48, 56))
    km = shepseg.fitSpectralClusters(img, 8, 100, None, True, device="cpu")
    mpix = shepseg.deviceResidentThroughput(img, km, 'auto', 10,
                                            repeats=2, device="cpu")
    secs, rtt = shepseg.deviceOnlySeconds(img, km, 'auto', 10, k=2,
                                          repeats=2, device="cpu")
    for v in (mpix, secs, rtt):
        assert np.isfinite(v) and v > 0
    a = shepseg.doShepherdSegmentation(torch.from_numpy(img), kmeansObj=km,
                                       minSegmentSize=10, device="cpu")
    b = shepseg.doShepherdSegmentation(img, kmeansObj=km, minSegmentSize=10,
                                       device="cpu")
    np.testing.assert_array_equal(a.segimg, b.segimg)
