"""End to end: the port's doShepherdSegmentation against the JAX
package's, with the JAX-fitted centres shared through kmeansObj."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pyshepseg_tpu import shepseg as jax_shepseg
from pyshepseg_tpu_torch import shepseg
from pyshepseg_tpu_torch.ops.kmeans import kmeansFromReference
from torch_parity import voronoi_image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("four_connected,null,min_size", [
    (True, None, 50), (True, 65535, 1), (False, None, 1),
    (False, 65535, 50)])
def test_segmentation_matches_jax(four_connected, null, min_size):
    # a seed whose cluster scores hold no float32 tie: at a tie the two
    # packages may assign a pixel differently (see test_torch_kmeans)
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
