"""K-means: the port's assignment and Lloyd fit against the JAX
package's on the same inputs."""

import pickle

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pyshepseg_tpu.ops import kmeans as jax_kmeans
from pyshepseg_tpu import shepseg as jax_shepseg
from pyshepseg_tpu_torch.ops import kmeans
from pyshepseg_tpu_torch import shepseg
from torch_parity import voronoi_image


def _blob_data(rng, k=4, n_per=200, nbands=3, spread=2.0, sep=50.0):
    centers = rng.uniform(0, sep * k, size=(k, nbands))
    pts = np.concatenate([
        c + rng.normal(0, spread, size=(n_per, nbands)) for c in centers])
    return pts.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("null", [None, 65535])
def test_assign_clusters_matches_jax(seed, null):
    rng = np.random.default_rng(seed)
    img, _ = voronoi_image(rng, shape=(64, 72))
    if null is not None:
        img[:, 10:20, 5:9] = null
    centers = rng.uniform(50, 900, size=(12, 3)).astype(np.float32)
    null_v = kmeans.null_scalar(null if null is not None else 0, img.dtype)
    want = np.asarray(jax_kmeans.assign_clusters(
        jnp.asarray(img), jnp.asarray(centers),
        jax_kmeans.null_scalar(null if null is not None else 0, img.dtype),
        null is not None))
    got = kmeans.assign_clusters(shepseg.image_tensor(img, "cpu"),
                                 torch.from_numpy(centers), null_v,
                                 null is not None).numpy()
    diff = np.argwhere(got != want)
    # a pixel may differ only where the two best scores tie in float32
    c64 = centers.astype(np.float64)
    for y, x in diff:
        xv = img[:, y, x].astype(np.float64)
        s = 0.5 * (c64 * c64).sum(axis=1) - c64 @ xv
        a, b = int(got[y, x]) - 1, int(want[y, x]) - 1
        ulp = np.spacing(np.float32(abs(s).max()))
        assert abs(s[a] - s[b]) <= 4 * ulp, (y, x, s[a], s[b])
    print("assign_clusters: %d float32 ties differ" % len(diff))
    if null is not None:
        assert (got[10:20, 5:9] == 0).all()


def test_fixed_init_fit_matches_jax(rng):
    x = _blob_data(rng)
    init = jax_shepseg.diagonalClusterCentres(x, 4)
    want = jax_kmeans.TPUKMeans(n_clusters=4, n_init=1, init=init).fit(x)
    got = kmeans.TorchKMeans(n_clusters=4, n_init=1, init=init,
                             device="cpu").fit(x)
    np.testing.assert_allclose(got.cluster_centers_, want.cluster_centers_,
                               rtol=1e-4)
    assert got.n_iter_ == want.n_iter_
    np.testing.assert_allclose(got.inertia_, want.inertia_, rtol=1e-4)


def test_fit_spectral_clusters_matches_jax(rng):
    img, _ = voronoi_image(rng, shape=(48, 48))
    want = jax_shepseg.fitSpectralClusters(img, 8, 100, None, True)
    got = shepseg.fitSpectralClusters(img, 8, 100, None, True, device="cpu")
    np.testing.assert_allclose(got.cluster_centers_, want.cluster_centers_,
                               rtol=1e-4)


def test_kmeanspp_recovers_blob_centres(rng):
    k = 4
    centres = np.arange(k)[:, None] * 100.0 + rng.uniform(0, 10, (k, 3))
    pts = np.concatenate([
        c + rng.normal(0, 1.0, size=(300, 3)) for c in centres]
    ).astype(np.float32)
    km = kmeans.TorchKMeans(n_clusters=k, n_init=3, device="cpu").fit(pts)
    d = np.sqrt(((centres[:, None] - km.cluster_centers_[None]) ** 2).sum(2))
    assert d.min(axis=1).sum() < k * 1.0
    # same seed, same draws
    again = kmeans.TorchKMeans(n_clusters=k, n_init=3, device="cpu").fit(pts)
    np.testing.assert_array_equal(again.cluster_centers_,
                                  km.cluster_centers_)


def test_predict_matches_nearest_centre(rng):
    x = _blob_data(rng)
    km = kmeans.TorchKMeans(n_clusters=4, n_init=2, device="cpu").fit(x)
    labels = km.predict(x)
    d = ((x[:, None, :] - km.cluster_centers_[None]) ** 2).sum(axis=2)
    np.testing.assert_array_equal(labels, d.argmin(axis=1))


def test_kmeans_from_reference_round_trip(rng):
    x = _blob_data(rng)
    ref = jax_kmeans.TPUKMeans(n_clusters=4, n_init=1,
                               init=x[:4].copy()).fit(x)
    km = kmeans.kmeansFromReference(ref, device="cpu")
    assert isinstance(km, kmeans.TorchKMeans)
    assert km.n_clusters == 4
    np.testing.assert_array_equal(km.cluster_centers_, ref.cluster_centers_)
    assert km.inertia_ == ref.inertia_ and km.n_iter_ == ref.n_iter_
    back = pickle.loads(pickle.dumps(km))
    np.testing.assert_array_equal(back.cluster_centers_, ref.cluster_centers_)
    np.testing.assert_array_equal(km.predict(x), ref.predict(x))


def test_apply_spectral_clusters_matches_jax(rng):
    img = rng.integers(0, 200, size=(3, 40, 40)).astype(np.uint16)
    img[:, :3, :3] = 999
    km = jax_shepseg.fitSpectralClusters(img, 8, 100, 999, True)
    want = jax_shepseg.applySpectralClusters(km, img, 999)
    got = shepseg.applySpectralClusters(km, img, 999, device="cpu")
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_large_integer_null_value_survives(rng):
    null_v = 999999999
    img = rng.integers(0, 1000, size=(3, 16, 16)).astype(np.int32)
    img[:, 4:8, 4:8] = null_v
    centers = torch.from_numpy(rng.normal(size=(5, 3)).astype(np.float32))
    seg = kmeans.assign_clusters(torch.from_numpy(img), centers,
                                 kmeans.null_scalar(null_v, img.dtype),
                                 has_null=True).numpy()
    assert (seg[4:8, 4:8] == 0).all()
    assert (seg[:4, :] != 0).all()


def test_fp32_products_restore_tf32_flag():
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with kmeans._fp32_matmul():
            assert not torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def test_fp32_products_hold_across_overlapping_threads():
    """Two threads inside at once (as CONC_THREADS workers are): the one
    that leaves first must not turn TF32 back on under the other, and the
    user's setting comes back only when both have left."""
    import threading
    saved = torch.backends.cuda.matmul.allow_tf32
    a_in, b_in, a_out = (threading.Event() for _ in range(3))
    seen = {}

    def a():
        with kmeans._fp32_matmul():
            a_in.set()
            b_in.wait(10)
        a_out.set()

    def b():
        a_in.wait(10)
        with kmeans._fp32_matmul():
            b_in.set()
            a_out.wait(10)
            seen["b_after_a_left"] = torch.backends.cuda.matmul.allow_tf32

    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        threads = [threading.Thread(target=f) for f in (a, b)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(20)
        assert seen == {"b_after_a_left": False}
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def test_host_helpers_match_jax(rng):
    x = rng.integers(0, 1000, size=(500, 4)).astype(np.int32)
    np.testing.assert_array_equal(
        shepseg.diagonalClusterCentres(x, 10),
        jax_shepseg.diagonalClusterCentres(x, 10))

    class FakeKM:
        cluster_centers_ = rng.normal(size=(7, 3))

    for setting in ('auto', None, 42.0):
        assert (shepseg.autoMaxSpectralDiff(FakeKM(), setting, 50) ==
                jax_shepseg.autoMaxSpectralDiff(FakeKM(), setting, 50))
