"""The port's row-sharded clump and row-sharded full segmentation
(parallel/shardmap_clump, parallel/shardmap_seg) over a list of CPU
devices against the JAX package's over its 8 virtual CPU devices, against
the flood-fill oracle and against the port's single-device pipeline.
``["cpu"] * n`` names one device n times: every halo exchange and every
global fixpoint runs as it would over n cards. All outputs are integer
label images and counts: the tolerance is zero."""

import sys

import numpy as np
import pytest
import torch

from pyshepseg_tpu.parallel import shardmap_clump as jax_shardmap_clump
from pyshepseg_tpu.parallel import shardmap_seg as jax_shardmap_seg
from pyshepseg_tpu_torch import io as rio
from pyshepseg_tpu_torch import shepseg
from pyshepseg_tpu_torch.cmdline import run_seg
from pyshepseg_tpu_torch.ops.sync import to_host
from pyshepseg_tpu_torch.parallel import pipeline, shardmap_clump
from pyshepseg_tpu_torch.parallel import shardmap_seg
from oracle import oracle_clump
from test_shardmap_seg import make_image
from torch_parity import to_np, write_raster

MESH8 = ["cpu"] * 8


def clump_case(rng, shape, nclusters=4, null_frac=0.08):
    img = rng.integers(1, nclusters + 1, size=shape).astype(np.int32)
    img[rng.random(shape) < null_frac] = 0
    return img


def spanning_case():
    # one vertical component through every stripe (worst-case propagation)
    img = np.full((64, 16), 2, dtype=np.int32)
    img[:, 8] = 1
    return img


CLUMP_CASES = {
    "even_64x48": lambda: clump_case(np.random.default_rng(1), (64, 48)),
    "even_40x32": lambda: clump_case(np.random.default_rng(2), (40, 32)),
    "uneven_30x40": lambda: clump_case(np.random.default_rng(3), (30, 40)),
    "spanning": spanning_case,
}


@pytest.mark.parametrize("four", [True, False])
@pytest.mark.parametrize("name", sorted(CLUMP_CASES))
def test_clump_sharded_matches_jax_and_oracle(name, four):
    img = CLUMP_CASES[name]()
    seg, num = shardmap_clump.clump_sharded(img, 0, four, mesh=MESH8)
    want, wantNum = jax_shardmap_clump.clump_sharded(img, 0, four)
    ref, refNext = oracle_clump(img, 0, four)
    assert seg.dtype == np.uint32
    np.testing.assert_array_equal(seg, want)
    np.testing.assert_array_equal(seg, ref)
    assert num == wantNum == refNext - 1


@pytest.mark.parametrize("n", [1, 2, 3, 5])
def test_clump_sharded_any_stripe_count(n):
    img = clump_case(np.random.default_rng(4), (50, 37), nclusters=3)
    ref, refNext = oracle_clump(img, 0, False)
    seg, num = shardmap_clump.clump_sharded(img, 0, False, mesh=["cpu"] * n)
    np.testing.assert_array_equal(seg, ref)
    assert num == refNext - 1


def test_clump_sharded_one_sync_a_sweep():
    """The fixpoint's change flags are read once a sweep for all stripes:
    the syncs of a run are its sweeps plus one for the root counts."""
    img = spanning_case()
    for n in (2, 8):
        to_host.syncs = 0
        shardmap_clump._clump_sharded.sweeps = 0
        shardmap_clump.exchange_rows.rows = 0
        shardmap_clump.clump_sharded(img, 0, True, mesh=["cpu"] * n)
        sweeps = shardmap_clump._clump_sharded.sweeps
        assert sweeps >= 2
        assert to_host.syncs == sweeps + 1
        # image and mask rows once, then the label rows of every sweep
        assert shardmap_clump.exchange_rows.rows == (2 + sweeps) * 2 * (n - 1)


def test_clump_sharded_rejects_too_many_pixels(monkeypatch):
    monkeypatch.setattr(shardmap_clump, "MAX_SHARDED_PIXELS", 100)
    with pytest.raises(ValueError, match="flat-index range"):
        shardmap_clump.clump_sharded(np.ones((11, 10), np.int32), 0,
                                     mesh=["cpu"])


def test_default_mesh_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        shardmap_clump.clump_sharded(np.ones((8, 8), np.int32), 0)
    with pytest.raises(RuntimeError):
        shardmap_clump.clump_sharded(np.ones((8, 8), np.int32), 0,
                                     mesh=["cuda:0"])


# name -> (h, w, nbands, ncells, seed, four, nullval, nullmargin, maxdiff,
# minseg): the cases of tests/test_shardmap_seg.py (its rng fixture's seed)
# and the sweep of tests/test_shardmap_sweep.py
SEG_CASES = {
    "seg_4conn": (96, 80, 3, 25, 42, True, None, 0, 1e9, 12),
    "seg_8conn_nulls_limit": (90, 64, 4, 20, 42, False, 9999, 4, 150.0, 10),
    "seg_unbounded": (96, 48, 3, 12, 42, True, None, 0, None, 8),
    "sweep_101": (96, 64, 3, 25, 101, True, None, 0, 1e9, 10),
    "sweep_102": (96, 64, 3, 25, 102, False, None, 0, 1e9, 10),
    "sweep_103": (96, 64, 3, 25, 103, True, 7777, 3, 1e9, 10),
    "sweep_104": (96, 64, 3, 25, 104, False, 7777, 3, 200.0, 10),
    "sweep_105": (96, 64, 3, 25, 105, True, None, 0, 120.0, 10),
    "sweep_106": (96, 64, 3, 25, 106, False, None, 0, 250.0, 10),
}


def seg_inputs(name):
    (h, w, nb, ncells, seed, four, nullval, margin, maxdiff,
     minseg) = SEG_CASES[name]
    img, centers = make_image(h, w, nb, ncells, np.random.default_rng(seed),
                              nullval=nullval, nullmargin=margin)
    return img, centers, four, nullval, maxdiff, minseg


def single_device(img, centers, four, nullval, maxdiff, minseg):
    seg, maxid = pipeline.segment_tile(
        torch.from_numpy(img), torch.from_numpy(centers),
        nullval if nullval is not None else 0,
        1e18 if maxdiff is None else maxdiff, minseg, four,
        nullval is not None)
    return to_np(seg), int(maxid)


@pytest.mark.parametrize("name", sorted(SEG_CASES))
def test_segment_image_sharded_matches_jax_and_single_device(name):
    img, centers, four, nullval, maxdiff, minseg = seg_inputs(name)
    kw = dict(imgNullVal=nullval, maxSpectralDiff=maxdiff,
              minSegmentSize=minseg, fourConnected=four)
    got, got_max = shardmap_seg.segment_image_sharded(
        img, centers, mesh=MESH8, **kw)
    want, want_max = jax_shardmap_seg.segment_image_sharded(
        img, centers, **kw)
    one, one_max = single_device(img, centers, four, nullval, maxdiff,
                                 minseg)
    assert got.dtype == np.uint32 and got.shape == img.shape[1:]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, one)
    assert got_max == want_max == one_max == got.max() > 1


@pytest.mark.parametrize("name", ["seg_8conn_nulls_limit", "sweep_103"])
def test_segment_image_sharded_any_stripe_count(name):
    """Stripe counts 1, 2, 3 and 8 (90 and 96 rows: padded with null rows
    where they do not divide) give one answer, full result included."""
    img, centers, four, nullval, maxdiff, minseg = seg_inputs(name)
    results = [shardmap_seg.segment_image_sharded(
        img, centers, imgNullVal=nullval, maxSpectralDiff=maxdiff,
        minSegmentSize=minseg, fourConnected=four, mesh=["cpu"] * n,
        fullResult=True) for n in (1, 2, 3, 8)]
    one, one_max = single_device(img, centers, four, nullval, maxdiff,
                                 minseg)
    for res in results:
        np.testing.assert_array_equal(res[0], one)
        assert res[1:] == results[0][1:] and res[1] == one_max


def test_padding_rows_are_no_merge_targets():
    """A height that does not divide the stripes is padded with null rows.
    With one null pixel in the image the null segment is a single pixel
    and no target; the padding must not turn it into one, nor let the last
    row's single pixels merge into the padding."""
    rng = np.random.default_rng(11)
    img, centers = make_image(37, 40, 3, 12, rng, salt=0.1)
    img[:, 5, 5] = 7
    img[:, -1, ::3] = rng.integers(10, 900, size=(3, 14))   # singles
    one, one_max = single_device(img, centers, False, 7, 1e9, 6)
    got, got_max = shardmap_seg.segment_image_sharded(
        img, centers, imgNullVal=7, maxSpectralDiff=1e9, minSegmentSize=6,
        fourConnected=False, mesh=["cpu"] * 5)
    np.testing.assert_array_equal(got, one)
    assert got_max == one_max


def test_sharded_rejects_nondividing_height_without_null():
    img, centers = make_image(90, 48, 3, 10, np.random.default_rng(0))
    with pytest.raises(ValueError, match="does not divide"):
        shardmap_seg.segment_image_sharded(
            img, centers, imgNullVal=None, maxSpectralDiff=1e9,
            minSegmentSize=8, fourConnected=True, mesh=MESH8)


def test_sharded_driver_matches_single_device_driver():
    """doShepherdSegmentationSharded against doShepherdSegmentation: the
    drop-in driver with its own k-means fit (fixed init, both fits equal)
    and the SegmentationResult fields."""
    img, _ = make_image(96, 64, 3, 18, np.random.default_rng(42))
    kw = dict(numClusters=12, clusterSubsamplePcnt=100, minSegmentSize=10,
              maxSpectralDiff='auto', fourConnected=True,
              fixedKMeansInit=True)
    want = shepseg.doShepherdSegmentation(img, device="cpu", **kw)
    got = shardmap_seg.doShepherdSegmentationSharded(img, mesh=MESH8, **kw)
    np.testing.assert_array_equal(want.segimg, got.segimg)
    np.testing.assert_array_equal(want.kmeans.cluster_centers_,
                                  got.kmeans.cluster_centers_)
    assert want.maxSpectralDiff == got.maxSpectralDiff
    assert want.singlePixelsEliminated == got.singlePixelsEliminated
    assert want.smallSegmentsEliminated == got.smallSegmentsEliminated
    assert want.elimPasses == got.elimPasses
    assert got.clumpSweeps is None


def test_run_seg_sharded_cli_matches_unsharded(tmp_path, monkeypatch):
    img, _ = make_image(96, 64, 3, 18, np.random.default_rng(5))
    inpath = str(tmp_path / "in.npseg")
    write_raster(inpath, img)
    outs = {}
    for name, extra in (("plain", []), ("sharded", ["--sharded"])):
        out = str(tmp_path / (name + ".npseg"))
        monkeypatch.setattr(sys, "argv", [
            "run_seg", "-i", inpath, "-o", out, "-n", "12", "-b", "1,2,3",
            "-s", "10", "-c", "100", "--fixedkmeansinit", "--device",
            "cpu"] + extra)
        run_seg.mainCmd()
        outs[name] = rio.open(out).GetRasterBand(1).ReadAsArray()
    np.testing.assert_array_equal(outs["sharded"], outs["plain"])
    assert outs["plain"].max() > 1
