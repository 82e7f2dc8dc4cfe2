"""The port's device-resident tile pipeline (parallel/pipeline) against
pyshepseg_tpu.parallel.pipeline on the same inputs: the palette images of
tests/test_shardmap_seg.py, whose centres are the palette itself (integer
pixels on the centres: no cluster-score tie). Segment images and segment
counts are integers: the tolerance is zero throughout. The JAX side runs
on the CPU as its own tests run it; the port runs on CPU tensors (the
plain versions of K1 and K2)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pyshepseg_tpu.parallel import pipeline as jax_pipeline
from pyshepseg_tpu_torch import shepseg
from pyshepseg_tpu_torch.ops.kmeans import TorchKMeans
from pyshepseg_tpu_torch.parallel import pipeline
from test_shardmap_seg import make_image, run_single_chip
from torch_parity import to_np

# name -> (seed, four_connected, null value, maxSpectralDiff): the sweep of
# tests/test_shardmap_sweep.py, one shape so the JAX side compiles one
# program per (connectivity, null) pair
CASES = {
    "4conn": (101, True, None, 1e9),
    "8conn": (102, False, None, 1e9),
    "4conn_nullmargin": (103, True, 7777, 1e9),
    "8conn_nullmargin_tight": (104, False, 7777, 200.0),
    "4conn_tight": (105, True, None, 120.0),
    "8conn_tight": (106, False, None, 250.0),
}
SHAPE = (96, 64)
MINSEG = 10


def case_inputs(name):
    seed, four, nullval, maxdiff = CASES[name]
    img, centers = make_image(*SHAPE, 3, 25, np.random.default_rng(seed),
                              nullval=nullval,
                              nullmargin=3 if nullval is not None else 0)
    return img, centers, four, nullval, maxdiff


def torch_tile(img, centers, four, nullval, maxdiff, **kw):
    seg, maxid = pipeline.segment_tile(
        torch.from_numpy(img), torch.from_numpy(centers),
        nullval if nullval is not None else 0, maxdiff, MINSEG, four,
        nullval is not None, **kw)
    return to_np(seg), int(maxid)


@pytest.mark.parametrize("name", sorted(CASES))
def test_segment_tile_matches_jax(name):
    img, centers, four, nullval, maxdiff = case_inputs(name)
    want, want_max = run_single_chip(img, centers, nullval, maxdiff, MINSEG,
                                     four)
    got, got_max = torch_tile(img, centers, four, nullval, maxdiff)
    np.testing.assert_array_equal(got, want)
    assert got_max == want_max == got.max() > 1
    if nullval is not None:
        assert (got[:3] == 0).all() and (got[:, -3:] == 0).all()


@pytest.mark.parametrize("name", ["4conn", "8conn_nullmargin_tight"])
def test_segment_tile_clump_routes_and_capacity_agree(name):
    """The sweeps and the two-level merge give one answer, and
    ``capacity`` changes nothing."""
    args = case_inputs(name)
    want = torch_tile(*args)
    for kw in (dict(clump_two_level=False), dict(clump_two_level=True),
               dict(capacity=pipeline.default_capacity(*SHAPE))):
        got = torch_tile(*args, **kw)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]


def test_segment_tile_returns_device_tensors():
    img, centers, four, nullval, maxdiff = case_inputs("4conn")
    seg, maxid = pipeline.segment_tile(
        torch.from_numpy(img), torch.from_numpy(centers), 0, maxdiff,
        MINSEG, four, False)
    assert isinstance(seg, torch.Tensor) and seg.dtype == torch.int32
    assert isinstance(maxid, torch.Tensor) and maxid.dim() == 0
    assert tuple(seg.shape) == SHAPE
    assert pipeline.segment_tile_jit is pipeline.segment_tile
    assert pipeline.default_capacity(*SHAPE) == SHAPE[0] * SHAPE[1] + 1


def test_segment_tiles_vmapped_matches_jax():
    """A batch of 3 tiles through both packages' batched entry points."""
    # one palette image cut into three tiles side by side
    h, w = SHAPE
    wide, centers = make_image(h, 3 * w, 3, 40, np.random.default_rng(201))
    imgs = np.stack([wide[:, :, i * w:(i + 1) * w] for i in range(3)])
    want, want_max = jax_pipeline.segment_tiles_vmapped(
        jnp.asarray(imgs), jnp.asarray(centers), jnp.float32(0),
        jnp.float32(1e9), min_seg_size=MINSEG, four_connected=True,
        has_null=False, capacity=jax_pipeline.default_capacity(h, w))
    got, got_max = pipeline.segment_tiles_vmapped(
        torch.from_numpy(imgs), torch.from_numpy(centers), 0, 1e9, MINSEG,
        True, False)
    assert tuple(got.shape) == (3, h, w) and tuple(got_max.shape) == (3,)
    np.testing.assert_array_equal(to_np(got), np.asarray(want))
    np.testing.assert_array_equal(to_np(got_max), np.asarray(want_max))


@pytest.mark.parametrize("name", ["4conn", "8conn_nullmargin_tight",
                                  "4conn_tight"])
def test_three_step_decomposition_matches_segment_tile(name):
    """phase2(phase1(cluster_clump(x))) == segment_tile(x), on a batch of
    two tiles whose clump counts differ (the tables are padded to the
    larger)."""
    img, centers, four, nullval, maxdiff = case_inputs(name)
    other = img.copy()
    other[:, 20:60, 10:50] = img[:, 20:21, 10:11]      # one flat patch
    imgs = torch.from_numpy(np.stack([img, other]))
    cen = torch.from_numpy(centers)
    null = nullval if nullval is not None else 0
    has_null = nullval is not None

    segs, counts, sweeps = pipeline.cluster_clump_tiles(
        imgs, cen, null, four, has_null)
    assert tuple(segs.shape) == (2,) + SHAPE
    assert counts.tolist() == [int(s.max()) for s in segs]
    assert counts[0] != counts[1] and tuple(sweeps.shape) == (2,)
    (segs1, sizes, spects, a, b, first,
     scalars) = pipeline.eliminate_tiles_phase1(imgs, segs, four)
    assert sizes.shape == (2, int(counts.max()) + 1)
    assert spects.shape == (2, int(counts.max()) + 1, 3)
    assert len(a) == len(b) == len(first) == 2
    assert scalars[:, 1].tolist() == [int(f.sum()) for f in first]
    got, got_max = pipeline.eliminate_tiles_phase2(
        segs1, sizes, spects, a, b, first, maxdiff, MINSEG)
    for i, tile in enumerate((img, other)):
        want, want_max = torch_tile(tile, centers, four, nullval, maxdiff)
        np.testing.assert_array_equal(to_np(got[i]), want)
        assert int(got_max[i]) == want_max


@pytest.mark.parametrize("four", [True, False])
def test_segment_tile_matches_do_shepherd_segmentation(four):
    """segment_tile is doShepherdSegmentation without the fit and the
    download: same centres, same segment image."""
    # salt at 15 %: adjacent salt pixels make small segments
    img, centers = make_image(*SHAPE, 3, 25, np.random.default_rng(7),
                              salt=0.15, nullval=9999, nullmargin=2)
    km = TorchKMeans.from_arrays(centers, device="cpu")
    res = shepseg.doShepherdSegmentation(
        img, minSegmentSize=MINSEG, maxSpectralDiff=300.0, imgNullVal=9999,
        fourConnected=four, kmeansObj=km, device="cpu")
    got, got_max = torch_tile(img, centers, four, 9999, 300.0)
    np.testing.assert_array_equal(got, res.segimg)
    assert got_max == res.segimg.max()
    assert res.singlePixelsEliminated > 0 and res.smallSegmentsEliminated > 0
