"""Single-pixel and small-segment elimination, and the segment
reductions they use: the port's device functions and host APIs against
the JAX package's on clump output. Integer outputs must be identical."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pyshepseg_tpu.ops import elim_single as jax_elim_single
from pyshepseg_tpu.ops import elim_small as jax_elim_small
from pyshepseg_tpu.ops import segreduce as jax_segreduce
from pyshepseg_tpu.ops.clump import clump as jax_clump
from pyshepseg_tpu_torch.ops import elim_single, elim_small, segreduce
from pyshepseg_tpu_torch.ops.constants import MINSEGID
from torch_parity import merge_apply_case, voronoi_image


def _clumped(seed, shape=(48, 56), null=False, four_connected=True):
    """A noisy image and its clump output, on both sides' terms."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 60, size=(3,) + shape).astype(np.uint16)
    clusters = (img[0] // 20 + 1).astype(np.uint32)
    if null:
        clusters[rng.random(shape) < 0.1] = 0
    seg, nxt = jax_clump(clusters, 0, fourConnected=four_connected)
    return img, seg, nxt - 1


@pytest.mark.parametrize("four_connected", [True, False])
@pytest.mark.parametrize("null", [False, True])
def test_single_pixels_device_matches_jax(four_connected, null):
    img, seg, _ = _clumped(1, null=null, four_connected=four_connected)
    planes = img.astype(np.float32)
    want, want_n = jax_elim_single._elim_single_jit(
        jnp.asarray(planes), jnp.asarray(seg), None,
        four_connected=four_connected, do_relabel=False)
    got, got_n, passes = elim_single.eliminate_single_pixels_device(
        torch.from_numpy(planes), torch.from_numpy(seg.astype(np.int32)),
        None, four_connected, do_relabel=False)
    assert got_n == int(want_n) and got_n > 0 and passes >= 2
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("four_connected", [True, False])
def test_single_pixels_relabel_and_sizes_match_jax(four_connected):
    img, seg, num = _clumped(2, four_connected=four_connected)
    planes = img.astype(np.float32)
    sizes = jax_segreduce.makeSegSize(seg, num)
    want_seg, want_n, want_sizes = jax_elim_single._elim_single_jit(
        jnp.asarray(planes), jnp.asarray(seg), jnp.asarray(sizes),
        four_connected=four_connected, return_sizes=True)
    got_seg, got_n, _, got_sizes = \
        elim_single.eliminate_single_pixels_device(
            torch.from_numpy(planes), torch.from_numpy(seg.astype(np.int32)),
            torch.from_numpy(sizes.astype(np.int64)), four_connected,
            return_sizes=True)
    assert got_n == int(want_n)
    np.testing.assert_array_equal(got_seg.numpy(), np.asarray(want_seg))
    np.testing.assert_array_equal(got_sizes.numpy(), np.asarray(want_sizes))


@pytest.mark.parametrize("min_seg_id", [1, 3])
def test_eliminate_single_pixels_host_api_matches_jax(min_seg_id):
    img, seg, num = _clumped(3)
    sizes = jax_segreduce.makeSegSize(seg)
    want = seg.copy()
    got = seg.copy()
    n_want = jax_elim_single.eliminateSinglePixels(
        img, want, sizes, minSegId=min_seg_id, fourConnected=True)
    n_got = elim_single.eliminateSinglePixels(
        img, got, sizes, minSegId=min_seg_id, fourConnected=True,
        device="cpu")
    assert n_got == n_want
    np.testing.assert_array_equal(got, want)


def _small_case(seed, four_connected, null=False):
    img, seg, num = _clumped(seed, null=null, four_connected=four_connected)
    capacity = jax_elim_small.round_capacity(num + 1)
    sizes = jax_segreduce.makeSegSize(seg, capacity - 1)
    spect = np.asarray(jax_segreduce.seg_spectral_sums(
        jnp.asarray(seg), jnp.asarray(img.astype(np.float32)), capacity))
    return img, seg, sizes, spect


@pytest.mark.parametrize("four_connected,min_size,null", [
    (True, 5, False), (False, 12, True), (True, 1, False)])
def test_small_segments_device_matches_jax(four_connected, min_size, null):
    img, seg, sizes, spect = _small_case(4, four_connected, null)
    want, want_n, _ = jax_elim_small._elim_small_jit(
        jnp.asarray(seg), jnp.asarray(sizes), jnp.asarray(spect),
        min_seg_size=min_size, max_spectral_diff=25.0,
        four_connected=four_connected)
    got, got_n, _ = elim_small.eliminate_small_segments_device(
        torch.from_numpy(seg.astype(np.int32)),
        torch.from_numpy(sizes.astype(np.int64)),
        segreduce.seg_spectral_sums(
            torch.from_numpy(seg.astype(np.int64)),
            torch.from_numpy(img.astype(np.int32)), len(sizes)),
        min_size, 25.0, four_connected)
    assert got_n == int(want_n)
    if min_size > 1:
        assert got_n > 0
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_eliminate_small_segments_host_api_matches_jax():
    img, seg, num = _clumped(5)
    want = seg.copy()
    got = seg.copy()
    n_want = jax_elim_small.eliminateSmallSegments(want, img, num, 8, 30.0)
    n_got = elim_small.eliminateSmallSegments(got, img, num, 8, 30.0,
                                              device="cpu")
    assert n_got == n_want > 0
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("four_connected", [True, False])
def test_edge_keys_match_jax(four_connected):
    _, seg, _ = _clumped(6, null=True, four_connected=four_connected)
    a, b, first, n = jax_elim_small.edge_sort_keys(jnp.asarray(seg),
                                                   four_connected)
    first = np.asarray(first)
    want = np.stack([np.asarray(a)[first], np.asarray(b)[first]], axis=1)
    ga, gb, gfirst, gn = elim_small.edge_sort_keys(
        torch.from_numpy(seg.astype(np.int32)), four_connected)
    ea, eb = elim_small.compact_edges(ga, gb, gfirst)
    assert int(gn) == int(n)
    np.testing.assert_array_equal(
        np.stack([ea.numpy(), eb.numpy()], axis=1), want.astype(np.int64))


def test_segment_reductions_match_jax():
    rng = np.random.default_rng(7)
    img, _ = voronoi_image(rng, shape=(40, 44))
    seg = rng.integers(0, 30, size=img.shape[1:]).astype(np.uint32)
    np.testing.assert_array_equal(segreduce.makeSegSize(seg),
                                  jax_segreduce.makeSegSize(seg))
    want = jax_segreduce.buildSegmentSpectra(seg, img.astype(np.float32), 29)
    got = segreduce.buildSegmentSpectra(seg, img, 29, device="cpu")
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    sizes = jax_segreduce.makeSegSize(seg)
    sizes[[3, 7]] = 0
    want_seg, got_seg = seg.copy(), seg.copy()
    jax_segreduce.relabelSegments(want_seg, sizes, 1)
    segreduce.relabelSegments(got_seg, sizes, 1, device="cpu")
    np.testing.assert_array_equal(got_seg, want_seg)
    sz, sums = segreduce.seg_sizes_and_spectral_sums_planes(
        torch.from_numpy(seg.astype(np.int32)),
        segreduce.band_planes(torch.from_numpy(img.astype(np.int32))), 30)
    assert sums.dtype == torch.int64
    np.testing.assert_array_equal(sz.numpy(), jax_segreduce.makeSegSize(seg))
    np.testing.assert_array_equal(sums.numpy().astype(np.float32), want)


def _apply_by_loop(size, sums, best_nbr, d_best, target, max_diff_sqr):
    """A graph pass's apply step as a serial loop over the movers (numpy):
    (merge_map, size', sums', n_moved)."""
    size, sums = size.numpy().copy(), sums.numpy().copy()
    best_nbr, d_best = best_nbr.numpy(), d_best.numpy()
    merge_map = np.arange(len(size))
    n = 0
    for i in np.flatnonzero((size == target) &
                            (np.arange(len(size)) >= MINSEGID)):
        t = best_nbr[i]
        if t == elim_small._BIG_ID or d_best[i] > np.float32(max_diff_sqr):
            continue
        merge_map[i] = t
        size[t] += size[i]
        sums[:, t] += sums[:, i]
        size[i] = 0
        sums[:, i] = 0
        n += 1
    return merge_map, size, sums, n


@pytest.mark.parametrize("share", ["none", "sparse", "all"])
@pytest.mark.parametrize("nbands", [1, 3, 4, 7])
def test_merge_apply_plain_version(nbands, share):
    """merge_apply on the CPU (its plain version, the passes' arithmetic
    before K3: wheres and index adds) against a serial loop over the
    movers: merge map, sizes, signed int64 sums and the mover count equal
    bit for bit; its inputs stay as they were."""
    case = merge_apply_case(np.random.default_rng(nbands), 3000, nbands,
                            share)
    before = [t.clone() for t in case]
    launches = elim_small.merge_apply.launches
    want = _apply_by_loop(*case, 5, 100.0)
    got = elim_small.merge_apply(*case, 5, 100.0)
    assert [g.dtype for g in got] == [torch.int64] * 4
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    assert (want[3] == 0) == (share == "none")
    assert all(torch.equal(t, b) for t, b in zip(case, before))
    assert elim_small.merge_apply.launches == launches


@pytest.mark.parametrize("nbands", [1, 3])
def test_graph_loop_leaves_its_inputs(nbands):
    """eliminate_small_segments_graph works on its own copies of the sizes
    and sums (K3 updates them in place on the card): the caller's tensors,
    a one-band transpose view included, are unchanged."""
    img, seg, num = _clumped(8)
    seg_t = torch.from_numpy(seg.astype(np.int32))
    size = segreduce.seg_sizes(seg_t, num + 1)
    spect = segreduce.seg_spectral_sums(
        seg_t, torch.from_numpy(img[:nbands].astype(np.int32)), num + 1)
    a, b, first, _ = elim_small.edge_sort_keys(seg_t, True)
    ea, eb = elim_small.compact_edges(a, b, first)
    before = size.clone(), spect.clone()
    _, size_out, n, passes = elim_small.eliminate_small_segments_graph(
        ea, eb, size, spect, 8, 30.0)
    assert n > 0 and passes > 0 and not torch.equal(size_out, size)
    assert torch.equal(size, before[0]) and torch.equal(spect, before[1])
