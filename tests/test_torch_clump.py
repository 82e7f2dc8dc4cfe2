"""Clumping: the port's clump against the JAX package's clump and the
flood-fill oracle; the result must not depend on the seed's block size."""

import numpy as np
import pytest
import torch

from pyshepseg_tpu.ops.clump import clump as jax_clump
from pyshepseg_tpu_torch.ops import clump, local_ccl
from oracle import oracle_clump
from torch_parity import random_clusters


@pytest.mark.parametrize("shape", [(40, 56), (64, 64)])
@pytest.mark.parametrize("four_connected", [True, False])
@pytest.mark.parametrize("null_frac", [0.0, 0.15])
def test_clump_matches_jax_and_oracle(shape, four_connected, null_frac):
    rng = np.random.default_rng(sum(shape))
    clusters = random_clusters(rng, shape, null_frac=null_frac)
    got, got_next = clump.clump(clusters, 0, fourConnected=four_connected,
                                device="cpu")
    want, want_next = jax_clump(clusters, 0, fourConnected=four_connected)
    ref, ref_next = oracle_clump(clusters, 0, fourConnected=four_connected)
    assert got.dtype == np.uint32
    assert got_next == want_next == ref_next
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("four_connected", [True, False])
def test_clump_independent_of_block_size(monkeypatch, four_connected):
    rng = np.random.default_rng(11)
    # few clusters: large snaking components that cross many blocks
    img = torch.from_numpy(
        random_clusters(rng, (72, 88), nclusters=2).astype(np.int32))
    results = []
    for block in (8, 16, 32, 128):
        monkeypatch.setattr(local_ccl, "BLOCK", block)
        seg, num, _ = clump.clump_labels(img, 0, four_connected)
        results.append((seg.numpy(), num))
    for seg, num in results[1:]:
        assert num == results[0][1]
        np.testing.assert_array_equal(seg, results[0][0])


def test_clump_spiral_needs_many_sweeps():
    # a one-pixel-wide spiral: one component whose label must travel the
    # whole path (exercises the sweep loop and its pointer jumps)
    n = 48
    img = np.zeros((n, n), np.int32)
    y0, x0, y1, x1 = 0, 0, n - 1, n - 1
    while y0 <= y1 and x0 <= x1:
        img[y0, x0:x1 + 1] = 1
        img[y0:y1 + 1, x1] = 1
        if y1 - y0 >= 2:
            img[y1, x0:x1 + 1] = 1
        if x1 - x0 >= 2:
            img[y0 + 2:y1 + 1, x0] = 1
        y0, x0, y1, x1 = y0 + 2, x0 + 2, y1 - 2, x1 - 2
    got, nxt = clump.clump(img, 0, fourConnected=True, device="cpu")
    ref, ref_nxt = oracle_clump(img, 0, fourConnected=True)
    assert nxt == ref_nxt
    np.testing.assert_array_equal(got, ref)


def test_clump_id_offset():
    rng = np.random.default_rng(3)
    clusters = random_clusters(rng, (24, 24))
    base, nxt = clump.clump(clusters, 0, device="cpu")
    shifted, nxt2 = clump.clump(clusters, 0, clumpId=10, device="cpu")
    assert nxt2 == nxt + 9
    np.testing.assert_array_equal(
        shifted, np.where(base > 0, base + 9, 0).astype(np.uint32))


def test_clump_rejects_max_clump_size():
    """maxClumpSize is no longer rejected: it runs the host flood fill
    with the reference's cap (parity with the JAX package is held in
    test_torch_compat.py): the cap splits the one 16-pixel clump."""
    got, nxt = clump.clump(np.ones((4, 4), np.uint32), 0, maxClumpSize=3,
                           device="cpu")
    want, want_nxt = oracle_clump(np.ones((4, 4), np.uint32), 0,
                                  fourConnected=True)
    assert want_nxt == 2 and nxt > want_nxt
    assert got.dtype == np.uint32 and (got > 0).all()

