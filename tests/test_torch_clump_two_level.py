"""The two-level clump merge (block-local labels, boundary-root graph,
verify, fallback into the sweeps): the port's pieces against the JAX
package's on the same numpy inputs, and the whole against the sweeps, the
JAX package's clump and the flood-fill oracle."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pyshepseg_tpu.ops.clump import (
    _boundary_edges as jax_boundary_edges,
    _merge_boundary_roots as jax_merge_boundary_roots,
    clump as jax_clump)
from pyshepseg_tpu_torch.ops import clump, local_ccl
from oracle import oracle_clump
from torch_parity import random_clusters


def _seeded(monkeypatch, img, four_connected, block):
    """(labels, (by, bx), sentinel): the block-local seed the port's
    clump starts from, at a small BLOCK."""
    monkeypatch.setattr(local_ccl, "BLOCK", block)
    img_t = torch.from_numpy(img)
    sentinel = img.size
    labels = clump._seed_labels(img_t, 0, four_connected, img_t != 0,
                                sentinel)
    return labels, local_ccl.block_shape_for(*img.shape)[0], sentinel


def _edges(labels, img, blk, four_connected, sentinel):
    port = clump._boundary_edges(labels, torch.from_numpy(img), 0, *blk,
                                 four_connected, sentinel)
    jax = jax_boundary_edges(jnp.asarray(labels.numpy()), jnp.asarray(img),
                             0, *blk, four_connected, sentinel)
    return port, jax


@pytest.mark.parametrize("shape", [(40, 56), (33, 47)])
@pytest.mark.parametrize("block", [8, 16])
@pytest.mark.parametrize("four_connected", [True, False])
def test_boundary_edges_match_jax(monkeypatch, shape, block, four_connected):
    rng = np.random.default_rng(shape[0] + block)
    img = random_clusters(rng, shape, nclusters=2).astype(np.int32)
    labels, blk, sentinel = _seeded(monkeypatch, img, four_connected, block)
    (ea, eb), (ja, jb) = _edges(labels, img, blk, four_connected, sentinel)
    assert ea.dtype == torch.int32
    np.testing.assert_array_equal(ea.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(eb.numpy(), np.asarray(jb))
    assert (ea != sentinel).any()


@pytest.mark.parametrize("shape", [(40, 56), (33, 47)])
@pytest.mark.parametrize("block", [8, 16])
@pytest.mark.parametrize("four_connected", [True, False])
def test_merge_boundary_roots_match_jax(monkeypatch, shape, block,
                                        four_connected):
    rng = np.random.default_rng(shape[1] + block)
    img = random_clusters(rng, shape, nclusters=2,
                          null_frac=0.05).astype(np.int32)
    labels, blk, sentinel = _seeded(monkeypatch, img, four_connected, block)
    (ea, eb), (ja, jb) = _edges(labels, img, blk, four_connected, sentinel)
    uniq, m, iterations = clump._merge_boundary_roots(ea, eb, sentinel)
    juniq, jm = jax_merge_boundary_roots(ja, jb, np.int32(sentinel))
    np.testing.assert_array_equal(uniq.numpy(), np.asarray(juniq))
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    assert iterations >= 1


def test_merge_boundary_roots_all_sentinel():
    """No valid boundary pair: every slot stays the sentinel."""
    ea = torch.full((12,), 99, dtype=torch.int32)
    uniq, m, iterations = clump._merge_boundary_roots(ea, ea.clone(), 99)
    juniq, jm = jax_merge_boundary_roots(jnp.asarray(ea.numpy()),
                                         jnp.asarray(ea.numpy()),
                                         np.int32(99))
    np.testing.assert_array_equal(uniq.numpy(), np.asarray(juniq))
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    assert (m == 99).all() and iterations == 1


def _all_agree(img, four_connected, stats):
    """clump_labels with the merge == without it == the JAX package's
    clump == the oracle; returns the merge's labels."""
    img_t = torch.from_numpy(img.astype(np.int32))
    seg, num, sweeps = clump.clump_labels(img_t, 0, four_connected,
                                          stats=stats)
    seg_s, num_s, _ = clump.clump_labels(img_t, 0, four_connected,
                                         two_level=False)
    want, want_next = jax_clump(img, 0, fourConnected=four_connected)
    ref, ref_next = oracle_clump(img, 0, fourConnected=four_connected)
    assert torch.equal(seg, seg_s)
    assert num == num_s == want_next - 1 == ref_next - 1
    np.testing.assert_array_equal(seg.numpy(), np.asarray(want))
    np.testing.assert_array_equal(seg.numpy(), ref)
    return seg, sweeps


@pytest.mark.parametrize("four_connected", [True, False])
@pytest.mark.parametrize("null_frac", [0.0, 0.1])
def test_two_level_matches_sweeps_jax_and_oracle(monkeypatch, four_connected,
                                                 null_frac):
    monkeypatch.setattr(local_ccl, "BLOCK", 16)
    rng = np.random.default_rng(21)
    img = random_clusters(rng, (72, 80), nclusters=2, null_frac=null_frac)
    stats = {}
    _, sweeps = _all_agree(img, four_connected, stats)
    assert sweeps == 0 and stats["sweeps"] == 0
    assert stats["two_level"] and not stats["fallback"]
    assert stats["edges"] > 0 and stats["merge_iterations"] >= 1


def test_two_level_multiblock_264():
    """The JAX package's two-level test image (tests/test_clump.py): block
    boundaries in both axes at the default BLOCK, components crossing
    them."""
    rng = np.random.default_rng(264)
    img = random_clusters(rng, (264, 264), nclusters=2, null_frac=0.02)
    img[250:262, :] = 5
    img[:, 250:262] = 5
    for four_connected in (True, False):
        stats = {}
        _all_agree(img, four_connected, stats)
        assert stats["two_level"] and not stats["fallback"]


def test_two_level_uniform_and_null_images(monkeypatch):
    monkeypatch.setattr(local_ccl, "BLOCK", 8)
    for img in (np.ones((24, 40), np.uint32), np.zeros((24, 40), np.uint32)):
        stats = {}
        seg, _ = _all_agree(img, True, stats)
        assert stats["two_level"]
        assert int(seg.max()) == int(img.max())


def test_two_level_one_block_sweeps(monkeypatch):
    """One block has no boundary: the sweeps run, as in the JAX package."""
    monkeypatch.setattr(local_ccl, "BLOCK", 64)
    img = random_clusters(np.random.default_rng(2), (40, 48))
    stats = {}
    _, sweeps = _all_agree(img, True, stats)
    assert not stats["two_level"] and not stats["fallback"]
    assert sweeps == stats["sweeps"] >= 1


def _own_index(img, ignore_val, four_connected, block=None):
    """A seed that is not block-converged: every pixel its own index."""
    flat = torch.arange(img.numel(), dtype=torch.int32).reshape(img.shape)
    return torch.where(img != ignore_val, flat, local_ccl.INT32_MAX)


def _two_rounds(img, ignore_val, four_connected, block=None):
    """The plain K1 cut short: two rounds of neighbour min per block (the
    JAX kernel's iteration cap, made small)."""
    from pyshepseg_tpu_torch.ops.shifts import shift, offsets_for
    labels = _own_index(img, ignore_val, four_connected)
    by, bx = block
    # block id of every pixel: no label crosses a block boundary
    ids = (torch.arange(img.shape[0])[:, None] // by * img.shape[1] +
           torch.arange(img.shape[1])[None, :] // bx)
    for _ in range(2):
        new = labels
        for dy, dx in offsets_for(four_connected):
            same = ((img == shift(img, dy, dx, ignore_val)) &
                    (img != ignore_val) & (ids == shift(ids, dy, dx, -1)))
            new = torch.minimum(new, torch.where(
                same, shift(labels, dy, dx, local_ccl.INT32_MAX),
                local_ccl.INT32_MAX))
        labels = new
    return labels


def _serpentine(h, w):
    """tests/test_clump.py's serpentine: one component snaking through
    every row, across block boundaries in both axes."""
    img = np.zeros((h, w), dtype=np.uint32)
    for r in range(0, h, 2):
        img[r, :] = 1
        if r + 1 < h:
            img[r + 1, -1 if (r // 2) % 2 == 0 else 0] = 1
    return img


@pytest.mark.parametrize("case", ["own index", "serpentine"])
def test_two_level_falls_back_on_unconverged_seed(monkeypatch, case):
    """The verify catches a seed that is not block-converged, counts the
    fallback, and the sweeps still give the oracle's answer."""
    monkeypatch.setattr(local_ccl, "BLOCK", 16)
    if case == "own index":
        img = random_clusters(np.random.default_rng(8), (48, 64),
                              nclusters=2)
        seed = _own_index
    else:
        img = _serpentine(40, 72)
        seed = _two_rounds
    img_t = torch.from_numpy(img.astype(np.int32))
    before = clump.clump_labels.fallbacks
    stats = {}
    seg, num, sweeps = clump.clump_labels(img_t, 0, True, local_ccl=seed,
                                          stats=stats)
    ref, ref_next = oracle_clump(img, 0, fourConnected=True)
    np.testing.assert_array_equal(seg.numpy(), ref)
    assert num == ref_next - 1
    assert clump.clump_labels.fallbacks == before + 1
    assert stats["fallback"] and not stats["two_level"]
    assert sweeps == stats["sweeps"] > 0


def test_exact_seed_never_falls_back(monkeypatch):
    monkeypatch.setattr(local_ccl, "BLOCK", 16)
    img = _serpentine(40, 72)
    before = clump.clump_labels.fallbacks
    seg, _, sweeps = clump.clump_labels(
        torch.from_numpy(img.astype(np.int32)), 0, True)
    assert clump.clump_labels.fallbacks == before and sweeps == 0
    np.testing.assert_array_equal(seg.numpy(),
                                  oracle_clump(img, 0, True)[0])
