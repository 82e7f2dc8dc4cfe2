"""Block-local CCL (kernel K1's contract): the port's plain version against
the JAX package's Pallas kernel (interpreted on the CPU) at block 32."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pyshepseg_tpu.ops.pallas_ccl import local_ccl_blocks as jax_local_ccl
from pyshepseg_tpu_torch.ops import local_ccl
from torch_parity import padded_clusters

INT32_MAX = 2147483647


def _is_block_fixpoint(img, lab, block, four_connected):
    """Whether labels are the block-local neighbour-min fixpoint (the JAX
    kernel stops after 64 rounds, possibly short of it)."""
    t = torch.tensor(lab)
    ref = local_ccl.local_ccl_blocks_reference(
        torch.from_numpy(img), 0, four_connected, block)
    return torch.equal(t, ref)


@pytest.mark.parametrize("shape", [(64, 64), (40, 56)])
@pytest.mark.parametrize("four_connected", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_matches_jax_kernel(shape, four_connected, seed):
    rng = np.random.default_rng(seed)
    img = padded_clusters(rng, shape, 32)
    want = np.asarray(jax_local_ccl(jnp.asarray(img), 0, four_connected,
                                    block=32))
    got = local_ccl.local_ccl_blocks(torch.from_numpy(img), 0,
                                     four_connected, block=32).numpy()
    if _is_block_fixpoint(img, want, 32, four_connected):
        np.testing.assert_array_equal(got, want)
    else:
        # the weaker contract: labels only decrease, and each is the
        # flat index of a pixel of the same block-local component
        valid = img != 0
        assert (got <= want).all()
        assert (want[~valid] == INT32_MAX).all()
        src = want[valid]
        assert (got.ravel()[src] == got[valid]).all()


def test_invalid_pixels_get_int32_max(rng):
    img = padded_clusters(rng, (32, 32), 32)
    got = local_ccl.local_ccl_blocks(torch.from_numpy(img), 0, True).numpy()
    assert (got[img == 0] == INT32_MAX).all()
    assert (got[img != 0] < img.size).all()


def test_multi_block_uniform_image():
    # one global component: each 32x32 block is labelled with its own
    # top-left flat index (merging across blocks is clump's job)
    img = np.ones((64, 96), np.int32)
    got = local_ccl.local_ccl_blocks(torch.from_numpy(img), 0, True,
                                     block=32).numpy()
    for by in range(2):
        for bx in range(3):
            blk = got[by * 32:(by + 1) * 32, bx * 32:(bx + 1) * 32]
            assert (blk == by * 32 * 96 + bx * 32).all()


def test_rejects_ragged_image():
    with pytest.raises(ValueError):
        local_ccl.local_ccl_blocks(torch.zeros((40, 64), dtype=torch.int32),
                                   0, True, block=32)


def test_rejects_block_beyond_shared_memory():
    # the TPU kernel's 256x256 block does not fit a Hopper block's shared
    # memory; the limit holds on every device, so CPU and card agree
    with pytest.raises(ValueError):
        local_ccl.local_ccl_blocks(
            torch.zeros((512, 512), dtype=torch.int32), 0, True, block=256)


@pytest.mark.parametrize("h,w", [(1, 1), (80, 80), (128, 300), (1000, 77)])
def test_block_shape_for(h, w):
    (by, bx), (hp, wp) = local_ccl.block_shape_for(h, w)
    assert hp % by == 0 and wp % bx == 0
    assert hp >= h and wp >= w
    assert by <= local_ccl.BLOCK and bx <= local_ccl.BLOCK
    assert 8 * by * bx <= local_ccl.MAX_SHARED_BYTES

