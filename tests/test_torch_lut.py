"""Small-table gather (kernel K2's contract): the port's plain version
against the JAX package's Pallas kernel (interpreted), bit for bit."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pyshepseg_tpu.ops import lut as jax_lut
from pyshepseg_tpu_torch.ops import lut


@pytest.mark.parametrize("shape,c", [
    ((8, 128), 16),
    ((128, 200), 4096),
    ((100, 100), 1000),
    ((513, 128), 32768),
])
def test_lut_gather_matches_jax(rng, shape, c):
    idx = rng.integers(0, c, size=shape).astype(np.uint32)
    table = rng.integers(0, 2 ** 32, size=(c,), dtype=np.uint64).astype(
        np.uint32)
    want = np.asarray(jax_lut.lut_gather(jnp.asarray(idx), jnp.asarray(table),
                                         interpret=True))
    # uint32 ids travel as int64 in the port
    got = lut.lut_gather(torch.from_numpy(idx.astype(np.int32)),
                         torch.from_numpy(table.astype(np.int64))).numpy()
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got.astype(np.uint32), want)


@pytest.mark.parametrize("n,c", [(1, 1), (777, 300), (12000, 4096)])
def test_lut_gather_flat_matches_jax(rng, n, c):
    idx = rng.integers(0, c, size=n).astype(np.int32)
    table = rng.integers(0, 2 ** 31 - 1, size=(c,)).astype(np.int32)
    want = np.asarray(jax_lut.lut_gather_flat(jnp.asarray(idx),
                                              jnp.asarray(table),
                                              interpret=True))
    got = lut.lut_gather_flat(torch.from_numpy(idx),
                              torch.from_numpy(table))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_use_lut_gate():
    assert lut.use_lut(4096, "cuda")
    assert lut.use_lut(lut.LUT_MAX_TABLE, "cuda:0")
    assert not lut.use_lut(lut.LUT_MAX_TABLE + 1, "cuda")
    assert not lut.use_lut(16, "cpu")
    assert lut.LUT_MAX_TABLE == jax_lut.LUT_MAX_TABLE


def test_remap_and_relabel_matches_jax(rng):
    """The final relabel's table and gather, as in test_lut.py's wired
    route."""
    from pyshepseg_tpu.ops import elim_small as jax_elim_small
    from pyshepseg_tpu_torch.ops import elim_small

    capacity = 1024
    seg = rng.integers(0, 200, size=(64, 96)).astype(np.uint32)
    remap = rng.integers(0, 150, size=(capacity,)).astype(np.uint32)
    sizes = np.zeros(capacity, np.uint32)
    survivors = np.unique(remap)
    sizes[survivors] = rng.integers(1, 50, size=len(survivors))
    want = np.asarray(jax_elim_small._remap_and_relabel(
        jnp.asarray(seg), jnp.asarray(remap), jnp.asarray(sizes)))
    got = elim_small._remap_and_relabel(
        torch.from_numpy(seg.astype(np.int32)),
        torch.from_numpy(remap.astype(np.int64)),
        torch.from_numpy(sizes.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want)

