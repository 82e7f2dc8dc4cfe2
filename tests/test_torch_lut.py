"""Table gather (kernel K2's contract): the port's plain version and route
choice, against the JAX package's Pallas kernel (interpreted) and its XLA
gather above the kernel's table, bit for bit."""

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


@pytest.mark.parametrize("idx_dtype,table_dtype", [
    (np.int64, np.int64), (np.int32, np.int64), (np.int64, np.int32)])
def test_lut_gather_dtypes_match_jax(rng, idx_dtype, table_dtype):
    """The index and table types the graph passes hand K2 (int32 edge ends
    into the int64 remap, the int64 remap into the int64 merge map): the
    result keeps the table's type and equals the JAX kernel's."""
    c = 3000
    idx = rng.integers(0, c, size=(64, 128)).astype(idx_dtype)
    table = rng.integers(0, 2 ** 31 - 1, size=(c,)).astype(table_dtype)
    want = np.asarray(jax_lut.lut_gather(
        jnp.asarray(idx.astype(np.int32)), jnp.asarray(
            table.astype(np.int32)), interpret=True))
    got = lut.lut_gather(torch.from_numpy(idx), torch.from_numpy(table))
    assert got.dtype == torch.from_numpy(table).dtype
    np.testing.assert_array_equal(got.numpy(), want)


def test_use_lut_gate():
    """K2 takes every table it can address on every CUDA device: the JAX
    package's 32768-entry limit does not gate the port."""
    assert lut.use_lut(4096, "cuda")
    assert lut.use_lut(jax_lut.LUT_MAX_TABLE + 1, "cuda")
    assert lut.use_lut(lut.MAX_TABLE, "cuda:0")
    assert not lut.use_lut(lut.MAX_TABLE + 1, "cuda")
    assert not lut.use_lut(16, "cpu")


# the H100's opt-in shared memory per block: 227 KB
_SMEM = 232448
_BIG = lut.STAGED_MIN_BYTES // 4     # the smallest int32 table staged


@pytest.mark.parametrize("n,c,dtype,want", [
    # reuse on each side of the threshold
    (lut.STAGED_MIN_REUSE * _BIG, _BIG, torch.int32, "staged"),
    (lut.STAGED_MIN_REUSE * _BIG - 1, _BIG, torch.int32, "direct"),
    # table bytes on each side of the threshold
    (10 ** 8, _BIG - 1, torch.int32, "direct"),
    (1024 * 1024, 434, torch.int32, "direct"),     # config1's relabel
    (4096 * 4096, 56000, torch.int32, "staged"),   # a dense tile's relabel
    (72000, 24000, torch.int64, "direct"),         # a graph pass
    (24308, 24308, torch.int64, "direct"),         # the remap composition
    # the largest tables that fit, and one entry more
    (10 ** 8, (_SMEM - lut.STAGED_PAD) // 4, torch.int32, "staged"),
    (10 ** 8, (_SMEM - lut.STAGED_PAD) // 4 + 1, torch.int32, "direct"),
    (10 ** 8, (_SMEM - lut.STAGED_PAD) // 8, torch.int64, "staged"),
    (10 ** 8, (_SMEM - lut.STAGED_PAD) // 8 + 1, torch.int64, "direct"),
    # int64 entries take twice the bytes
    (10 ** 8, _BIG // 2, torch.int64, "staged"),
    (10 ** 8, _BIG // 2, torch.int32, "direct"),
    (10 ** 8, 40000, torch.int32, "direct"),
    (10 ** 8, 40000, torch.int64, "direct"),   # above shared memory
])
def test_lut_route(n, c, dtype, want):
    assert lut.lut_route(n, c, dtype, _SMEM) == want


def test_remap_and_relabel_matches_jax(rng):
    """The final relabel's table and gather, as in test_lut.py's wired
    route."""
    _check_remap_and_relabel(rng, 1024, 200, 150)


def test_remap_and_relabel_above_jax_table_matches_jax(rng):
    """A table above the JAX kernel's 32768 entries, which the JAX package
    gathers with XLA off the TPU and K2 takes on the card."""
    _check_remap_and_relabel(rng, 40000, 40000, 30000)


def _check_remap_and_relabel(rng, capacity, nids, nsurvivors):
    from pyshepseg_tpu.ops import elim_small as jax_elim_small
    from pyshepseg_tpu_torch.ops import elim_small

    seg = rng.integers(0, nids, size=(64, 96)).astype(np.uint32)
    remap = rng.integers(0, nsurvivors, size=(capacity,)).astype(np.uint32)
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

