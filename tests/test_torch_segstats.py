"""The port's device run compaction (ops/segstats.py, run here on the CPU)
against the JAX package's device compaction and the host compactTile, on
the same numpy tiles: every output is an integer array, so the tolerance
is zero throughout."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyshepseg_tpu import tilingstats as jax_tilingstats
from pyshepseg_tpu.ops import segstats as jax_segstats
from pyshepseg_tpu_torch import tilingstats
from pyshepseg_tpu_torch.ops import segstats
import torch_parity  # noqa: F401  (one torch thread)

DTYPES = {np.uint8: (0, 256), np.uint16: (0, 65536), np.int8: (-128, 128),
          np.int16: (-32768, 32768),
          np.int32: (-2 ** 31, 2 ** 31 - 1)}


def make_tile(rng, dtype, shape=(70, 90), segBase=0, nseg=30, nvals=60):
    """Segment ids segBase+1..segBase+nseg with ~10 % null pixels; values
    drawn from ``nvals`` distinct values spread over the dtype's range
    (its extremes included), so runs repeat within segments."""
    seg = rng.integers(1, nseg + 1, size=shape).astype(np.int64) + segBase
    seg[rng.random(shape) < 0.1] = 0
    lo, hi = DTYPES[dtype]
    palette = np.unique(np.concatenate(
        [[lo, hi - 1], rng.integers(lo, hi, size=nvals - 2)]))
    img = palette[rng.integers(0, len(palette), size=shape)].astype(dtype)
    return seg.astype(np.uint32), img


def assert_same_runs(got, want):
    if want is None:
        assert got is None
        return
    assert len(got) == len(want) == 5
    for a, b in zip(got, want):
        if b is None:
            assert a is None
        else:
            assert a.dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("segBase", [0, 70000])
@pytest.mark.parametrize("withNull", [False, True])
@pytest.mark.parametrize("dtype", sorted(DTYPES, key=str))
def test_compact_tile_matches_jax_and_host(dtype, withNull, segBase):
    """uint8/uint16/int8/int16/int32 imagery, with and without a nodata
    value that occurs, segment ids below and above 0xFFFF (where the JAX
    package leaves its packed key for the two-key sort)."""
    rng = np.random.default_rng(1)
    seg, img = make_tile(rng, dtype, segBase=segBase)
    numSeg = int(seg.max()) + 1
    nullVal = int(img[3, 4]) if withNull else None
    got = segstats.compactTileDevice(seg, img, nullVal, numSeg,
                                     device="cpu")
    assert_same_runs(got, jax_segstats.compactTileDevice(
        seg, img, nullVal, numSeg))
    assert_same_runs(got, jax_tilingstats.compactTile(seg, img, nullVal,
                                                      numSeg))
    assert_same_runs(got, tilingstats.compactTile(seg, img, nullVal,
                                                  numSeg))
    if withNull:
        assert got[1] is not None and got[1].sum() > 0


def test_all_null_and_all_nodata_tiles():
    rng = np.random.default_rng(2)
    seg, img = make_tile(rng, np.uint16)
    zeros = np.zeros_like(seg)
    assert segstats.compactTileDevice(zeros, img, None, 31,
                                      device="cpu") is None
    assert segstats.compactTileDeviceMultiBand(
        zeros, [img, img], [None, 7], 31, device="cpu") == [None, None]
    # every valid pixel nodata: seen and nodata counts, no runs
    flat = np.full_like(img, 9)
    got = segstats.compactTileDevice(seg, flat, 9, 31, device="cpu")
    assert_same_runs(got, jax_segstats.compactTileDevice(seg, flat, 9, 31))
    assert got[2].size == 0 and (got[0] == got[1]).all()


def test_multiband_matches_jax():
    """Bands of different dtypes and nodata values in one sort equal the
    JAX package's batched compaction and one call per band."""
    rng = np.random.default_rng(3)
    seg, b1 = make_tile(rng, np.uint16, segBase=70000)
    _, b2 = make_tile(rng, np.uint16)
    _, b3 = make_tile(rng, np.uint16)
    b3[:10] = 5
    tiles, nulls = [b1, b2, b3], [int(b1[0, 0]), None, 5]
    numSeg = int(seg.max()) + 1
    got = segstats.compactTileDeviceMultiBand(seg, tiles, nulls, numSeg,
                                              device="cpu")
    want = jax_segstats.compactTileDeviceMultiBand(seg, tiles, nulls, numSeg)
    assert len(got) == 3
    for g, w, t, n in zip(got, want, tiles, nulls):
        assert_same_runs(g, w)
        assert_same_runs(g, segstats.compactTileDevice(seg, t, n, numSeg,
                                                       device="cpu"))
    # mixed dtypes in one window
    _, i8 = make_tile(rng, np.int8)
    _, i32 = make_tile(rng, np.int32)
    got = segstats.compactTileDeviceMultiBand(seg, [i8, i32], [None, None],
                                              numSeg, device="cpu")
    for g, t in zip(got, (i8, i32)):
        assert_same_runs(g, jax_tilingstats.compactTile(seg, t, None,
                                                        numSeg))


@pytest.mark.parametrize("dtype", [np.uint16, np.int16, np.uint8])
def test_scene_windows_match_jax(dtype):
    """Windows cut from whole-scene tensors (the scene-resident feed)
    equal the JAX package's windows of its device arrays, band by band
    and batched, ragged edge windows included."""
    rng = np.random.default_rng(4)
    seg, b1 = make_tile(rng, dtype, shape=(120, 130), nseg=80)
    _, b2 = make_tile(rng, dtype, shape=(120, 130), nseg=80)
    numSeg = 81
    nulls = [int(b1[5, 5]), None]
    segDev = segstats.uploadInt32(seg, "cpu")
    valsDev = torch.stack([segstats.uploadInt32(b, "cpu") for b in (b1, b2)])
    jseg = jnp.asarray(seg)
    jvals = jnp.asarray(np.stack([b1, b2]))
    for window in [(48, 48, 0, 0), (34, 48, 96, 48), (48, 24, 48, 96),
                   (34, 24, 96, 96)]:
        got = segstats.compactSceneWindowDeviceMultiBand(
            segDev, valsDev, window, nulls, numSeg)
        want = jax_segstats.compactSceneWindowDeviceMultiBand(
            jseg, jvals, window, nulls, numSeg)
        for g, w in zip(got, want):
            assert_same_runs(g, w)
        one = segstats.compactSceneWindowDevice(
            segDev, valsDev[0], window, nulls[0], numSeg)
        assert_same_runs(one, jax_segstats.compactSceneWindowDevice(
            jseg, jnp.asarray(b1), window, nulls[0], numSeg))


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.int8, np.int16,
                                   np.int32, np.uint32])
def test_upload_keeps_values(dtype):
    a = np.array([[0, 1, 127], [100, 3, 2]], dtype=dtype)
    if dtype in (np.uint16,):
        a[0, 0] = 65535
    if dtype in (np.int8, np.int16, np.int32):
        a[1, 0] = -5
    t = segstats.uploadInt32(a, "cpu")
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(t.numpy(), a.astype(np.int64))


def test_supported_dtypes_and_limits():
    for d in (np.int8, np.uint8, np.int16, np.uint16, np.int32):
        assert segstats.deviceCompactSupported(d)
        assert segstats.deviceCompactSupported(d) == \
            jax_segstats.deviceCompactSupported(d)
    for d in (np.uint32, np.int64, np.float32):
        assert not segstats.deviceCompactSupported(d)
    seg = torch.ones((2, 2), dtype=torch.int32)
    with pytest.raises(ValueError):
        segstats.windowRuns(seg, seg[None], [None], 2 ** 31 + 1)
    # counted only on a CUDA device
    before = segstats.windowRuns.cuda_calls
    segstats.windowRuns(seg, seg[None], [None], 2)
    assert segstats.windowRuns.cuda_calls == before


def test_cuda_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    seg, img = make_tile(np.random.default_rng(5), np.uint8)
    with pytest.raises(RuntimeError):
        segstats.compactTileDevice(seg, img, None, 31)
