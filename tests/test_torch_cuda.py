"""The CUDA kernels and the port on the card, against their plain PyTorch
versions and the CPU run. Each test skips where there is no CUDA device.

This file imports no JAX and uses no conftest fixture, so it also runs on
a machine that has only torch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from pyshepseg_tpu_torch import shepseg
from pyshepseg_tpu_torch.ops import clump, local_ccl, lut
from torch_parity import (need_cuda, padded_clusters, random_clusters,
                          voronoi_image)

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("block", [32, None])
@pytest.mark.parametrize("four_connected", [True, False])
def test_local_ccl_kernel_matches_plain(block, four_connected):
    need_cuda()
    img = torch.from_numpy(padded_clusters(
        np.random.default_rng(5), (250, 380), 128)).cuda()
    before = local_ccl.local_ccl_blocks.launches
    got = local_ccl.local_ccl_blocks(img, 0, four_connected, block=block)
    want = local_ccl.local_ccl_blocks_reference(img, 0, four_connected,
                                                block=block)
    assert torch.equal(got, want)
    assert local_ccl.local_ccl_blocks.launches == before + 1


def test_local_ccl_kernel_rejects_wrong_dtype():
    need_cuda()
    with pytest.raises(ValueError):
        local_ccl.local_ccl_blocks(
            torch.zeros((64, 64), dtype=torch.int64, device="cuda"), 0, True)


@pytest.mark.parametrize("shape,c", [((1024, 1024), 4096), ((13,), 7),
                                     ((777, 1031), 32768)])
def test_lut_kernel_matches_plain(shape, c):
    need_cuda()
    rng = np.random.default_rng(2)
    idx = torch.from_numpy(rng.integers(0, c, size=shape).astype(
        np.int32)).cuda()
    table = torch.from_numpy(rng.integers(0, 2 ** 32, size=c,
                                          dtype=np.int64)).cuda()
    before = lut.lut_gather.launches
    assert torch.equal(lut.lut_gather(idx, table),
                       lut.lut_gather_reference(idx, table))
    assert lut.lut_gather.launches == before + 1


def test_lut_kernel_rejects_oversize_table():
    need_cuda()
    idx = torch.zeros(8, dtype=torch.int32, device="cuda")
    table = torch.zeros(lut.LUT_MAX_TABLE + 1, dtype=torch.int32,
                        device="cuda")
    with pytest.raises(ValueError):
        lut.lut_gather(idx, table)


@pytest.mark.parametrize("four_connected", [True, False])
def test_clump_on_card_matches_cpu(four_connected):
    need_cuda()
    clusters = random_clusters(np.random.default_rng(9), (300, 421))
    got, n_got = clump.clump(clusters, 0, four_connected, device="cuda")
    want, n_want = clump.clump(clusters, 0, four_connected, device="cpu")
    assert n_got == n_want
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("four_connected,min_size", [(True, 20), (False, 1)])
def test_segmentation_on_card_matches_cpu(four_connected, min_size):
    need_cuda()
    img, _ = voronoi_image(np.random.default_rng(5), shape=(200, 240))
    kw = dict(numClusters=12, minSegmentSize=min_size,
              fourConnected=four_connected)
    km = shepseg.fitSpectralClusters(img, 12, 100, None, True, device="cuda")
    before = (local_ccl.local_ccl_blocks.launches, lut.lut_gather.launches)
    got = shepseg.doShepherdSegmentation(img, kmeansObj=km, device="cuda",
                                         **kw)
    assert local_ccl.local_ccl_blocks.launches > before[0]
    assert lut.lut_gather.launches > before[1]
    want = shepseg.doShepherdSegmentation(img, kmeansObj=km, device="cpu",
                                          **kw)
    np.testing.assert_array_equal(got.segimg, want.segimg)
    assert got.singlePixelsEliminated == want.singlePixelsEliminated
    assert got.smallSegmentsEliminated == want.smallSegmentsEliminated


@pytest.mark.parametrize("block", [32, 128])
@pytest.mark.parametrize("pattern", ["uniform", "stripes", "checker"])
def test_local_ccl_kernel_under_contention(block, pattern):
    """Shapes that stress the union-find: one component per block (every
    thread hooks into the same tree), long thin components, and diagonal
    -only connections (8-connected checkerboard)."""
    need_cuda()
    yy, xx = np.mgrid[0:256, 0:384]
    img = {"uniform": np.ones_like(yy),
           "stripes": 1 + (yy // 2) % 2,
           "checker": 1 + (yy + xx) % 2}[pattern].astype(np.int32)
    img_t = torch.from_numpy(img).cuda()
    for four_connected in (True, False):
        got = local_ccl.local_ccl_blocks(img_t, 0, four_connected,
                                         block=block)
        want = local_ccl.local_ccl_blocks_reference(img_t, 0, four_connected,
                                                    block=block)
        assert torch.equal(got, want)
