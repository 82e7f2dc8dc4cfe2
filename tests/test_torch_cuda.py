"""The CUDA kernels and the port on the card, against their plain PyTorch
versions and the CPU run, in memory and through the tiled driver. Each
test skips where there is no CUDA device.

This file imports no JAX and uses no conftest fixture, so it also runs on
a machine that has only torch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from pyshepseg_tpu_torch import shepseg, tiling
from pyshepseg_tpu_torch.ops import clump, elim_small, local_ccl, lut
from pyshepseg_tpu_torch.ops import segreduce
from torch_parity import (merge_apply_case, need_cuda, padded_clusters,
                          random_clusters, read_output, voronoi_image,
                          write_raster)

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


@pytest.mark.parametrize("route", ["direct", "staged"])
def test_lut_kernel_counts_its_bytes_in_the_trace(route):
    """Under a profiler session each launch adds its index bytes, output
    bytes and table bytes to the trace's ``lut_gather.bytes``."""
    from torch.profiler import ProfilerActivity, profile
    from pyshepseg_tpu_torch import timinghooks
    need_cuda()
    n, c = 72000, 24000
    idx = torch.randint(0, c, (n,), dtype=torch.int32, device="cuda")
    table = torch.arange(c, dtype=torch.int64, device="cuda")
    assert not timinghooks.tracing()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        lut.lut_gather(idx, table, route=route)
        lut.lut_gather(idx, table, route=route)
    counts = timinghooks.TRACE.counts
    assert counts["lut_gather.bytes"] == 2 * (n * (4 + 8) + c * 8)
    assert counts["lut_gather.launches"] == 2
    assert counts["lut_gather.%s_launches" % route] == 2


def _lut_case(rng, n, c, idx_dtype, table_dtype, offset=0):
    """Indices and a table on the card, both sliced at ``offset`` (a view
    whose data pointer is not 16-byte aligned when offset > 0); table
    values use all 32 or 63 bits of the type."""
    hi = 2 ** 31 - 1 if table_dtype == torch.int32 else 2 ** 62
    table = torch.from_numpy(rng.integers(0, hi, size=c + offset)).to(
        "cuda", table_dtype)[offset:]
    idx = torch.from_numpy(rng.integers(0, c, size=n + offset)).to(
        "cuda", idx_dtype)[offset:]
    return idx, table


@pytest.mark.parametrize("route", ["direct", "staged"])
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("table_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("n,c", [(1, 1), (13, 7), (72000, 24000),
                                 (300001, 4096)])
def test_lut_kernel_routes_match_plain(route, idx_dtype, table_dtype, n, c):
    need_cuda()
    idx, table = _lut_case(np.random.default_rng(3), n, c, idx_dtype,
                           table_dtype)
    before = (lut.lut_gather.launches,
              getattr(lut.lut_gather, route + "_launches"))
    got = lut.lut_gather(idx, table, route=route)
    assert got.dtype == table_dtype
    assert torch.equal(got, lut.lut_gather_reference(idx, table))
    assert (lut.lut_gather.launches,
            getattr(lut.lut_gather, route + "_launches")) == (
                before[0] + 1, before[1] + 1)


def test_lut_kernel_takes_a_large_table():
    """100 000 entries: above the JAX kernel's table and above shared
    memory, so the direct route serves it at any reuse."""
    need_cuda()
    idx, table = _lut_case(np.random.default_rng(4), 2 ** 22, 100000,
                           torch.int32, torch.int64)
    before = lut.lut_gather.direct_launches
    assert torch.equal(lut.lut_gather(idx, table),
                       lut.lut_gather_reference(idx, table))
    assert lut.lut_gather.direct_launches == before + 1


@pytest.mark.parametrize("route", ["direct", "staged"])
@pytest.mark.parametrize("table_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_lut_kernel_misaligned_views(route, table_dtype, offset):
    need_cuda()
    for idx_dtype in (torch.int32, torch.int64):
        idx, table = _lut_case(np.random.default_rng(offset), 100003, 5001,
                               idx_dtype, table_dtype, offset=offset)
        assert torch.equal(lut.lut_gather(idx, table, route=route),
                           lut.lut_gather_reference(idx, table))


def test_lut_kernel_rejects_float_table():
    need_cuda()
    idx = torch.zeros(8, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError):
        lut.lut_gather(idx, torch.zeros(16, device="cuda"))


def test_lut_kernel_rejects_staging_an_oversize_table():
    need_cuda()
    idx = torch.zeros(8, dtype=torch.int32, device="cuda")
    table = torch.zeros(lut.smem_limit("cuda") // 4, dtype=torch.int32,
                        device="cuda")
    with pytest.raises(ValueError):
        lut.lut_gather(idx, table, route="staged")


# a 4096^2 tile of the benchmark's cropland holds about 1.6 M clumps
@pytest.mark.parametrize("capacity", [1024, 1_580_534])
@pytest.mark.parametrize("share", ["none", "sparse", "all"])
@pytest.mark.parametrize("nbands", [1, 3, 7])
def test_merge_apply_kernel_matches_plain(capacity, share, nbands):
    """K3 against its plain version on the CPU, bit for bit: merge map,
    sizes, signed int64 sums, mover count; it updates size and sums in
    place, and leaves the rows of non-movers that are no target, row 0
    among them, as they were."""
    need_cuda()
    case = merge_apply_case(np.random.default_rng(capacity + nbands),
                            capacity, nbands, share)
    want = elim_small.merge_apply_reference(*case, 5, 100.0)
    size, sums, best_nbr, d_best = (t.cuda() for t in case)
    before = elim_small.merge_apply.launches
    got = elim_small.merge_apply(size, sums, best_nbr, d_best, 5, 100.0)
    assert elim_small.merge_apply.launches == before + 1
    assert got[1] is size and got[2] is sums
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g.cpu(), w)
    moved = want[0] != torch.arange(capacity)
    kept = ~moved
    kept[want[0][moved]] = False
    assert bool(kept[0])
    assert torch.equal(size.cpu()[kept], case[0][kept])
    assert torch.equal(sums.cpu()[:, kept], case[1][:, kept])
    assert (int(want[3]) == 0) == (share == "none")


def test_merge_apply_kernel_rejects_what_it_does_not_take():
    """Float sums, non-contiguous sums and mixed devices raise."""
    need_cuda()
    size, sums, best_nbr, d_best = (
        t.cuda() for t in merge_apply_case(np.random.default_rng(1), 1024,
                                           3, "sparse"))
    bad = [(size, sums.float(), best_nbr, d_best),
           (size, sums.T.contiguous().T, best_nbr, d_best),
           (size, sums, best_nbr, d_best.cpu()),
           (size.cpu(), sums, best_nbr, d_best)]
    for args in bad:
        with pytest.raises(ValueError):
            elim_small.merge_apply(*args, 5, 100.0)


def test_graph_elimination_on_card_matches_cpu():
    """eliminate_small_segments_graph on the card (K3 on every pass)
    against the CPU on a noisy tile: remap, sizes, count and passes
    equal; one K3 launch a pass, its movers the segments eliminated; the
    caller's sizes and sums unchanged."""
    need_cuda()
    img, _ = voronoi_image(np.random.default_rng(3), shape=(512, 480),
                           ncentres=400, noise=40)
    seg, num = clump.clump((img[0] // 97 + 1).astype(np.uint32), 0, True,
                           device="cpu")
    runs = {}
    for device in ("cpu", "cuda"):
        seg_t = torch.from_numpy(seg.astype(np.int32)).to(device)
        size, spect = segreduce.seg_sizes_and_spectral_sums_planes(
            seg_t, segreduce.band_planes(torch.from_numpy(
                img.astype(np.int32)).to(device)), num + 1)
        a, b, first, _ = elim_small.edge_sort_keys(seg_t, True)
        ea, eb = elim_small.compact_edges(a, b, first)
        inputs = size.clone(), spect.clone()
        counts = (elim_small.merge_apply.launches,
                  elim_small.merge_apply.movers)
        out = elim_small.eliminate_small_segments_graph(ea, eb, size, spect,
                                                        40, 60.0)
        runs[device] = [t.cpu() if isinstance(t, torch.Tensor) else t
                        for t in out]
        assert torch.equal(size, inputs[0]) and torch.equal(spect, inputs[1])
        if device == "cuda":
            assert (elim_small.merge_apply.launches - counts[0],
                    elim_small.merge_apply.movers - counts[1]) == (
                        out[3], out[2])
    assert runs["cuda"][2] > 0
    assert torch.equal(runs["cuda"][0], runs["cpu"][0])
    assert torch.equal(runs["cuda"][1], runs["cpu"][1])
    assert runs["cuda"][2:] == runs["cpu"][2:]


@pytest.mark.parametrize("dtype", [np.uint16, np.float32])
def test_merge_apply_counts_in_the_trace(dtype):
    """Under a profiler session K3's launches equal the passes run and
    its movers the segments eliminated, for integer imagery; float
    imagery launches K3 no time, but the movers-only apply once a pass
    (its movers the segments eliminated) and K4 once a pass and once for
    the tile's sums, with its bytes and one span a launch."""
    from torch.profiler import ProfilerActivity, profile
    from pyshepseg_tpu_torch import timinghooks
    need_cuda()
    img, _ = voronoi_image(np.random.default_rng(6), shape=(512, 512),
                           ncentres=300, noise=60)
    km = shepseg.fitSpectralClusters(img, 30, 100, None, True,
                                     device="cuda")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        res = shepseg.doShepherdSegmentation(
            img.astype(dtype), kmeansObj=km, minSegmentSize=30,
            device="cuda")
    counts = timinghooks.TRACE.counts
    assert res.elimPasses > 0 and res.smallSegmentsEliminated > 0
    if dtype == np.float32:
        assert "merge_apply.launches" not in counts
        assert counts["merge_apply_movers.launches"] == res.elimPasses
        assert (counts["merge_apply_movers.movers"] ==
                res.smallSegmentsEliminated)
        assert counts["ordered_sum.launches"] == res.elimPasses + 1
        assert counts["ordered_sum.bytes"] > 512 * 512 * (8 + 3 * 4)
        spans = [x for x in timinghooks.TRACE.spans
                 if x.name == "segreduce.ordered_sum"]
        assert len(spans) == res.elimPasses + 1
    else:
        assert "ordered_sum.launches" not in counts
        assert counts["merge_apply.launches"] == res.elimPasses
        assert counts["merge_apply.movers"] == res.smallSegmentsEliminated


def _cpu_index_add(size, index, source, dim):
    shape = list(source.shape)
    shape[dim] = size
    return torch.zeros(shape).index_add_(dim, index.cpu(), source.cpu())


# the shapes of K4's three callers: a float 4096^2 tile's band sums into
# a cropland tile's 2^21 ids (some ids empty, runs of ~10 pixels), a
# graph pass's movers, the k-means Lloyd sums (and counts) of 10^6 points
# into 60 clusters; then runs longer than one step, single elements, an
# empty input and bins with nothing in them
@pytest.mark.parametrize("n,size,ncols,dim", [
    (4096 * 4096, 2 ** 21, 3, 0), (1581, 2 ** 21, 3, 1),
    (1_000_000, 60, 4, 0), (1_000_000, 60, None, 0), (300_000, 2, 7, 1),
    (1, 5, 2, 0), (0, 5, 3, 0), (33, 1, None, 0), (4097, 4096, 5, 1)])
def test_ordered_sum_kernel_equals_cpu_index_add(n, size, ncols, dim):
    """K4's sums equal the CPU's index_add_ into zeros bit for bit (its
    serial order), on values whose sums round in float32, with -0.0
    among them; a second launch gives the same bits."""
    need_cuda()
    gen = torch.Generator().manual_seed(n + size)
    index = torch.randint(0, size, (n,), generator=gen)
    shape = (n,) if ncols is None else ((n, ncols) if dim == 0 else
                                        (ncols, n))
    source = 0.3 + torch.rand(shape, generator=gen) * 1e-3 * torch.randn(
        shape, generator=gen)
    source.view(-1)[::97] = -0.0
    want = _cpu_index_add(size, index, source, dim)
    before = segreduce.ordered_sum.launches
    got = segreduce.ordered_sum(size, index.cuda(), source.cuda(), dim)
    again = segreduce.index_sum(size, index.cuda(), source.cuda(), dim)
    assert segreduce.ordered_sum.launches == before + 2
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.equal(got.cpu().view(torch.int32),
                       want.view(torch.int32))
    assert torch.equal(again, got)


def test_ordered_sum_kernel_rejects_what_it_does_not_take():
    need_cuda()
    idx = torch.zeros(8, dtype=torch.int64, device="cuda")
    for src in (torch.zeros(8, dtype=torch.float64, device="cuda"),
                torch.zeros((8, 2, 2), device="cuda"),
                torch.zeros(7, device="cuda")):
        with pytest.raises(ValueError):
            segreduce.ordered_sum(4, idx, src)
    with pytest.raises(ValueError):
        segreduce.ordered_sum(4, idx.cpu(), torch.zeros(8, device="cuda"))


@pytest.mark.parametrize("capacity", [1024, 1_580_534])
@pytest.mark.parametrize("share", ["none", "sparse", "all"])
@pytest.mark.parametrize("nbands", [1, 3, 7])
def test_merge_apply_movers_on_card_matches_plain(capacity, share, nbands):
    """The movers-only float apply on the card (selection kernel, a sort
    of one key a candidate, K4) against merge_apply_reference on the CPU,
    bit for bit: merge map, sizes, float32 sums, mover count; size and
    sums updated in place; one selection launch and at most one K4
    launch, its keys one a candidate, never the capacity."""
    need_cuda()
    size, sums, best_nbr, d_best = merge_apply_case(
        np.random.default_rng(capacity + nbands), capacity, nbands, share)
    sums = (sums.to(torch.float32) * 1e-6 + 0.1).contiguous()
    want = elim_small.merge_apply_reference(size, sums, best_nbr, d_best,
                                            5, 100.0)
    candidates = int((size == 5).sum())
    args = [t.cuda() for t in (size, sums, best_nbr, d_best)]
    before = (elim_small.merge_apply_movers.launches,
              segreduce.ordered_sum.launches,
              elim_small.merge_apply.launches)
    got = elim_small.merge_apply_movers(*args, 5, 100.0, candidates)
    assert got[1] is args[0] and got[2] is args[1]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g.cpu(), w)
    assert (elim_small.merge_apply_movers.launches - before[0],
            segreduce.ordered_sum.launches - before[1],
            elim_small.merge_apply.launches - before[2]) == (1, 1, 0)
    assert candidates < capacity


@pytest.mark.parametrize("n,size,ncols,dim", [
    (4096 * 4096, 2 ** 21, 3, 0), (1_000_000, 60, None, 0),
    (4097, 4096, 5, 1)])
def test_ordered_sum_kernel_leaves_out_bin_0(n, size, ncols, dim):
    """With skip_bin0 (a tile's sums, its null segment left out) K4 gives
    the CPU's bits: bin 0 +0.0, every other bin the serial sum; 39 % of
    the elements are in bin 0, a Landsat scene's share of fill."""
    need_cuda()
    gen = torch.Generator().manual_seed(n + size + 1)
    index = torch.randint(0, size, (n,), generator=gen)
    index[torch.rand(n, generator=gen) < 0.39] = 0
    shape = (n,) if ncols is None else ((n, ncols) if dim == 0 else
                                        (ncols, n))
    source = 0.3 + 1e-3 * torch.randn(shape, generator=gen)
    want = segreduce.ordered_sum(size, index, source, dim, skip_bin0=True)
    got = segreduce.ordered_sum(size, index.cuda(), source.cuda(), dim,
                                skip_bin0=True)
    assert torch.all(want.select(dim, 0) == 0)
    assert torch.equal(got.cpu().view(torch.int32),
                       want.view(torch.int32))


@pytest.mark.parametrize("fill", [0.0, 0.39])
def test_float_tile_on_card_matches_cpu(monkeypatch, fill):
    """doShepherdSegmentation of a float32 reflectance tile on the card
    equals the CPU run bit for bit: labels, singles, segments eliminated
    and passes; every pass goes through the movers-only apply, none
    through K3, and no K4 launch of a pass takes more keys than the
    pass's candidates. With fill (the left 39 % nodata) as without."""
    need_cuda()
    img, _ = voronoi_image(np.random.default_rng(8), shape=(1024, 1024),
                           ncentres=2000, noise=40)
    img = ((img.astype(np.float32) - 1000) / np.float32(10000))
    img[:, :, :int(1024 * fill)] = -9999.0
    km = shepseg.fitSpectralClusters(img, 30, 100, -9999.0, True,
                                     device="cpu")
    kw = dict(kmeansObj=km, minSegmentSize=60, maxSpectralDiff="auto",
              imgNullVal=-9999.0)
    want = shepseg.doShepherdSegmentation(img, device="cpu", **kw)
    keys = []
    launch = segreduce.ordered_sum_keys

    def recording(k, *a, **kws):
        keys.append(int(k.shape[0]))
        return launch(k, *a, **kws)
    monkeypatch.setattr(segreduce, "ordered_sum_keys", recording)
    before = (elim_small.merge_apply_movers.launches,
              elim_small.merge_apply.launches)
    got = shepseg.doShepherdSegmentation(img, device="cuda", **kw)
    assert want.smallSegmentsEliminated > 0
    np.testing.assert_array_equal(got.segimg, want.segimg)
    assert got.singlePixelsEliminated == want.singlePixelsEliminated
    assert got.smallSegmentsEliminated == want.smallSegmentsEliminated
    assert got.elimPasses == want.elimPasses
    assert (elim_small.merge_apply_movers.launches - before[0],
            elim_small.merge_apply.launches - before[1]) == (
                got.elimPasses, 0)
    # the tile's sums take one key a pixel; each pass one a candidate
    assert keys[0] == 1024 * 1024 and len(keys) == got.elimPasses + 1
    assert max(keys[1:]) < 1024 * 1024 // 20


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


@pytest.mark.parametrize("block", [32, 128, (256, 256), (128, 256), (40, 72)])
@pytest.mark.parametrize("pattern", ["uniform", "stripes", "checker",
                                     "columns", "spiral"])
def test_local_ccl_kernel_under_contention(block, pattern):
    """Shapes that stress the union-find: one component per block (every
    thread hooks into the same tree), long thin components across rows and
    across warp segments, a spiral, and diagonal-only connections
    (8-connected checkerboard)."""
    need_cuda()
    by, bx = (block, block) if isinstance(block, int) else block
    h, w = -(-256 // by) * by, -(-384 // bx) * bx
    yy, xx = np.mgrid[0:h, 0:w]
    img = {"uniform": np.ones_like(yy),
           "stripes": 1 + (yy // 2) % 2,
           "checker": 1 + (yy + xx) % 2,
           "columns": 1 + (xx // 3) % 2,
           "spiral": _spiral(h, w)}[pattern].astype(np.int32)
    img_t = torch.from_numpy(img).cuda()
    for four_connected in (True, False):
        got = local_ccl.local_ccl_blocks(img_t, 0, four_connected,
                                         block=block)
        want = local_ccl.local_ccl_blocks_reference(img_t, 0, four_connected,
                                                    block=block)
        assert torch.equal(got, want)


def _spiral(h, w):
    """A one-pixel-wide spiral of 1s on 2s."""
    img = np.full((h, w), 2)
    y0, x0, y1, x1 = 0, 0, h - 1, w - 1
    while y0 <= y1 and x0 <= x1:
        img[y0, x0:x1 + 1] = 1
        img[y0:y1 + 1, x1] = 1
        if y1 - y0 >= 2:
            img[y1, x0:x1 + 1] = 1
        if x1 - x0 >= 2:
            img[y0 + 2:y1 + 1, x0] = 1
        y0, x0, y1, x1 = y0 + 2, x0 + 2, y1 - 2, x1 - 2
    return img


@pytest.mark.parametrize("block", [(256, 256), (128, 256), (64, 64),
                                   (40, 72), (8, 8), (104, 64)])
@pytest.mark.parametrize("four_connected", [True, False])
def test_local_ccl_kernel_block_shapes(block, four_connected):
    """Every block shape K1 takes: BLOCK, 256 x 256, non-square and
    non-power-of-two blocks (a small image's one block), ragged images
    padded to whole blocks; one launch each."""
    need_cuda()
    by, bx = block
    shape = (3 * by - 5, 2 * bx + 3)
    padded = np.zeros((-(-shape[0] // by) * by, -(-shape[1] // bx) * bx),
                      np.int32)
    padded[:shape[0], :shape[1]] = random_clusters(
        np.random.default_rng(6), shape)
    img = torch.from_numpy(padded).cuda()
    before = local_ccl.local_ccl_blocks.launches
    got = local_ccl.local_ccl_blocks(img, 0, four_connected, block=block)
    want = local_ccl.local_ccl_blocks_reference(img, 0, four_connected,
                                                block=block)
    assert torch.equal(got, want)
    assert local_ccl.local_ccl_blocks.launches == before + 1


def test_local_ccl_occupancy():
    need_cuda()
    threads, smem, per_sm = local_ccl.occupancy((128, 128))
    assert (threads, smem) == (512, local_ccl.shared_bytes(128, 128))
    assert per_sm >= 1
    threads, smem, per_sm = local_ccl.occupancy((256, 256), False)
    assert smem == 3 * 256 * 256 and per_sm >= 1


@pytest.mark.parametrize("two_level", [None, False])
@pytest.mark.parametrize("four_connected", [True, False])
def test_clump_labels_on_card_matches_cpu(two_level, four_connected):
    """The two-level merge and the sweeps on the card, each equal to the
    CPU run, with K1 launched once a call."""
    need_cuda()
    clusters = torch.from_numpy(random_clusters(
        np.random.default_rng(12), (300, 421), nclusters=2).astype(np.int32))
    before = local_ccl.local_ccl_blocks.launches
    stats = {}
    got = clump.clump_labels(clusters.cuda(), 0, four_connected,
                             two_level=two_level, stats=stats)
    assert local_ccl.local_ccl_blocks.launches == before + 1
    want = clump.clump_labels(clusters, 0, four_connected,
                              two_level=two_level)
    assert torch.equal(got[0].cpu(), want[0])
    assert got[1] == want[1]
    assert stats["two_level"] == (two_level is None)
    assert not stats["fallback"]


def test_clump_labels_on_card_falls_back():
    """A seed that is not block-converged: the verify fails on the card
    too, and the sweeps give the CPU's answer."""
    need_cuda()
    clusters = torch.from_numpy(random_clusters(
        np.random.default_rng(13), (260, 300), nclusters=2).astype(np.int32))

    def own_index(img, ignore_val, four_connected, block=None):
        flat = torch.arange(img.numel(), dtype=torch.int32,
                            device=img.device).reshape(img.shape)
        return torch.where(img != ignore_val, flat, local_ccl.INT32_MAX)

    stats = {}
    got = clump.clump_labels(clusters.cuda(), 0, True, local_ccl=own_index,
                             stats=stats)
    want = clump.clump_labels(clusters, 0, True, two_level=False)
    assert stats["fallback"] and stats["sweeps"] > 0
    assert torch.equal(got[0].cpu(), want[0])


def _tiled(tmp_path, name, km, device, **kw):
    """A tiled run of the raster ``in.npseg`` in 4 x 3 tiles; returns
    (result, (segment band, RAT histogram))."""
    out = str(tmp_path / (name + ".npseg"))
    res = tiling.doTiledShepherdSegmentation(
        str(tmp_path / "in.npseg"), out, tileSize=128, overlapSize=32,
        minSegmentSize=20, numClusters=12, kmeansObj=km, device=device,
        **kw)
    return res, read_output(out)


def _tiled_case(tmp_path):
    """Write a 300x340 3-band raster; returns k-means fitted on the CPU."""
    img, _ = voronoi_image(np.random.default_rng(4), shape=(300, 340),
                           ncentres=30)
    write_raster(str(tmp_path / "in.npseg"), img)
    return shepseg.fitSpectralClusters(img, 12, 100, None, True,
                                       device="cpu")


def test_tiled_on_card_matches_cpu(tmp_path):
    need_cuda()
    km = _tiled_case(tmp_path)
    before = (local_ccl.local_ccl_blocks.launches, lut.lut_gather.launches)
    got, (seg_g, hist_g) = _tiled(tmp_path, "card", km, "cuda")
    assert local_ccl.local_ccl_blocks.launches >= before[0] + 12
    assert lut.lut_gather.launches > before[1]
    want, (seg_w, hist_w) = _tiled(tmp_path, "cpu", km, "cpu")
    np.testing.assert_array_equal(seg_g, seg_w)
    np.testing.assert_array_equal(hist_g, hist_w)
    assert got.maxSegId == want.maxSegId
    assert got.hasEmptySegments == want.hasEmptySegments


def test_tiled_threads_on_card_match_serial(tmp_path):
    need_cuda()
    km = _tiled_case(tmp_path)
    want, (seg_w, hist_w) = _tiled(tmp_path, "none", km, "cuda")
    cfg = tiling.SegmentationConcurrencyConfig(
        concurrencyType=tiling.CONC_THREADS, numWorkers=2,
        workerDevices='all', tileCompletionTimeout=300)
    got, (seg_g, hist_g) = _tiled(tmp_path, "threads", km, "cuda",
                                  concurrencyCfg=cfg)
    np.testing.assert_array_equal(seg_g, seg_w)
    np.testing.assert_array_equal(hist_g, hist_w)
    assert got.maxSegId == want.maxSegId


def test_tiled_threads_with_tf32_on_match_serial(tmp_path):
    """With the user's TF32 on, the worker threads' k-means products stay
    full float32 (one thread leaving must not turn TF32 back on under
    another), and the user's setting is back afterwards."""
    need_cuda()
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        km = _tiled_case(tmp_path)
        want, (seg_w, hist_w) = _tiled(tmp_path, "none", km, "cuda")
        torch.backends.cuda.matmul.allow_tf32 = True
        cfg = tiling.SegmentationConcurrencyConfig(
            concurrencyType=tiling.CONC_THREADS, numWorkers=4,
            tileCompletionTimeout=300)
        got, (seg_g, hist_g) = _tiled(tmp_path, "threads", km, "cuda",
                                      concurrencyCfg=cfg)
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    np.testing.assert_array_equal(seg_g, seg_w)
    np.testing.assert_array_equal(hist_g, hist_w)
    assert got.maxSegId == want.maxSegId


# ------------------------------------------------ the stats engine


_STATS_DTYPES = {np.uint8: (0, 256), np.uint16: (0, 65536),
                 np.int8: (-128, 128), np.int16: (-32768, 32768),
                 np.int32: (-2 ** 31, 2 ** 31 - 1)}


@pytest.mark.parametrize("segBase", [0, 70000])
@pytest.mark.parametrize("dtype", sorted(_STATS_DTYPES, key=str))
def test_compaction_on_card_matches_cpu(dtype, segBase):
    """Every supported imagery dtype, segment ids below and above 0xFFFF,
    one band and three: the card's runs equal the CPU's."""
    need_cuda()
    from pyshepseg_tpu_torch.ops import segstats
    rng = np.random.default_rng(6)
    seg = (rng.integers(1, 200, size=(300, 310)) + segBase).astype(np.uint32)
    seg[rng.random(seg.shape) < 0.1] = 0
    lo, hi = _STATS_DTYPES[dtype]
    bands = [rng.integers(lo, hi, size=seg.shape).astype(dtype)
             for _ in range(3)]
    bands[0][:, :40] = bands[0][0, 0]
    nulls = [int(bands[0][0, 0]), None, int(bands[2][5, 5])]
    numSeg = int(seg.max()) + 1
    before = segstats.windowRuns.cuda_calls
    got = segstats.compactTileDeviceMultiBand(seg, bands, nulls, numSeg,
                                              device="cuda")
    assert segstats.windowRuns.cuda_calls == before + 1
    want = segstats.compactTileDeviceMultiBand(seg, bands, nulls, numSeg,
                                               device="cpu")
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            if b is None:
                assert a is None
            else:
                np.testing.assert_array_equal(a, b)


def _stats_rasters(tmp_path):
    """A 300x340 segmentation (Voronoi cells, a null strip, Histogram
    column) and a 3-band uint16 image with a nodata value on band 1."""
    from pyshepseg_tpu_torch import io as rio
    rng = np.random.default_rng(8)
    _, cells = voronoi_image(rng, shape=(300, 340), ncentres=60)
    seg = (cells + 1).astype(np.uint32)
    seg[:5] = 0
    segpath = str(tmp_path / "seg.npseg")
    ds = rio.create(segpath, 340, 300, 1, np.uint32)
    ds.GetRasterBand(1).WriteArray(seg)
    hist = np.bincount(seg.ravel()).astype(np.float64)
    hist[0] = 0
    rat = ds.GetRasterBand(1).GetDefaultRAT()
    rat.CreateColumn("Histogram", rio.GFT_Real, rio.GFU_PixelCount)
    rat.WriteArray(hist, 0)
    img = rng.integers(0, 3000, size=(3, 300, 340)).astype(np.uint16)
    img[0, rng.random((300, 340)) < 0.05] = 7
    imgpath = str(tmp_path / "img.npseg")
    write_raster(imgpath, img)
    rio.open(imgpath, rio.GA_Update).GetRasterBand(1).SetNoDataValue(7)
    return segpath, imgpath


def _rat_cols(path, names):
    from pyshepseg_tpu_torch import io as rio
    rat = rio.open(path).GetRasterBand(1).GetDefaultRAT()
    have = [rat.GetNameOfCol(i) for i in range(rat.GetColumnCount())]
    return [rat.ReadAsArray(have.index(n)) for n in names]


def test_stats_feeds_on_card_match_host(tmp_path, monkeypatch):
    """The scene-resident feed and the per-tile feed (two read workers)
    on the card write the host engine's columns."""
    need_cuda()
    from pyshepseg_tpu_torch import tilingstats
    monkeypatch.setattr(tiling, "TILESIZE", 128)
    segpath, imgpath = _stats_rasters(tmp_path)
    stats = [("mn", "min"), ("mean", "mean"), ("sd", "stddev"),
             ("med", "median"), ("mode", "mode"), ("p0", "percentile", 0),
             ("n", "pixcount")]
    names = []
    for run, engine, fraction, workers in [
            ("scene", "device", 0.25, 0), ("tiles", "device", 0, 2),
            ("host", "host", 0.25, 0)]:
        monkeypatch.setattr(tiling, "SCENE_CACHE_HBM_FRACTION", fraction)
        sel = [[(run + str(b) + s[0],) + s[1:] for s in stats]
               for b in (1, 2, 3)]
        res = tilingstats.calcPerSegmentStatsTiledMultiBand(
            imgpath, [1, 2, 3], segpath, sel, numReadWorkers=workers,
            engine=engine, device="cuda")
        assert ("compaction" in res.timings.makeSummaryDict()) == (
            run == "scene")
        names.append([s[0] for band in sel for s in band])
    scene, tiles, host = (_rat_cols(segpath, n) for n in names)
    for a, b, c in zip(scene, tiles, host):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, c)


@pytest.mark.parametrize("four", [True, False])
def test_spatial_box_functions_on_card_match_cpu(four):
    need_cuda()
    from pyshepseg_tpu_torch.ops import spatialstats as sps
    rng = np.random.default_rng(9)
    masks = torch.from_numpy(rng.random((6, 64, 128)) < 0.7)
    vals = torch.from_numpy(rng.integers(0, 3000, size=(6, 64, 128)).astype(
        np.float32))
    assert torch.equal(sps.edge_pixel_counts(masks.cuda(), four).cpu(),
                       sps.edge_pixel_counts(masks, four))
    cnt_g, sum_g = sps.variogram_sums(vals.cuda(), masks.cuda(), 4)
    cnt_c, sum_c = sps.variogram_sums(vals, masks, 4)
    assert torch.equal(cnt_g.cpu(), cnt_c)
    # float32 sums in another order: PARITY.md deviation 6 (~1e-5)
    np.testing.assert_allclose(sum_g.cpu().numpy(), sum_c.numpy(),
                               rtol=1e-5)


def test_spatial_device_engine_on_card_matches_cpu(tmp_path):
    """Edge pixels and variograms through the device engine's box
    functions on the card equal the CPU run."""
    need_cuda()
    from pyshepseg_tpu_torch import io as rio, tilingstats
    segpath, imgpath = _stats_rasters(tmp_path)
    for device in ("cuda", "cpu"):
        tilingstats.calcPerSegmentSpatialStatsTiled(
            imgpath, 1, segpath, [("e_" + device, rio.GFT_Integer)],
            tilingstats.userFuncNumEdgePixels, True, engine="device",
            device=device)
        tilingstats.calcPerSegmentSpatialStatsTiled(
            imgpath, 1, segpath, [("v1_" + device, rio.GFT_Real),
                                  ("v2_" + device, rio.GFT_Real)],
            tilingstats.userFuncVariogram, 2, engine="device",
            device=device)
    e_g, e_c, v_g, v_c = _rat_cols(segpath, ["e_cuda", "e_cpu", "v2_cuda",
                                             "v2_cpu"])
    np.testing.assert_array_equal(e_g, e_c)
    np.testing.assert_allclose(v_g, v_c, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("fixed", [True, False])
def test_kmeans_fit_on_card_is_reproducible(fixed):
    """Two fits of the same points on the card, fixed init or k-means++
    from one seed, give centres equal bit for bit (the per-cluster float
    sums are serial, K4), and inertia and iterations equal too."""
    need_cuda()
    from pyshepseg_tpu_torch.ops import kmeans
    rng = np.random.default_rng(12)
    centres = rng.uniform(0, 4000, size=(60, 4))
    x = (centres[rng.integers(0, 60, size=300000)] +
         rng.normal(0, 40, size=(300000, 4))).astype(np.float32)
    init = shepseg.diagonalClusterCentres(x, 60) if fixed else "k-means++"
    fits = [kmeans.TorchKMeans(n_clusters=60, n_init=1 if fixed else 2,
                               init=init, random_state=3,
                               device="cuda").fit(x) for _ in range(2)]
    assert np.array_equal(fits[0].cluster_centers_,
                          fits[1].cluster_centers_)
    assert fits[0].inertia_ == fits[1].inertia_
    assert fits[0].n_iter_ == fits[1].n_iter_ > 1


def test_float_image_segments_the_same_twice_on_card():
    """A float32 image, its k-means fitted inside each call: two calls on
    the card give the same segimg (serial k-means, spectral and
    graph-pass sums, K4)."""
    need_cuda()
    img, _ = voronoi_image(np.random.default_rng(6), shape=(768, 640),
                           ncentres=300, noise=60)
    img = img.astype(np.float32) + np.float32(0.37)
    kw = dict(numClusters=30, clusterSubsamplePcnt=50, minSegmentSize=30,
              fixedKMeansInit=True, device="cuda")
    a = shepseg.doShepherdSegmentation(img, **kw)
    b = shepseg.doShepherdSegmentation(img, **kw)
    assert a.smallSegmentsEliminated > 0
    np.testing.assert_array_equal(a.kmeans.cluster_centers_,
                                  b.kmeans.cluster_centers_)
    np.testing.assert_array_equal(a.segimg, b.segimg)


def test_timing_helpers_on_card():
    need_cuda()
    img, _ = voronoi_image(np.random.default_rng(2), shape=(256, 256))
    km = shepseg.fitSpectralClusters(img, 12, 100, None, True,
                                     device="cuda")
    mpix = shepseg.deviceResidentThroughput(img, km, 'auto', repeats=2)
    secs, rtt = shepseg.deviceOnlySeconds(img, km, 'auto', k=2, repeats=2)
    for v in (mpix, secs, rtt):
        assert np.isfinite(v) and v > 0


def test_spatial_auto_streams_on_card(tmp_path):
    """'auto' on the card takes the halo streaming route for the two
    built-ins and writes the box route's columns (edges exact, variograms
    rtol 1e-5)."""
    need_cuda()
    from pyshepseg_tpu_torch import io as rio, tilingstats
    segpath, imgpath = _stats_rasters(tmp_path)
    band = rio.open(imgpath).GetRasterBand(1)
    for fn, param in [(tilingstats.userFuncNumEdgePixels, True),
                      (tilingstats.userFuncVariogram, 2)]:
        useDevice, streamFn = tilingstats._spatialRoute(
            "auto", fn, param, "cuda", band)
        assert useDevice and streamFn is not None
    for engine in ("auto", "device"):
        tilingstats.calcPerSegmentSpatialStatsTiled(
            imgpath, 1, segpath, [("e_" + engine, rio.GFT_Integer)],
            tilingstats.userFuncNumEdgePixels, True, engine=engine)
        tilingstats.calcPerSegmentSpatialStatsTiled(
            imgpath, 1, segpath, [("v1_" + engine, rio.GFT_Real),
                                  ("v2_" + engine, rio.GFT_Real)],
            tilingstats.userFuncVariogram, 2, engine=engine)
    e_a, e_d, v_a, v_d = _rat_cols(segpath, ["e_auto", "e_device", "v2_auto",
                                             "v2_device"])
    np.testing.assert_array_equal(e_a, e_d)
    np.testing.assert_array_equal(v_a == -9999, v_d == -9999)
    np.testing.assert_allclose(v_a, v_d, rtol=1e-5, atol=1e-3)


# ------------------------------------------------ the multi-device slice


def _palette_image(h, w, seed, nullval=None):
    """The palette image of tests/test_shardmap_seg.py (no JAX here):
    Voronoi cells in palette colours with 5 % salt; the centres are the
    palette."""
    rng = np.random.default_rng(seed)
    ncells = 25
    centres = rng.uniform(0, [h, w], size=(ncells, 2))
    yy, xx = np.mgrid[0:h, 0:w]
    cells = ((yy[..., None] - centres[:, 0]) ** 2 +
             (xx[..., None] - centres[:, 1]) ** 2).argmin(axis=-1)
    cells = np.where(rng.random((h, w)) < 0.05,
                     rng.integers(0, ncells, (h, w)), cells)
    palette = rng.integers(10, 900, size=(ncells, 3))
    img = palette[cells].transpose(2, 0, 1).astype(np.uint16)
    if nullval is not None:
        img[:, :4, :] = nullval
        img[:, :, -4:] = nullval
    return img, palette.astype(np.float32)


@pytest.mark.parametrize("four,nullval", [(True, None), (False, 9999)])
def test_segment_tile_on_card_matches_cpu(four, nullval):
    """pipeline.segment_tile on tensors on the card: tensors come back on
    the card, K1 and K2 launch, and the labels equal the CPU's."""
    need_cuda()
    from pyshepseg_tpu_torch.parallel import pipeline
    img, centers = _palette_image(300, 260, 8, nullval)
    args = (nullval or 0, 200.0, 10, four, nullval is not None)
    before = (local_ccl.local_ccl_blocks.launches, lut.lut_gather.launches)
    seg, maxid = pipeline.segment_tile(
        torch.from_numpy(img).cuda(), torch.from_numpy(centers).cuda(),
        *args)
    assert seg.is_cuda and maxid.is_cuda and seg.dtype == torch.int32
    assert local_ccl.local_ccl_blocks.launches == before[0] + 1
    assert lut.lut_gather.launches > before[1]
    want, want_max = pipeline.segment_tile(
        torch.from_numpy(img), torch.from_numpy(centers), *args)
    assert torch.equal(seg.cpu(), want)
    assert int(maxid) == int(want_max) == int(seg.max())


@pytest.mark.parametrize("tpd", [1, 2])
def test_tiled_mesh_on_card_matches_serial(tmp_path, tpd):
    """CONC_MESH over the visible cards (one here: a plain loop) with the
    scene cache, against CONC_NONE; K1 once a tile."""
    need_cuda()
    km = _tiled_case(tmp_path)
    want, (seg_w, hist_w) = _tiled(tmp_path, "none", km, "cuda")
    cfg = tiling.SegmentationConcurrencyConfig(
        concurrencyType=tiling.CONC_MESH, tilesPerDevice=tpd)
    before = local_ccl.local_ccl_blocks.launches
    got, (seg_g, hist_g) = _tiled(tmp_path, "mesh", km, "cuda",
                                  concurrencyCfg=cfg)
    assert local_ccl.local_ccl_blocks.launches == before + 12
    np.testing.assert_array_equal(seg_g, seg_w)
    np.testing.assert_array_equal(hist_g, hist_w)
    assert got.maxSegId == want.maxSegId
    assert got.maxSpectralDiff == want.maxSpectralDiff


def _sharded_case(mesh):
    from pyshepseg_tpu_torch.parallel import pipeline, shardmap_seg
    img, centers = _palette_image(298, 260, 9, 9999)
    seg, maxid = pipeline.segment_tile(
        torch.from_numpy(img).cuda(), torch.from_numpy(centers).cuda(),
        9999, 250.0, 10, False, True)
    before = lut.lut_gather.launches
    got, got_max = shardmap_seg.segment_image_sharded(
        img, centers, imgNullVal=9999, maxSpectralDiff=250.0,
        minSegmentSize=10, fourConnected=False, mesh=mesh)
    assert lut.lut_gather.launches > before
    np.testing.assert_array_equal(got, seg.cpu().numpy())
    assert got_max == int(maxid)


def test_sharded_over_one_card_four_times_matches_segment_tile():
    """Four stripes (298 rows: two null padding rows) that all lie on
    cuda:0: every halo exchange and fixpoint runs, on one card."""
    need_cuda()
    _sharded_case(["cuda:0"] * 4)


def test_sharded_over_distinct_cards_matches_segment_tile():
    need_cuda()
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs more than one CUDA device")
    _sharded_case(["cuda:%d" % i for i in range(n)])


def test_clump_sharded_on_card_matches_clump():
    need_cuda()
    from pyshepseg_tpu_torch.parallel import shardmap_clump
    img = random_clusters(np.random.default_rng(12), (301, 257)).astype(
        np.int32)
    for four in (True, False):
        want, nxt = clump.clump(img, 0, four, device="cuda")
        got, num = shardmap_clump.clump_sharded(img, 0, four,
                                                mesh=["cuda:0"] * 3)
        np.testing.assert_array_equal(got, want)
        assert num == nxt - 1


def test_mesh_over_distinct_cards_matches_serial(tmp_path):
    """CONC_MESH with one thread and one stream per card."""
    need_cuda()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs more than one CUDA device")
    km = _tiled_case(tmp_path)
    want, (seg_w, hist_w) = _tiled(tmp_path, "none", km, "cuda")
    cfg = tiling.SegmentationConcurrencyConfig(
        concurrencyType=tiling.CONC_MESH, tilesPerDevice=2)
    got, (seg_g, hist_g) = _tiled(tmp_path, "mesh", km, "cuda",
                                  concurrencyCfg=cfg)
    np.testing.assert_array_equal(seg_g, seg_w)
    np.testing.assert_array_equal(hist_g, hist_w)
    assert got.maxSegId == want.maxSegId


# ---- the batch deployment (parallel_examples/gpubatch) on the card


def _batch_script(name):
    import os
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(repo, "parallel_examples", "gpubatch", name)


def _batch_job(script, args):
    """One gpubatch script in a fresh process, started and not waited
    for."""
    import os
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [repo, os.environ.get("PYTHONPATH", "")]))
    return subprocess.Popen(
        [sys.executable, _batch_script(script)] + args, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _finish(procs, timeout=600):
    """Wait for every job (none is left running); all must exit 0.
    Returns their TILEJOB records."""
    import json
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    recs = []
    for p, (stdout, stderr) in zip(procs, outs):
        assert p.returncode == 0, stdout + stderr
        recs += [json.loads(ln.split(" ", 1)[1])
                 for ln in stdout.splitlines() if ln.startswith("TILEJOB ")]
    return recs


def _prepared_store(tmp_path):
    """A scene and a store holding the prepare.pkl of a fit on the CPU."""
    img, _ = voronoi_image(np.random.default_rng(3), shape=(200, 220),
                           ncentres=30, noise=6)
    inpath = str(tmp_path / "in.npseg")
    write_raster(inpath, img)
    store = str(tmp_path / "prepared")
    _finish([_batch_job("do_prepare.py", [
        "--infile", inpath, "--store", "file://" + store, "--tilesize",
        "128", "--overlapsize", "32", "--nclusters", "12",
        "--fixedkmeansinit", "--device", "cpu"])])
    return store


def test_batch_on_card_equals_cpu_under_shared_state(tmp_path):
    """One prepare.pkl (fitted on the CPU), its four tile jobs and the
    stitch with stats run with --device cuda and with --device cpu: the
    segment band and every RAT column are equal bit for bit, and every
    card job ran K1 once and K2."""
    need_cuda()
    import os
    import shutil
    from pyshepseg_tpu_torch import io as rio
    prepared = _prepared_store(tmp_path)
    outputs = {}
    for device in ("cuda", "cpu"):
        store = str(tmp_path / device)
        shutil.copytree(prepared, store)
        recs = _finish([_batch_job("do_tile.py", [
            "--store", "file://" + store, "--index", str(i), "--minsegmentsize",
            "20", "--device", device]) for i in range(4)])
        assert sorted(rec["index"] for rec in recs) == [0, 1, 2, 3]
        for rec in recs:
            assert rec["device"].startswith(device)
            if device == "cuda":
                assert rec["launches"]["local_ccl"] == 1
                assert rec["launches"]["lut_gather"] >= 1
                assert rec["seconds"]["cudainit"] > 0
            else:
                assert rec["launches"] == {"local_ccl": 0, "lut_gather": 0}
        _finish([_batch_job("do_stitch.py", [
            "--store", "file://" + store, "--statsbands", "1,2", "--device",
            device])])
        out = os.path.join(store, "segmentation.npseg")
        rat = rio.open(out).GetRasterBand(1).GetDefaultRAT()
        outputs[device] = (read_output(out)[0], {
            rat.GetNameOfCol(i): np.asarray(rat.ReadAsArray(i))
            for i in range(rat.GetColumnCount())})
    seg, cols = outputs["cuda"]
    seg0, cols0 = outputs["cpu"]
    assert seg.max() > 1
    np.testing.assert_array_equal(seg, seg0)
    assert set(cols) == set(cols0) >= {"Histogram", "Band_2_stddev"}
    for name in cols:
        np.testing.assert_array_equal(cols[name], cols0[name])


def test_concurrent_cold_tile_jobs_build_the_library(tmp_path, monkeypatch):
    """Two tile jobs started together with no built kernel library: both
    exit 0 with equal results to a later warm job's, at least one compiled,
    and the library they leave loads and launches."""
    need_cuda()
    import os
    from pyshepseg_tpu_torch import _kernels, io as rio
    store = _prepared_store(tmp_path)
    _kernels.lib()
    os.remove(_kernels.LIB_PATH)
    cold = _finish([_batch_job("do_tile.py", [
        "--store", "file://" + store, "--index", str(i), "--device", "cuda"])
        for i in (0, 1)])
    assert sorted(rec["index"] for rec in cold) == [0, 1]
    assert max(rec["seconds"]["build"] for rec in cold) > 0
    assert os.path.exists(_kernels.LIB_PATH)
    leftovers = [f for f in os.listdir(_kernels.BUILD_DIR) if ".tmp" in f]
    assert leftovers == []

    def tile(rec):
        return rio.open(os.path.join(store, "tile_%d_%d.npseg" % (
            rec["col"], rec["row"]))).GetRasterBand(1).ReadAsArray()

    coldTiles = {rec["index"]: tile(rec) for rec in cold}
    warm = _finish([_batch_job("do_tile.py", [
        "--store", "file://" + store, "--index", str(i), "--device", "cuda"])
        for i in (0, 1)])
    for rec in warm:
        assert rec["seconds"]["build"] == 0
        np.testing.assert_array_equal(tile(rec), coldTiles[rec["index"]])
    # this process loads the library the jobs left, and launches from it
    monkeypatch.setattr(_kernels, "_lib", None)
    img = torch.from_numpy(padded_clusters(
        np.random.default_rng(5), (250, 380), 128)).cuda()
    assert torch.equal(local_ccl.local_ccl_blocks(img, 0, True),
                       local_ccl.local_ccl_blocks_reference(img, 0, True))
