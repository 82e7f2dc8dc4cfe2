#!/usr/bin/env python3
"""
Smoke run of pyshepseg_tpu_torch on one NVIDIA GPU: builds the CUDA
kernels from pyshepseg_tpu_torch/csrc/, holds each against its plain
PyTorch version on the card (K1 at every block shape it takes, timed by
block shape beside its bound; K2 on both of its routes, beside
torch.index_select, with a sweep of their times by reuse; K3 at a
cropland tile's graph pass, beside the index_add_ pair it replaced; K4 at
a float 4096^2 tile's sums, the k-means sums and a float graph pass,
against the CPU's index_add_ bit for bit, beside the atomic index_add_),
drives doShepherdSegmentation end to end at bench config1 (1024x1024) and
at the default tile size (4096x4096), each with an A/B of the clump
stage's two-level merge against the global sweeps (labels equal), drives
float32 reflectance through the main path on the card against the CPU,
bit for bit (a 4096x4096 tile without and with 39 % fill, a 1536x1536
scene with fill through the tiled driver; K4 and the float apply
launched, K3 never), then drives
the tiled driver doTiledShepherdSegmentation over an 8000x8000 scene in 9
tiles of 4096^2 (its k-means fitted twice, equal bit for bit; serial, two
worker threads and the 3-phase API, equal bit for bit), serially over a
denser 8000x8000 scene (K2 on every tile), and over a 1536x1536 scene on
the card and on the CPU (equal bit for bit); then doShepherdSegmentation
on a noisy 2048x2048 image whose table is above K2's staged route, on the
card and on the CPU (equal bit for bit). Over the 8000x8000 serial output
it runs the per-segment statistics engine (every statistic on the 4
bands: the device engine from the scene-resident feed and from per-tile
reads, and the host engine, equal bit for bit; the spatial built-ins,
device route against host route, and the default 'auto', which streams)
and the tiling command line end to end (segmentation, stats, colour
table). Then the golden end-to-end check cmdline.runtests at its
defaults on the card, and the timing helpers deviceResidentThroughput and
deviceOnlySeconds at config1. Phase 12 drives the multi-device backends
on the one card, each where its inputs are at hand: 12a
pipeline.segment_tile on the 4096x4096 tile (labels equal to
doShepherdSegmentation's, timed beside it), 12b CONC_MESH over the
8000x8000 scene with tilesPerDevice 1 and 2 (equal to the serial output),
12c the row-sharded clump and segmentation of the tile over a device list
that names cuda:0 four times, and once (equal to clump and to 12a), 12d
two processes of the dcnworkercmd command line over the 1536x1536 scene
through a TCPStore on localhost (equal to the serial run). Phase 13 drives
the batch deployment parallel_examples/gpubatch on the card: 13a the local
backend of submit_pyshepseg_job.py over the 1536x1536 scene and over the
8000x8000 scene at the default tile (prepare, one fresh process a tile,
two at a time, stitch, through a file:// object store; each equal to its
scene's serial run; K1 once and K2 at least once in every tile job), 13b one do_tile.py job with the
kernel library removed first (it builds it) and one with it in place, each
job's own seconds by stage printed.

    python3 chip_smoke.py

It imports numpy, torch and the port, nothing of JAX. Every phase raises
on failure, so the script exits non-zero and prints no result line; it
also fails where CUDA is absent or the package is missing. The last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}};
before it come the card's name and power limit as nvidia-smi reports them
and the per-kernel JSON record (times, bound, plain version and library
call), whose launch counts are those of the serial tiled run plus phase
12's and phase 13's paths (K4's, phase 6b's float runs), each counted
from 0.
"""

import contextlib
import functools
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# the package lives beside this script in a checkout
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from pyshepseg_tpu_torch import _kernels, shepseg, tiling  # noqa: E402
from pyshepseg_tpu_torch import io as rio, native, tilingstats  # noqa: E402
from pyshepseg_tpu_torch.cmdline import runtests as runtests_cli  # noqa: E402
from pyshepseg_tpu_torch.cmdline import tiling as tiling_cli  # noqa: E402
from pyshepseg_tpu_torch.ops import clump, kmeans, local_ccl, lut  # noqa: E402
from pyshepseg_tpu_torch.ops import elim_small  # noqa: E402
from pyshepseg_tpu_torch.ops import segreduce, segstats  # noqa: E402
from pyshepseg_tpu_torch.parallel import mesh, pipeline  # noqa: E402
from pyshepseg_tpu_torch.parallel import shardmap_clump  # noqa: E402
from pyshepseg_tpu_torch.parallel import shardmap_seg  # noqa: E402
from pyshepseg_tpu_torch.ops.sync import to_host  # noqa: E402
from pyshepseg_tpu_torch.timinghooks import Timers  # noqa: E402

CONFIG1 = dict(numClusters=60, clusterSubsamplePcnt=1, minSegmentSize=50,
               maxSpectralDiff='auto', fourConnected=True)
# config1's settings as doTiledShepherdSegmentation takes them
TILED = dict(numClusters=60, minSegmentSize=50, maxSpectralDiff='auto',
             fourConnected=True)
INTERVALS = ("reading", "segmentation", "stitchwait", "stitchtiles",
             "stitchfinalize", "walltime")
# the H100's device-memory rate (bytes/s), for each kernel's bound
HBM_BYTES_PER_S = 3.35e12
SOURCES = {"local_ccl": ("pyshepseg_tpu_torch/csrc/local_ccl.cu",
                         "pyshepseg_tpu/ops/pallas_ccl.py:92"),
           "lut_gather": ("pyshepseg_tpu_torch/csrc/lut_gather.cu",
                          "pyshepseg_tpu/ops/lut.py:42"),
           "merge_apply": ("pyshepseg_tpu_torch/csrc/merge_apply.cu",
                           "none (added for the graph passes' index adds)"),
           "ordered_sum": ("pyshepseg_tpu_torch/csrc/ordered_sum.cu",
                           "none (added for the float sums' serial order)")}


def phase(name):
    print("== %s" % name, flush=True)


def make_image(h, w, nbands, ncells=400, seed=7, device="cuda", noise=8.0):
    """Synthetic Landsat-like tile: Voronoi patches + noise, uint16 — the
    same draws and float32 arithmetic as bench.py's make_image (at its
    noise of 8.0), with the nearest-centre search done on ``device``."""
    rng = np.random.default_rng(seed)
    centres = rng.uniform(0, [h, w], size=(ncells, 2)).astype(np.float32)
    yy = torch.arange(h, dtype=torch.float32, device=device)[:, None, None]
    xx = torch.arange(w, dtype=torch.float32, device=device)[None, :, None]
    cells = torch.zeros((h, w), dtype=torch.int64, device=device)
    best = torch.full((h, w), float("inf"), device=device)
    c_all = torch.from_numpy(centres).to(device)
    for start in range(0, ncells, 50):  # nearest centre, bounded memory
        c = c_all[start:start + 50]
        d = (yy - c[:, 0]) ** 2 + (xx - c[:, 1]) ** 2
        val, idx = torch.min(d, dim=-1)
        upd = val < best
        cells = torch.where(upd, idx + start, cells)
        best = torch.where(upd, val, best)
    cells = cells.cpu().numpy()
    palette = rng.integers(100, 4000, size=(ncells, nbands))
    img = palette[cells].transpose(2, 0, 1)
    img = img + rng.normal(0, noise, img.shape)
    return np.clip(img, 0, 65535).astype(np.uint16)


def make_scene(h, w, nbands, ncells, seed=7, device="cuda", band_rows=256,
               reach=400):
    """A whole scene like make_image's tiles (Voronoi patches + noise,
    uint16), computed one band of rows at a time so device memory stays
    bounded: each band searches only the centres within ``reach`` rows of
    it, and every pixel's nearest centre is checked to lie within
    ``reach``, so no centre outside the band's window can be nearer.
    Noise is drawn on the device from a generator seeded with ``seed``."""
    rng = np.random.default_rng(seed)
    centres = torch.from_numpy(rng.uniform(
        0, [h, w], size=(ncells, 2)).astype(np.float32)).to(device)
    palette = torch.from_numpy(rng.integers(
        100, 4000, size=(ncells, nbands)).astype(np.float32)).to(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    xx = torch.arange(w, dtype=torch.float32, device=device)[None, :, None]
    img = np.empty((nbands, h, w), np.uint16)
    for y0 in range(0, h, band_rows):
        y1 = min(h, y0 + band_rows)
        near = torch.nonzero((centres[:, 0] >= y0 - reach) &
                             (centres[:, 0] < y1 + reach)).squeeze(1)
        yy = torch.arange(y0, y1, dtype=torch.float32,
                          device=device)[:, None, None]
        cells = torch.zeros((y1 - y0, w), dtype=torch.int64, device=device)
        best = torch.full((y1 - y0, w), float("inf"), device=device)
        for start in range(0, near.shape[0], 64):
            c = centres[near[start:start + 64]]
            d = (yy - c[:, 0]) ** 2 + (xx - c[:, 1]) ** 2
            val, idx = torch.min(d, dim=-1)
            upd = val < best
            cells = torch.where(upd, near[start + idx], cells)
            best = torch.where(upd, val, best)
        if best.max().item() > reach ** 2:
            raise AssertionError("make_scene: a pixel of rows %d-%d has no "
                                 "centre within %d px" % (y0, y1, reach))
        band = palette[cells].permute(2, 0, 1)
        band = band + torch.randn(band.shape, generator=gen,
                                  device=device) * 8.0
        img[:, y0:y1] = band.clamp(0, 65535).to(torch.int32).cpu().numpy()
    return img


def write_scene(path, img, nodata=None):
    nbands, h, w = img.shape
    ds = rio.create(path, w, h, nbands, img.dtype)
    for b in range(nbands):
        ds.GetRasterBand(b + 1).WriteArray(img[b])
        if nodata is not None:
            ds.GetRasterBand(b + 1).SetNoDataValue(nodata)
    ds.FlushCache()


def read_seg(path):
    """(segment band, RAT histogram) of a tiled output raster."""
    band = rio.open(path).GetRasterBand(1)
    rat = band.GetDefaultRAT()
    hist = rat.ReadAsArray(rat.GetColOfUsage(rio.GFU_PixelCount))
    return band.ReadAsArray(), np.asarray(hist, dtype=np.int64)


def random_clusters(rng, shape, nclusters=4, null_frac=0.1):
    clusters = rng.integers(1, nclusters + 1, size=shape).astype(np.int32)
    clusters[rng.random(shape) < null_frac] = 0
    return clusters


def cuda_ms(fn, reps=20, warmup=3):
    """Mean milliseconds of ``fn`` on the card (CUDA events). The calls
    are queued behind a device-side sleep, so the events time the device
    and not the host's launch rate (a call that waits for the device, as
    the plain K1 does each round, still pays for its waits)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_equal(got, want, what):
    """Exact agreement (the tolerance of both kernels is zero)."""
    torch.cuda.synchronize()
    if got.shape != want.shape or not torch.equal(got, want):
        bad = (got != want).sum().item() if got.shape == want.shape else -1
        raise AssertionError("%s: kernel differs from plain version at %d "
                             "elements" % (what, bad))


def max_abs_err(got, want):
    return float((got.long() - want.long()).abs().max().item())


def reset_counts():
    local_ccl.local_ccl_blocks.launches = 0
    lut.lut_gather.launches = 0
    lut.lut_gather.direct_launches = 0
    lut.lut_gather.staged_launches = 0
    elim_small.merge_apply.launches = 0
    segreduce.ordered_sum.launches = 0
    elim_small.merge_apply_movers.launches = 0
    clump.clump_labels.fallbacks = 0
    to_host.syncs = 0


def read_counts():
    return {"local_ccl": local_ccl.local_ccl_blocks.launches,
            "lut_gather": lut.lut_gather.launches,
            "merge_apply": elim_small.merge_apply.launches,
            "ordered_sum": segreduce.ordered_sum.launches,
            "merge_apply_movers": elim_small.merge_apply_movers.launches}


# the kernels of integer imagery's path, and the float path's two launches
# that integer imagery never makes
INT_KERNELS = ("local_ccl", "lut_gather", "merge_apply")
FLOAT_ONLY = ("ordered_sum", "merge_apply_movers")


def need_integer_path(what, counts):
    """K1, K2 and K3 launched, and neither K4 nor the float apply."""
    need_launches(what, counts, INT_KERNELS)
    for name in FLOAT_ONLY:
        if counts[name]:
            raise AssertionError("%s: integer imagery launched %s %d times"
                                 % (what, name, counts[name]))


def read_routes():
    """K2's launches per route since the last reset_counts."""
    return {"direct": lut.lut_gather.direct_launches,
            "staged": lut.lut_gather.staged_launches}


def phase_device():
    phase("1 device")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print("torch", torch.__version__, "cuda", torch.version.cuda,
          "device", kind, "|", smi)
    return kind, smi


def phase_build():
    phase("2 build")
    secs = _kernels.build(force=True)
    _kernels.lib()
    print("built %s in %.2f s" % (_kernels.LIB_PATH, secs))
    print("host stitch loops (g++): %s" % (
        native.LIB_PATH if native.available() else
        "not built, numpy fallback"))


# block shapes K1 is timed at (phase 3); the first is the default
K1_BLOCKS = [(128, 128), (64, 64), (64, 128), (128, 256), (256, 256)]


def bound_ms(nbytes):
    """The least time the card could take to move ``nbytes`` (ms)."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def print_occupancy(block):
    for four in (True, False):
        threads, smem, per_sm = local_ccl.occupancy(block, four)
        print("K1 block %s four=%s: %d threads, %d bytes of shared memory "
              "a block, %d blocks resident per SM"
              % (block, four, threads, smem, per_sm))


def time_k1(img_t, block, four, what):
    """K1 against its plain version at one shape: kernel ms, bound and
    share of the bound, plain ms."""
    k_ms = cuda_ms(lambda: local_ccl.local_ccl_blocks(img_t, 0, four,
                                                      block=block))
    p_ms = cuda_ms(lambda: local_ccl.local_ccl_blocks_reference(
        img_t, 0, four, block=block), reps=3, warmup=1)
    b_ms = bound_ms(8 * img_t.numel())
    print("K1 %s block %s four=%s: kernel %.4f ms, bound %.4f ms (%.1f%% "
          "of bound), plain %.2f ms"
          % (what, block, four, k_ms, b_ms, 100 * b_ms / k_ms, p_ms))
    return k_ms, p_ms, b_ms


def phase_k1(dev, rng):
    phase("3 K1 local_ccl vs plain version (tolerance: exact)")
    print("default block %s" % (local_ccl.block_shape_for(4096, 4096)[0],))
    for block in K1_BLOCKS + [(40, 72)]:
        print_occupancy(block)
    # every block shape K1 takes on the path (BLOCK, and one block of a
    # small image rounded to 8), 256 x 256, non-square and non-power-of-two
    # blocks, ragged images padded to whole blocks; (1024, 1024) and
    # (4096, 4096) are the cluster images of config1 and of one tile
    for shape, block in [((200, 328), 32), ((1000, 1000), None),
                         ((517, 771), 32), ((256, 384), None),
                         ((100, 60), None), ((517, 771), (40, 72)),
                         ((300, 700), (128, 256)), ((600, 520), (256, 256)),
                         ((1024, 1024), None), ((4096, 4096), None)]:
        for four in (True, False):
            raw = random_clusters(rng, shape)
            if block is None:
                by, bx = local_ccl.block_shape_for(*shape)[0]
            else:
                by, bx = (block, block) if isinstance(block, int) else block
            hp, wp = -(-shape[0] // by) * by, -(-shape[1] // bx) * bx
            img = np.zeros((hp, wp), np.int32)
            img[:shape[0], :shape[1]] = raw
            img_t = torch.from_numpy(img).to(dev)
            got = local_ccl.local_ccl_blocks(img_t, 0, four, block=(by, bx))
            want = local_ccl.local_ccl_blocks_reference(img_t, 0, four,
                                                        block=(by, bx))
            check_equal(got, want, "K1 %s block %s four=%s"
                        % (shape, (by, bx), four))
            raw_t = torch.from_numpy(raw).to(dev)
            seg_k, n_k, _ = clump.clump_labels(raw_t, 0, four)
            seg_p, n_p, _ = clump.clump_labels(
                raw_t, 0, four,
                local_ccl=local_ccl.local_ccl_blocks_reference)
            seg_s, n_s, _ = clump.clump_labels(raw_t, 0, four,
                                               two_level=False)
            check_equal(seg_k, seg_p, "clump_labels K1 vs plain seed %s"
                        % (shape,))
            check_equal(seg_k, seg_s, "clump_labels two-level vs sweeps %s"
                        % (shape,))
            assert n_k == n_p == n_s
            print("K1 %s block %s four=%s: equal, clump_labels equal "
                  "(%d clumps; K1 or plain seed, two-level or sweeps)"
                  % (shape, (by, bx), four, n_k))
    if clump.clump_labels.fallbacks:
        raise AssertionError("phase 3: the two-level verify failed %d times"
                             % clump.clump_labels.fallbacks)
    # K1's time by block shape at the sizes of config1's and a tile's
    # cluster images (the default block first)
    for size in (1024, 4096):
        for four in (True, False):
            img_t = torch.from_numpy(random_clusters(
                rng, (size, size))).to(dev)
            for block in K1_BLOCKS:
                check_equal(local_ccl.local_ccl_blocks(img_t, 0, four,
                                                       block=block),
                            local_ccl.local_ccl_blocks_reference(
                                img_t, 0, four, block=block),
                            "K1 %d^2 block %s four=%s" % (size, block, four))
                time_k1(img_t, block, four, "random clusters %d^2" % size)


def time_clump(clusters, four, two_level, reps=3):
    """The clump stage between synchronize()s: (best wall s, labels,
    stats of the last call)."""
    walls = []
    for _ in range(reps):
        stats = {}
        torch.cuda.synchronize()
        t0 = time.time()
        seg, num, _ = clump.clump_labels(clusters, 0, four,
                                         two_level=two_level, stats=stats)
        torch.cuda.synchronize()
        walls.append(time.time() - t0)
    return min(walls), (seg, num), stats


def clump_ab(clusters, four, what):
    """two_level on against off in one process, in turns (on, off, off,
    on): labels equal, both clump-stage walls printed."""
    got = {}
    for two_level in (True, False, False, True):
        wall, result, stats = time_clump(clusters, four, two_level)
        prev = got.setdefault(two_level, (wall, result, stats))
        got[two_level] = (min(wall, prev[0]), result, stats)
    (on_wall, on, stats), (off_wall, off, off_stats) = got[True], got[False]
    check_equal(on[0], off[0], "%s: two-level vs sweeps labels" % what)
    assert on[1] == off[1]
    if stats["fallback"] or not stats["two_level"]:
        raise AssertionError("%s: two-level path not taken: %s"
                             % (what, stats))
    print("%s clump stage four=%s: two-level %.2f ms (%d boundary edges, "
          "%d merge iterations, fallback %s), sweeps %.2f ms (%d sweeps); "
          "%d clumps, labels equal"
          % (what, four, on_wall * 1e3, stats["edges"],
             stats["merge_iterations"], stats["fallback"], off_wall * 1e3,
             off_stats["sweeps"], on[1]))


# K2 rows of phase 4: (what, index shape, table entries, index dtype,
# table dtype, view offset), at the types the path passes. The relabel's
# table is int32 (the segment image's type), the graph passes' is the int64
# remap; 24000-24308 is a 4096^2 tile's capacity at 4096 cells, 56000-60000
# one of phase 7b's tiles (60000 is above the staged route's int32 table).
I32, I64 = torch.int32, torch.int64
K2_ROWS = [
    ("relabel", (1024, 1024), 4096, I32, I32, 0),
    ("relabel", (777, 1031), 32768, I32, I32, 0),
    ("graph pass", (26000,), 13000, I32, I64, 0),
    ("graph pass", (123457,), 32768, I32, I64, 0),
    ("graph pass, 4096^2 tile", (72000,), 24000, I32, I64, 0),
    ("relabel", (4096, 4096), 13000, I32, I32, 0),
    ("remap composition, 4096^2 tile", (24308,), 24308, I64, I64, 0),
    ("graph pass, phase 7b tile", (165000,), 56000, I32, I64, 0),
    ("relabel, 4096^2 tile", (4096, 4096), 24308, I32, I32, 0),
    ("relabel, phase 7b tile", (4096, 4096), 56000, I32, I32, 0),
    ("relabel, phase 7b tile", (4096, 4096), 60000, I32, I32, 0),
    ("misaligned views", (1024 * 1024,), 4096, I32, I32, 1),
    ("misaligned views", (72000,), 24000, I32, I64, 1),
]
# ops that would cast or mask around K2
CAST_OPS = {"aten::to", "aten::_to_copy", "aten::copy_", "aten::bitwise_and",
            "aten::__and__"}


def k2_inputs(dev, rng, shape, c, idx_dtype, table_dtype, offset=0):
    """Indices in [0, c) and a table whose values use the type's bits,
    both sliced at ``offset`` (offset 1 makes views that are not 16-byte
    aligned)."""
    hi = 2 ** 31 - 1 if table_dtype == torch.int32 else 2 ** 62
    n = int(np.prod(shape))
    table = torch.from_numpy(rng.integers(0, hi, size=c + offset)).to(
        dev, table_dtype)[offset:]
    idx = torch.from_numpy(rng.integers(0, c, size=n + offset)).to(
        dev, idx_dtype)[offset:].view(shape)
    return idx, table


def library_gather(idx, table):
    """The one PyTorch call that computes K2's function: the yardstick of
    phase 4 (the port never calls it)."""
    return torch.index_select(table, 0, idx.reshape(-1)).view(idx.shape)


def k2_bytes(idx, table):
    """Bytes K2 must move: the indices read, the output written, the table
    read once."""
    return (idx.numel() * (idx.element_size() + table.element_size()) +
            table.numel() * table.element_size())


def kernels_of(fn):
    """(device kernels, aten ops) that one call of ``fn`` runs, from
    torch.profiler; the kernel list is empty if the profiler saw no
    device activity."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    kernels = [e.name for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    ops = [e.name for e in events if e.name.startswith("aten::")]
    return kernels, ops


def check_no_casts(fn, what):
    """The wrapper launches K2 and nothing else: one device kernel (when
    the profiler traces the device) and no cast or mask op."""
    kernels, ops = kernels_of(fn)
    casts = sorted(set(ops) & CAST_OPS)
    if casts or (kernels and len(kernels) != 1):
        raise AssertionError("K2 %s: kernels %s, cast ops %s"
                             % (what, kernels, casts))
    print("K2 %s through the wrapper: device kernels %s, aten ops %s"
          % (what, kernels or "not traced", sorted(set(ops))))


def phase_k2(dev, rng):
    """Every row on both routes (where the table fits shared memory) and
    on the route the wrapper picks, equal to the plain version; the
    picked route timed against the plain version at the same types.
    Returns the graph-pass record for the kernels line."""
    phase("4 K2 lut_gather vs plain version (tolerance: exact)")
    limit = lut.smem_limit(dev)
    record = None
    for what, shape, c, idx_dtype, table_dtype, offset in K2_ROWS:
        # int32 indices into an int64 table of ids that use all 32 bits
        idx = torch.from_numpy(rng.integers(0, c, size=shape).astype(
            np.int32)).to(dev)
        table = torch.from_numpy(rng.integers(
            0, 2 ** 32, size=c, dtype=np.int64)).to(dev)
        check_equal(lut.lut_gather(idx, table),
                    lut.lut_gather_reference(idx, table),
                    "K2 %s from %d, uint32 ids" % (shape, c))
        idx, table = k2_inputs(dev, rng, shape, c, idx_dtype, table_dtype,
                               offset)
        want = lut.lut_gather_reference(idx, table)
        routes = ["direct"]
        if lut.STAGED_PAD + c * table.element_size() <= limit:
            routes.append("staged")
        for route in routes:
            check_equal(lut.lut_gather(idx, table, route=route), want,
                        "K2 %s %s from %d (%s)" % (what, shape, c, route))
        route = lut.lut_route(idx.numel(), c, table_dtype, limit)
        p_ms = cuda_ms(lambda: lut.lut_gather_reference(idx, table))
        k_ms = cuda_ms(lambda: lut.lut_gather(idx, table))
        lib_ms = cuda_ms(lambda: library_gather(idx, table))
        b_ms = bound_ms(k2_bytes(idx, table))
        others = ", ".join(
            "%s %.4f ms" % (r, cuda_ms(
                lambda: lut.lut_gather(idx, table, route=r)))
            for r in routes if r != route)
        print("K2 %s, %s %s from %d %s%s: equal on %s; route %s, kernel "
              "%.4f ms, plain %.4f ms, index_select %.4f ms, bound %.4f ms "
              "(%.1f%% of bound)%s"
              % (what, shape, str(idx_dtype)[6:], c, str(table_dtype)[6:],
                 ", offset %d" % offset if offset else "",
                 " and ".join(routes), route, k_ms, p_ms, lib_ms, b_ms,
                 100 * b_ms / k_ms, " (%s)" % others if others else ""))
        if what == "graph pass, 4096^2 tile":
            record = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                          bound_by="bytes", library_ms=lib_ms,
                          max_abs_err=max_abs_err(
                              lut.lut_gather(idx, table), want))
        if what in ("graph pass, 4096^2 tile",
                    "remap composition, 4096^2 tile"):
            check_no_casts(lambda: lut.lut_gather(idx, table), what)
    return record


def phase_k2_sweep(dev, rng):
    """Both routes at reuse n / c from 1 to 4096 (at most 2^24 indices):
    the numbers that set lut.STAGED_MIN_REUSE."""
    phase("4b K2 route sweep: kernel ms direct / staged by reuse n/c")
    for c, idx_dtype, table_dtype in [
            (434, I32, I32), (4096, I32, I32), (24308, I32, I32),
            (32768, I32, I32), (40000, I32, I32), (48000, I32, I32),
            (56000, I32, I32), (24308, I32, I64), (24308, I64, I64)]:
        cells, even = [], None
        for reuse in (1, 4, 16, 32, 64, 256, 1024, 4096):
            if reuse * c > 2 ** 24:
                break
            idx, table = k2_inputs(dev, rng, (reuse * c,), c, idx_dtype,
                                   table_dtype)
            d_ms = cuda_ms(lambda: lut.lut_gather(idx, table, route="direct"))
            s_ms = cuda_ms(lambda: lut.lut_gather(idx, table, route="staged"))
            cells.append("%d: %.4f / %.4f" % (reuse, d_ms, s_ms))
            if even is None and s_ms <= d_ms:
                even = reuse
        print("c %d (%d KB), %s from %s: %s; staged first at or under "
              "direct at reuse %s (staged in use from reuse %d and %d KB)"
              % (c, c * table.element_size() // 1024, str(idx_dtype)[6:],
                 str(table_dtype)[6:], " | ".join(cells), even,
                 lut.STAGED_MIN_REUSE, lut.STAGED_MIN_BYTES // 1024))


def atomic_sum(size, index, source, dim=0):
    """A float sum as the port summed before K4: index_add_, in the order
    of the card's atomics (the library beside K4 below, and the A side of
    phase 7's refits; the port no longer calls it for floats)."""
    shape = list(source.shape)
    shape[dim] = size
    return torch.zeros(shape, dtype=source.dtype,
                       device=source.device).index_add_(dim, index, source)


def host_ms(fn, reps=3):
    """Mean milliseconds of ``fn`` on the host clock (the CPU versions)."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def k4_bytes(n, bins, ncols):
    """Bytes K4 must move (the count ``ordered_sum.bytes``): each key
    (8 B) and each element's columns read once, each bin's written once,
    at most one bin a key."""
    return n * 8 + (n + min(n, bins)) * ncols * 4


# K4 rows of phase 4c: the float sums of the path, (what, bins, elements,
# columns): a float 4096^2 tile's band sums into a cropland tile's ids,
# the k-means Lloyd sums
K4_ROWS = [("float tile spectral sums, 4096^2 x 3", 1_580_534, 4096 * 4096,
            3),
           ("k-means sums, 10^6 points x 4", 60, 1_000_000, 4)]


def time_k4_sum(dev, gen, what, bins, n, ncols):
    """segreduce.ordered_sum at one of K4_ROWS against the CPU's
    index_add_ bit for bit; ms of K4 alone, of the whole wrapper (its
    library sort of the keys included), of the plain version on the host
    and of the atomic index_add_ on the card."""
    index = torch.randint(0, bins, (n,), generator=gen, device=dev)
    source = 0.3 + 0.05 * torch.randn((n, ncols), generator=gen, device=dev)
    cpu_index, cpu_source = index.cpu(), source.cpu()
    want = segreduce.ordered_sum_reference(bins, cpu_index, cpu_source)
    got = segreduce.ordered_sum(bins, index, source)
    check_equal(got.cpu().view(torch.int32), want.view(torch.int32),
                "K4 %s" % what)
    keys = torch.sort((index << 32) | torch.arange(n, device=dev)).values
    out = torch.zeros_like(got)
    k_ms = cuda_ms(lambda: segreduce.ordered_sum_keys(keys, source, out))
    w_ms = cuda_ms(lambda: segreduce.ordered_sum(bins, index, source))
    p_ms = host_ms(lambda: segreduce.ordered_sum_reference(
        bins, cpu_index, cpu_source))
    lib_ms = cuda_ms(lambda: atomic_sum(bins, index, source))
    b_ms = bound_ms(k4_bytes(n, bins, ncols))
    print("K4 %s into %d bins: equal to the CPU's index_add_; kernel %.4f ms,"
          " bound %.4f ms (%.1f%% of bound), with its sort %.4f ms, plain "
          "(CPU) %.4f ms, atomic index_add_ %.4f ms"
          % (what, bins, k_ms, b_ms, 100 * b_ms / k_ms, w_ms, p_ms, lib_ms))
    return dict(shape="%s into %d bins" % (what, bins), ms=k_ms,
                plain_ms=p_ms, bound_ms=b_ms, bound_by="bytes",
                library_ms=lib_ms, max_abs_err=0.0)


def time_k4_pass(dev, rng, capacity=1_580_534, nbands=3, candidates=1598,
                 movers=1581):
    """A float graph pass's apply (elim_small.merge_apply_movers: the
    selection kernel, the sort of one key a candidate, K4) at a cropland
    tile's mean pass against merge_apply_reference on the CPU, bit for
    bit; ms of K4 alone and of the whole apply (in place: less the copies
    that restore their inputs), of the plain version on the host and of
    the atomic index_add_ pair on the card."""
    size, sums, best_nbr, d_best = k3_inputs(dev, rng, capacity, nbands,
                                             candidates, movers)
    sums = (sums.to(torch.float32) * 1e-4).contiguous()
    args = (best_nbr, d_best, 5, 100.0)
    cpu = [t.cpu() for t in (size, sums, best_nbr, d_best)]
    want = elim_small.merge_apply_reference(*cpu, 5, 100.0)
    cand = int((size == 5).sum())
    s, u = size.clone(), sums.clone()
    got = elim_small.merge_apply_movers(s, u, *args, cand)
    for name, g, w in zip(("merge_map", "size", "sums", "movers"), got,
                          want):
        check_equal(g.cpu(), w, "float apply %s" % name)
    move = want[0] != torch.arange(capacity)
    ids = torch.nonzero(move).squeeze(1).to(dev)
    keys = torch.full((cand,), elim_small._NO_KEY, dtype=torch.int64,
                      device=dev)
    keys[:ids.numel()] = torch.sort((best_nbr[ids] << 32) | ids).values

    def restore():
        s.copy_(size)
        u.copy_(sums)
    c_ms = cuda_ms(restore)
    k_ms = cuda_ms(lambda: (restore(), segreduce.ordered_sum_keys(
        keys, u, u, dim=1, zero_source=True))) - c_ms
    a_ms = cuda_ms(lambda: (restore(), elim_small.merge_apply_movers(
        s, u, *args, cand))) - c_ms
    p_ms = host_ms(lambda: elim_small.merge_apply_reference(*cpu, 5, 100.0))
    merge_to = torch.where(move.to(dev), best_nbr, 0)
    moved_size = torch.where(move.to(dev), size, 0)
    moved_sums = torch.where(move.to(dev)[None], sums, 0)
    lib_ms = cuda_ms(lambda: (
        torch.zeros_like(size).index_add_(0, merge_to, moved_size),
        torch.zeros_like(sums).index_add_(1, merge_to, moved_sums)))
    b_ms = bound_ms(cand * 8 + 2 * movers * nbands * 4)
    print("K4 float graph pass, capacity %d, %d bands, %d candidates, %d "
          "movers: equal to merge_apply_reference; K4 %.4f ms, bound %.4f ms"
          " (%.1f%% of bound), whole apply %.4f ms, plain (CPU) %.4f ms, "
          "atomic index_add_ pair %.4f ms"
          % (capacity, nbands, cand, movers, k_ms, b_ms, 100 * b_ms / k_ms,
             a_ms, p_ms, lib_ms))


def phase_k4(dev, rng):
    """K4 at each of K4_ROWS and at a float graph pass; returns the tile
    row's record."""
    phase("4c K4 ordered_sum vs the CPU's index_add_ (tolerance: exact)")
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    records = [time_k4_sum(dev, gen, *row) for row in K4_ROWS]
    time_k4_pass(dev, rng)
    return records[0]


# K3 rows of phase 4d: (what, capacity, bands, candidates, movers). A
# 4096^2 tile of the benchmark's cropland holds 1.57-1.61 M segment ids
# and its passes have 1598 candidates and 1581 movers on average (medians
# 30 and 2; one cycle of the granule's 16 tiles, PERF.md).
K3_ROWS = [
    ("cropland tile pass", 1_580_534, 3, 1598, 1581),
    ("cropland tile pass, 7 bands", 1_580_534, 7, 1598, 1581),
    ("every candidate moves", 1_580_534, 3, 50000, 50000),
    ("small table", 1024, 3, 40, 10),
]


def k3_inputs(dev, rng, capacity, nbands, candidates, movers, target=5,
              max_d=100.0):
    """A graph pass's apply-step inputs (size, sums, best_nbr, d_best):
    half the ids empty, the others larger than ``target`` but for
    ``candidates`` ids of size ``target``, the first ``movers`` of which
    have a best neighbour (a larger segment) within ``max_d``; sums as of
    uint16 bands."""
    size = np.where(rng.random(capacity) < 0.5, 0,
                    rng.integers(target + 1, 400, size=capacity))
    cand = rng.choice(np.arange(1, capacity), size=candidates, replace=False)
    size[cand] = target
    pool = np.flatnonzero(size > target)
    best_nbr = np.full(capacity, 0xFFFFFFFF, np.int64)
    d_best = np.full(capacity, np.inf, np.float32)
    best_nbr[cand[:movers]] = rng.choice(pool, size=movers)
    d_best[cand[:movers]] = rng.uniform(0, max_d, size=movers)
    sums = size * rng.integers(1000, 5000, size=(nbands, capacity))
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in (size.astype(np.int64), sums.astype(np.int64),
                           best_nbr, d_best))


def k3_bytes(capacity, nbands, candidates, movers):
    """Bytes K3 must move: every id's size read and merge-map entry
    written; each candidate's best neighbour and distance read; each
    mover's size and sums read, added into its target's row and
    zeroed."""
    return (capacity * 16 + candidates * 12 +
            movers * 3 * (nbands + 1) * 8)


def time_k3(what, size, sums, best_nbr, d_best, target=5, max_d=100.0):
    """K3 against its plain version at one pass's inputs, bit for bit;
    the kernel's ms (in place: less the copies that restore its inputs
    before each call), its bound, the plain version's ms and the ms of
    the pair of index_add_ calls the plain version makes (the port calls
    them only for float sums). Returns the record for the kernels line."""
    args = (best_nbr, d_best, target, max_d)
    want = elim_small.merge_apply_reference(size, sums, *args)
    s, u = size.clone(), sums.clone()
    got = elim_small.merge_apply(s, u, *args)
    for name, g, w in zip(("merge_map", "size", "sums", "movers"), got,
                          want):
        check_equal(g, w, "K3 %s %s" % (what, name))
    capacity, nbands = sums.shape[1], sums.shape[0]
    ids = torch.arange(capacity, device=size.device)
    candidates = int(((size == target) & (ids >= 1)).sum())
    movers = int(want[3])

    def restore():
        s.copy_(size)
        u.copy_(sums)

    def kernel():
        restore()
        elim_small.merge_apply(s, u, *args)
    c_ms = cuda_ms(restore)
    k_ms = cuda_ms(kernel) - c_ms
    p_ms = cuda_ms(lambda: elim_small.merge_apply_reference(size, sums,
                                                            *args))
    move = want[0] != ids
    merge_to = torch.where(move, best_nbr, 0)
    moved_size = torch.where(move, size, 0)
    moved_sums = torch.where(move[None], sums, 0)
    lib_ms = cuda_ms(lambda: (
        torch.zeros_like(size).index_add_(0, merge_to, moved_size),
        torch.zeros_like(sums).index_add_(1, merge_to, moved_sums)))
    b_ms = bound_ms(k3_bytes(capacity, nbands, candidates, movers))
    print("K3 %s: capacity %d, %d bands, %d candidates, %d movers: equal; "
          "kernel %.4f ms, bound %.4f ms (%.1f%% of bound), plain %.4f ms, "
          "index_add_ pair %.4f ms"
          % (what, capacity, nbands, candidates, movers, k_ms, b_ms,
             100 * b_ms / k_ms, p_ms, lib_ms))
    return dict(shape="%s, capacity %d, %d bands, %d candidates, %d movers"
                % (what, capacity, nbands, candidates, movers), ms=k_ms,
                plain_ms=p_ms, bound_ms=b_ms, bound_by="bytes",
                library_ms=lib_ms,
                max_abs_err=max(max_abs_err(g, w) for g, w in
                                zip(got, want)))


def phase_k3(dev, rng):
    """K3 at every row of K3_ROWS; returns the cropland row's record."""
    phase("4d K3 merge_apply vs plain version (tolerance: exact)")
    records = [time_k3(what, *k3_inputs(dev, rng, *shape))
               for what, *shape in K3_ROWS]
    return records[0]


def tile_clusters(img, km, dev):
    """The cluster image doShepherdSegmentation clumps (int32, null 0)."""
    return shepseg.assign_clusters(
        shepseg.image_tensor(img, dev),
        torch.as_tensor(km.cluster_centers_, device=dev), 0, False)


def phase_config1(dev):
    """End to end at bench config1; returns (launches, kernel records)."""
    phase("5 end to end, config1 1024x1024")
    img = make_image(1024, 1024, 4, device=dev)
    km = shepseg.fitSpectralClusters(img, 60, 1, None, True, device=dev)
    print("k-means fit on the card: %d iterations" % km.n_iter_)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    res = shepseg.doShepherdSegmentation(img, kmeansObj=km, device="cuda",
                                         **CONFIG1)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches, syncs, routes = read_counts(), to_host.syncs, read_routes()
    res_cpu = shepseg.doShepherdSegmentation(img, kmeansObj=km,
                                             device="cpu", **CONFIG1)
    if not np.array_equal(res.segimg, res_cpu.segimg):
        raise AssertionError("config1: cuda and cpu segimg differ at %d "
                             "pixels" % (res.segimg != res_cpu.segimg).sum())
    need_integer_path("config1", launches)
    nseg = int(res.segimg.max())
    if clump.clump_labels.fallbacks:
        raise AssertionError("config1: two-level verify failed")
    print("config1: segimg cuda == cpu; %d segments, %d clumps, %d sweeps, "
          "%d graph passes, %d host syncs, %.3f s (first call), launches "
          "%s, K2 by route %s"
          % (nseg, nseg + res.singlePixelsEliminated +
             res.smallSegmentsEliminated, res.clumpSweeps, res.elimPasses,
             syncs, wall, launches, routes))

    # each kernel's time at its shape on this path, beside the plain one
    clusters = tile_clusters(img, km, dev)
    clump_ab(clusters, True, "config1")
    blk, _ = local_ccl.block_shape_for(1024, 1024)
    k1 = local_ccl.local_ccl_blocks(clusters, 0, True, block=blk)
    k1_ref = local_ccl.local_ccl_blocks_reference(clusters, 0, True,
                                                  block=blk)
    check_equal(k1, k1_ref, "K1 at config1 clusters")
    k_ms, p_ms, b_ms = time_k1(clusters, blk, True, "config1 clusters")
    records = {"local_ccl": dict(
        shape="config1 1024^2 cluster image, block %dx%d, 4-connected"
        % blk, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by="bytes",
        library_ms=None, max_abs_err=max_abs_err(k1, k1_ref))}
    seg_t = torch.from_numpy(res.segimg.astype(np.int32)).to(dev)
    table = torch.arange(nseg + 1, dtype=torch.int32, device=dev).flip(0)
    k2 = lut.lut_gather(seg_t, table)
    k2_ref = lut.lut_gather_reference(seg_t, table)
    check_equal(k2, k2_ref, "K2 at config1 relabel")
    records["lut_gather"] = dict(
        shape="final relabel, 1024^2 int32 from %d int32" % (nseg + 1),
        ms=cuda_ms(lambda: lut.lut_gather(seg_t, table)),
        plain_ms=cuda_ms(lambda: lut.lut_gather_reference(seg_t, table)),
        bound_ms=bound_ms(k2_bytes(seg_t, table)), bound_by="bytes",
        library_ms=cuda_ms(lambda: library_gather(seg_t, table)),
        max_abs_err=max_abs_err(k2, k2_ref))
    print("kernel ms at config1 shapes (K1 on the 1024^2 cluster image, "
          "K2 on the 1024^2 final relabel):", records)
    return launches, records


def phase_tile(dev):
    phase("6 end to end, 4096x4096 tile")
    img = make_image(4096, 4096, 4, ncells=4096, device=dev)
    km = shepseg.fitSpectralClusters(img, 60, 1, None, True, device=dev)
    walls = []
    for _ in range(2):
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.time()
        res = shepseg.doShepherdSegmentation(img, kmeansObj=km,
                                             device="cuda", **CONFIG1)
        torch.cuda.synchronize()
        walls.append(time.time() - t0)
    peak = torch.cuda.max_memory_allocated()
    launches, syncs, routes = read_counts(), to_host.syncs, read_routes()
    seg = res.segimg
    nseg = int(seg.max())
    nclumps = nseg + res.singlePixelsEliminated + res.smallSegmentsEliminated
    counts = np.bincount(seg.ravel(), minlength=nseg + 1)
    if (counts[1:] == 0).any() or counts[0] != 0:
        raise AssertionError("4096^2: labels are not contiguous 1..max")
    _, nxt = clump.clump(seg, 0, fourConnected=True, device="cuda")
    if nxt - 1 != nseg:
        raise AssertionError("4096^2: re-clumping gives %d segments, not %d"
                             % (nxt - 1, nseg))
    need_integer_path("4096^2", launches)
    if clump.clump_labels.fallbacks:
        raise AssertionError("4096^2: two-level verify failed")
    print("4096^2: %d clumps (capacity %d), %d segments, %d sweeps, "
          "%d graph passes, %d host syncs, first %.3f s, second %.3f s, "
          "peak %.1f MiB, launches %s, K2 by route %s; labels contiguous, "
          "every segment one component"
          % (nclumps, nclumps + 1, nseg, res.clumpSweeps, res.elimPasses,
             syncs, walls[0], walls[1], peak / 2 ** 20, launches, routes))

    clusters = tile_clusters(img, km, dev)
    for four in (True, False):
        clump_ab(clusters, four, "tile4096")
        time_k1(clusters, local_ccl.block_shape_for(4096, 4096)[0], four,
                "tile4096 clusters")
    # the block edge: K1's time against the merge's boundary edges
    saved = local_ccl.BLOCK
    try:
        for edge in (64, 128, 256):
            local_ccl.BLOCK = edge
            for four in (True, False):
                k_ms = cuda_ms(lambda: local_ccl.local_ccl_blocks(
                    clusters, 0, four, block=edge))
                wall, _, stats = time_clump(clusters, four, True)
                print("tile4096 block %d four=%s: K1 %.4f ms, two-level "
                      "clump stage %.2f ms, %d boundary edges, %d merge "
                      "iterations" % (edge, four, k_ms, wall * 1e3,
                                      stats["edges"],
                                      stats["merge_iterations"]))
    finally:
        local_ccl.BLOCK = saved

    # the whole tile with the sweeps forced, in turns with the default
    sweeps_only = functools.partial(clump.clump_labels, two_level=False)
    segment = shepseg.clump_labels
    got = {}
    for two_level in (True, False, False, True):
        shepseg.clump_labels = segment if two_level else sweeps_only
        try:
            torch.cuda.synchronize()
            t0 = time.time()
            res_ab = shepseg.doShepherdSegmentation(
                img, kmeansObj=km, device="cuda", **CONFIG1)
            torch.cuda.synchronize()
        finally:
            shepseg.clump_labels = segment
        got.setdefault(two_level, []).append(time.time() - t0)
        if not np.array_equal(res_ab.segimg, seg):
            raise AssertionError("4096^2: two_level=%s changes segimg"
                                 % two_level)
    print("4096^2 warm wall, two-level %s s, sweeps %s s; segimg equal"
          % (["%.3f" % x for x in got[True]],
             ["%.3f" % x for x in got[False]]))
    return img, km, seg


# float32 reflectance (phase 6b): Sentinel-2 L2A's rule for processing
# baseline 04.00 on, reflectance = (DN + BOA_ADD_OFFSET) / 10000 with an
# offset of -1000, and a nodata value no reflectance takes
FLOAT_NODATA = -9999.0


def reflectance(dn, fill=0.0):
    """uint16 DNs as float32 reflectance, the first ``fill`` share of the
    columns set to FLOAT_NODATA in every band, as at a scene's edge."""
    img = (dn.astype(np.float32) - np.float32(1000)) / np.float32(10000)
    img[:, :, :int(img.shape[2] * fill)] = FLOAT_NODATA
    return img


def need_float_path(what, counts, passes=None):
    """K1, K2, K4 and the float apply launched, K3 not; given the tile's
    ``passes``, K4 once for its sums and once a pass, the float apply once
    a pass."""
    need_launches(what, counts, ("local_ccl", "lut_gather") + FLOAT_ONLY)
    if counts["merge_apply"]:
        raise AssertionError("%s: float imagery launched K3 %d times"
                             % (what, counts["merge_apply"]))
    if passes is not None and (counts["ordered_sum"],
                               counts["merge_apply_movers"]) != (passes + 1,
                                                                 passes):
        raise AssertionError("%s: %d graph passes, K4 launched %d times and"
                             " the float apply %d times"
                             % (what, passes, counts["ordered_sum"],
                                counts["merge_apply_movers"]))


def float_tile_run(img, km, device):
    """doShepherdSegmentation of a float tile at config1's settings, its
    fill as nodata, counted from 0: (result, wall s, launches)."""
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    res = shepseg.doShepherdSegmentation(img, kmeansObj=km, device=device,
                                         imgNullVal=FLOAT_NODATA, **CONFIG1)
    torch.cuda.synchronize()
    return res, time.time() - t0, read_counts()


def phase_float(dev, tmp):
    """6b: float32 reflectance through the main path on the card against
    the CPU, bit for bit: a 4096^2 tile without fill and with 39 % (a
    Landsat scene's share), through doShepherdSegmentation (labels,
    singles, segments eliminated, passes), and a 1536^2 scene with 39 %
    fill in 2 x 2 tiles of 1024 through doTiledShepherdSegmentation
    (raster, histogram, maxSegId). K4 and the float apply must launch,
    K3 never. Times the fill tile's band sums with the null segment left
    out (the path) and summed (one serial run of the fill). Returns the
    launches of one card run of each tile and of the tiled run."""
    phase("6b float32 reflectance on the main path, card vs CPU (tolerance:"
          " exact)")
    dn = make_image(4096, 4096, 4, ncells=4096, device=dev)
    total = {}
    for fill in (0.0, 0.39):
        what = "float 4096^2, %.0f%% fill" % (100 * fill)
        img = reflectance(dn, fill)
        km = shepseg.fitSpectralClusters(img, 60, 1, FLOAT_NODATA, True,
                                          device=dev)
        walls = []
        for _ in range(2):
            res, wall, launches = float_tile_run(img, km, "cuda")
            walls.append(wall)
        cpu, cpu_wall, _ = float_tile_run(img, km, "cpu")
        if not np.array_equal(res.segimg, cpu.segimg):
            raise AssertionError("%s: card and CPU differ at %d pixels"
                                 % (what, (res.segimg != cpu.segimg).sum()))
        for name in ("singlePixelsEliminated", "smallSegmentsEliminated",
                     "elimPasses"):
            if getattr(res, name) != getattr(cpu, name):
                raise AssertionError("%s: %s %d on the card, %d on the CPU"
                                     % (what, name, getattr(res, name),
                                        getattr(cpu, name)))
        need_float_path(what, launches, res.elimPasses)
        add_counts(total, launches)
        print("%s: card == CPU bit for bit (labels, %d singles, %d segments"
              " eliminated, %d passes); %d segments; card %.3f s first, "
              "%.3f s second, CPU %.3f s; launches %s"
              % (what, res.singlePixelsEliminated,
                 res.smallSegmentsEliminated, res.elimPasses,
                 int(res.segimg.max()), walls[0], walls[1], cpu_wall,
                 launches))
    seg_t = torch.from_numpy(res.segimg.astype(np.int64)).to(dev)
    planes = tuple(torch.from_numpy(img[b]).to(dev)
                   for b in range(img.shape[0]))
    cap = int(res.segimg.max()) + 1
    skip_ms = cuda_ms(lambda: segreduce.seg_spectral_sums_tile(
        seg_t, planes, cap), reps=5)
    full_ms = cuda_ms(lambda: segreduce.seg_spectral_sums_planes(
        seg_t, planes, cap), reps=5)
    print("%s band sums (sort and K4): null segment (%d pixels) left out "
          "%.3f ms, summed as one serial run %.3f ms"
          % (what, int((res.segimg == 0).sum()), skip_ms, full_ms))
    del dn, img, seg_t, planes

    h = w = 1536
    img = reflectance(make_scene(h, w, 4, ncells=900, seed=11), 0.39)
    inpath = os.path.join(tmp, "float.npseg")
    write_scene(inpath, img, FLOAT_NODATA)
    km, _, _ = tiling.fitSpectralClustersWholeFile(
        rio.open(inpath), [1, 2, 3, 4], 60, None, FLOAT_NODATA, True,
        device="cuda")
    got = {}
    for device in ("cuda", "cpu"):
        out = os.path.join(tmp, "float_%s.npseg" % device)
        reset_counts()
        t0 = time.time()
        res = tiling.doTiledShepherdSegmentation(
            inpath, out, tileSize=1024, overlapSize=256, kmeansObj=km,
            imgNullVal=FLOAT_NODATA, device=device, **TILED)
        got[device] = (read_seg(out), res.maxSegId, res.hasEmptySegments,
                       read_counts(), time.time() - t0)
    (seg_g, hist_g), max_g, empty_g, launches, wall_g = got["cuda"]
    (seg_c, hist_c), max_c, empty_c, _, wall_c = got["cpu"]
    # every pixel but the null segment's is labelled (a single pixel
    # beside the fill may join the null segment, as in the JAX package)
    check_mosaic(seg_g, hist_g, max_g, empty_g, int(np.count_nonzero(seg_g)),
                 "float tiled 1536^2")
    if (not np.array_equal(seg_g, seg_c) or not np.array_equal(hist_g, hist_c)
            or (max_g, empty_g) != (max_c, empty_c)):
        raise AssertionError("float tiled 1536^2: card and CPU differ at %d"
                             " pixels" % (seg_g != seg_c).sum())
    need_float_path("float tiled 1536^2", launches)
    add_counts(total, launches)
    print("float tiled 1536^2, 39%% fill: card == CPU bit for bit (raster, "
          "histogram, maxSegId %d); card %.3f s, CPU %.3f s; launches %s"
          % (max_g, wall_g, wall_c, launches))
    return total


def check_mosaic(seg, hist, maxSegId, hasEmpty, npix, what):
    """Every pixel labelled, ids exactly 1..maxSegId, RAT == counts."""
    if hasEmpty:
        raise AssertionError("%s: hasEmptySegments" % what)
    if int(hist.sum()) != npix:
        raise AssertionError("%s: histogram sums to %d, not %d"
                             % (what, hist.sum(), npix))
    if (len(hist) != maxSegId + 1 or hist[0] != 0 or
            np.count_nonzero(hist[1:]) != maxSegId or
            int(seg.max()) != maxSegId):
        raise AssertionError("%s: ids do not cover exactly 1..%d"
                             % (what, maxSegId))
    counts = np.bincount(seg.ravel(), minlength=len(hist))
    counts[0] = 0
    if not np.array_equal(counts, hist):
        raise AssertionError("%s: RAT histogram differs from the raster"
                             % what)


def report_run(name, wall, npix, timings, peak, ntiles, launches):
    totals = timings.makeSummaryDict()
    ivals = " ".join("%s %.3f" % (k, totals[k]['total'])
                     for k in INTERVALS if k in totals)
    print("%s: %d tiles, wall %.3f s, %.2f Mpix/s, peak %.1f MiB, "
          "launches %s, K2 by route %s, two-level fallbacks %d | Timers "
          "(s): %s"
          % (name, ntiles, wall, npix / 1e6 / wall, peak / 2 ** 20,
             launches, read_routes(), clump.clump_labels.fallbacks, ivals))


def scene_file(tmp, h, w, ncells, refit=False):
    """Make an (h, w) 4-band scene of ``ncells`` cells, write it as
    ``.npseg`` and fit k-means to its whole-file subsample on the card;
    with ``refit``, fit it a second time, which must give the same
    centres bit for bit. Returns (path, kmeans)."""
    t0 = time.time()
    img = make_scene(h, w, 4, ncells=ncells)
    inpath = os.path.join(tmp, "scene%d.npseg" % ncells)
    write_scene(inpath, img)
    del img
    inDs = rio.open(inpath)
    km, pcnt, _ = tiling.fitSpectralClustersWholeFile(
        inDs, [1, 2, 3, 4], 60, None, None, True, device="cuda")
    print("scene of %d cells made, written and k-means fitted on the card "
          "(%.1f%% subsample, %d iterations) in %.1f s"
          % (ncells, pcnt, km.n_iter_, time.time() - t0))
    if refit:
        # in turns with the atomic sums the port had before (atomic,
        # serial (K4), atomic): the serial fits must be equal
        fits = {}
        for sums in ("atomic", "fixed", "atomic"):
            kmeans.index_sum = (atomic_sum if sums == "atomic" else
                                segreduce.index_sum)
            try:
                t0 = time.time()
                again, _, _ = tiling.fitSpectralClustersWholeFile(
                    inDs, [1, 2, 3, 4], 60, None, None, True,
                    device="cuda")
                wall = time.time() - t0
            finally:
                kmeans.index_sum = segreduce.index_sum
            fits.setdefault(sums, []).append(again)
            print("k-means refit with %s sums: %.3f s, %d iterations"
                  % (sums, wall, again.n_iter_))
        again = fits["fixed"][0]
        if (not np.array_equal(km.cluster_centers_, again.cluster_centers_)
                or (km.inertia_, km.n_iter_) != (again.inertia_,
                                                 again.n_iter_)):
            raise AssertionError(
                "k-means: two fits of the scene differ in %d centre values "
                "(inertia %r / %r, iterations %d / %d)"
                % ((km.cluster_centers_ != again.cluster_centers_).sum(),
                   km.inertia_, again.inertia_, km.n_iter_, again.n_iter_))
        a, b = fits["atomic"]
        print("k-means: the serial (K4) fits' centres, inertia and %d "
              "iterations equal bit for bit; the atomic fits' centres "
              "differ in %d values (%d / %d iterations)"
              % (again.n_iter_, (a.cluster_centers_ !=
                                 b.cluster_centers_).sum(),
                 a.n_iter_, b.n_iter_))
    if not tiling.DeviceSceneCache.fitsOnDevice(inDs, [1, 2, 3, 4], "cuda"):
        raise AssertionError("tiled: the scene does not fit the cache")
    return inpath, km


def tiled_run(name, inpath, out, km, cfg, npix):
    """One doTiledShepherdSegmentation at the default tile with config1's
    settings, counted from 0; returns (result, launch counts)."""
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    res = tiling.doTiledShepherdSegmentation(
        inpath, out, concurrencyCfg=cfg, tileSize=4096, overlapSize=1024,
        kmeansObj=km, device="cuda", **TILED)
    wall = time.time() - t0
    launches = read_counts()
    ntiles = res.numTileRows * res.numTileCols
    if ntiles != 9:
        raise AssertionError("%s: %d tiles, not 9" % (name, ntiles))
    report_run(name, wall, npix, res.timings,
               torch.cuda.max_memory_allocated(), ntiles, launches)
    if clump.clump_labels.fallbacks:
        raise AssertionError("%s: the two-level verify failed on %d tiles"
                             % (name, clump.clump_labels.fallbacks))
    return res, launches


def phase_tiled(tmp):
    """8000^2 scene, default tile 4096 / overlap 1024 (uniform grid: 3x3
    tiles of 4096^2), config1's settings. Serial with the scene cache,
    two worker threads, and the 3-phase API must agree bit for bit.
    Returns the serial run's launch counts, the scene's path, the serial
    output's path and the scene's k-means."""
    phase("7 tiled, 8000x8000 scene, default tile")
    h = w = 8000
    # 4000 cells: with k-means fitted to the whole scene, a 4096^2 tile
    # of this scene has 16-27 K clumps (15000 cells give 51-60 K, see
    # phase_tiled_dense)
    inpath, km = scene_file(tmp, h, w, 4000, refit=True)
    runs = {}
    for name, cfg in [
            ("serial", tiling.SegmentationConcurrencyConfig(
                deviceSceneCache=True)),
            ("threads", tiling.SegmentationConcurrencyConfig(
                concurrencyType=tiling.CONC_THREADS, numWorkers=2,
                tileCompletionTimeout=600))]:
        out = os.path.join(tmp, name + ".npseg")
        res, launches = tiled_run(name, inpath, out, km, cfg, h * w)
        runs[name] = (out, res.maxSegId, res.hasEmptySegments, launches)

    # the 3-phase API: prepare, one doOne per tile to a file, finalize
    timings = Timers()
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    with timings.interval("walltime"):
        (ds, bn, km3, _, null3, tileInfo) = (
            tiling.doTiledShepherdSegmentation_prepare(
                inpath, tileSize=4096, overlapSize=1024, kmeansObj=km,
                device="cuda"))
        names = {}
        with timings.interval("segmentation"):
            for (col, row) in sorted(tileInfo.tiles):
                names[(col, row)] = os.path.join(
                    tmp, "tile_%d_%d.npseg" % (col, row))
                tiling.doTiledShepherdSegmentation_doOne(
                    ds, names[(col, row)], tileInfo, col, row, bn, null3,
                    km3, minSegmentSize=TILED["minSegmentSize"],
                    maxSpectralDiff=TILED["maxSpectralDiff"],
                    fourConnected=TILED["fourConnected"], device="cuda")
        out = os.path.join(tmp, "3phase.npseg")
        with timings.interval("stitchtiles"):
            (maxSegId, hasEmpty,
             _) = tiling.doTiledShepherdSegmentation_finalize(
                ds, out, names, tileInfo, 1024, tmp)
    report_run("3-phase (segmentation = read + segment + write per tile)",
               time.time() - t0, h * w, timings,
               torch.cuda.max_memory_allocated(), len(names), read_counts())
    runs["3-phase"] = (out, maxSegId, hasEmpty, read_counts())

    seg0, hist0 = read_seg(runs["serial"][0])
    check_mosaic(seg0, hist0, runs["serial"][1], runs["serial"][2], h * w,
                 "tiled serial")
    for name in ("threads", "3-phase"):
        seg, hist = read_seg(runs[name][0])
        if (not np.array_equal(seg, seg0) or
                not np.array_equal(hist, hist0) or
                runs[name][1:3] != runs["serial"][1:3]):
            raise AssertionError("tiled: %s differs from serial" % name)
    serial = runs["serial"][3]
    if serial["local_ccl"] < 9:
        raise AssertionError("tiled: serial run launched K1 %d times"
                             % serial["local_ccl"])
    need_integer_path("tiled serial", serial)
    print("tiled 8000^2: serial == threads == 3-phase bit for bit; %d "
          "segments, no empty ids, histogram sums to %d"
          % (runs["serial"][1], hist0.sum()))
    return serial, inpath, runs["serial"][0], km


# every statistic the engine has, on every band (phase 9)
STATS = [("min", "min"), ("max", "max"), ("mean", "mean"),
         ("stddev", "stddev"), ("median", "median"), ("mode", "mode"),
         ("p25", "percentile", 25), ("pixcount", "pixcount")]
STATS_INTERVALS = ("reading", "compaction", "accumulation",
                   "statscompletion", "writing")


def rat_columns(path, names):
    rat = rio.open(path).GetRasterBand(1).GetDefaultRAT()
    have = [rat.GetNameOfCol(i) for i in range(rat.GetColumnCount())]
    return {n: rat.ReadAsArray(have.index(n)) for n in names}


def report_stats(name, res, wall, npix, extra=""):
    totals = res.timings.makeSummaryDict()
    ivals = " ".join("%s %.3f" % (k, totals[k]['total'])
                     for k in STATS_INTERVALS if k in totals)
    print("%s: wall %.3f s, %.2f Mpix/s, peak %.1f MiB%s | Timers (s): %s"
          % (name, wall, npix / 1e6 / wall,
             torch.cuda.max_memory_allocated() / 2 ** 20, extra, ivals))


def device_busy_s(prof):
    """Seconds in which the card ran a kernel or a copy, from a
    torch.profiler trace (the union of the device's event intervals); 0
    if the profiler saw no device activity."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for start, stop in spans:
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    return busy / 1e6


def stats_run(name, scene, segpath, bands, engine, npix, fraction=0.25,
              profiled=False):
    """One calcPerSegmentStatsTiledMultiBand of every statistic over
    ``bands`` into columns prefixed ``name``, on the card, with the scene
    budget's memory share ``fraction`` (0 forces the per-tile feed); under
    torch.profiler with ``profiled``, whose trace gives the card's busy
    and idle share of the wall. Returns the column names."""
    from torch.profiler import ProfilerActivity, profile
    sel = [[("%s_b%d_%s" % (name, b, st[0]),) + st[1:] for st in STATS]
           for b in bands]
    saved = tiling.SCENE_CACHE_HBM_FRACTION
    tiling.SCENE_CACHE_HBM_FRACTION = fraction
    tracer = (profile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA])
              if profiled else contextlib.nullcontext())
    try:
        segstats.windowRuns.cuda_calls = 0
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        with tracer as prof:
            t0 = time.time()
            res = tilingstats.calcPerSegmentStatsTiledMultiBand(
                scene, bands, segpath, sel, engine=engine, device="cuda")
            torch.cuda.synchronize()
            wall = time.time() - t0
    finally:
        tiling.SCENE_CACHE_HBM_FRACTION = saved
    extra = ", compaction on the card %d times" % (
        segstats.windowRuns.cuda_calls)
    if profiled:
        busy = device_busy_s(prof)
        extra += (", under torch.profiler: card busy %.3f s, idle share "
                  "%.1f %%" % (busy, 100 * (1 - busy / wall)) if busy else
                  ", under torch.profiler: no device activity traced")
    report_stats(name, res, wall, npix, extra)
    if (engine == "device") != (segstats.windowRuns.cuda_calls > 0):
        raise AssertionError("stats %s: compaction ran on the card %d times"
                             % (name, segstats.windowRuns.cuda_calls))
    return [c[0] for b in sel for c in b]


def spatial_run(name, scene, segpath, cols, userFunc, param, engine, npix):
    """One calcPerSegmentSpatialStatsTiled on band 1; returns its
    columns."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    res = tilingstats.calcPerSegmentSpatialStatsTiled(
        scene, 1, segpath, cols, userFunc, param, engine=engine,
        device="cuda")
    wall = time.time() - t0
    report_stats("spatial %s (%s engine)" % (name, engine), res, wall, npix)
    return list(rat_columns(segpath, [c[0] for c in cols]).values())


def phase_stats(scene, segpath):
    """The statistics engine over phase 7's serial output: every
    statistic on all 4 bands by the device engine with the scene-resident
    feed, the device engine with the per-tile feed, and the host engine,
    equal bit for bit; pixcount against a bincount of the segmentation.
    Then the spatial built-ins on band 1, device route against host
    route. A nodata value that occurs in the image is set on every band
    for the phase and taken off after it."""
    phase("9 stats over scene8000's output: device scene feed, device "
          "per-tile feed, host engine (tolerance: exact)")
    ds = rio.open(scene, rio.GA_Update)
    nodata = int(ds.GetRasterBand(1).ReadAsArray(
        ds.RasterXSize // 2, ds.RasterYSize // 2, 1, 1)[0, 0])
    for b in range(1, 5):
        ds.GetRasterBand(b).SetNoDataValue(nodata)
    try:
        run_stats_phase(scene, segpath, nodata)
    finally:
        for b in range(1, 5):
            ds.GetRasterBand(b).SetNoDataValue(None)


def run_stats_phase(scene, segpath, nodata):
    seg = rio.open(segpath).GetRasterBand(1).ReadAsArray()
    npix = seg.size
    bands = [1, 2, 3, 4]
    names = {run: stats_run(run, scene, segpath, bands, engine, npix,
                            fraction, run == "profiled")
             for run, engine, fraction in [("scene", "device", 0.25),
                                           ("tiles", "device", 0.0),
                                           ("host", "host", 0.25),
                                           ("profiled", "device", 0.25)]}
    cols = {run: rat_columns(segpath, n) for run, n in names.items()}
    for run in ("tiles", "host", "profiled"):
        for a, b in zip(names["scene"], names[run]):
            if not np.array_equal(cols["scene"][a], cols[run][b]):
                raise AssertionError("stats: %s differs from %s" % (b, a))
    img = rio.open(scene)
    nulls = 0
    for b in bands:
        valid = img.GetRasterBand(b).ReadAsArray() != nodata
        nulls += seg.size - int(valid.sum())
        want = np.bincount(seg[valid], minlength=len(
            cols["scene"]["scene_b%d_pixcount" % b]))
        want[0] = 0
        if not np.array_equal(cols["scene"]["scene_b%d_pixcount" % b],
                              want):
            raise AssertionError("stats: band %d pixcount differs from the "
                                 "segmentation's bincount" % b)
    print("stats: %d columns, scene feed == per-tile feed == host engine "
          "bit for bit; pixcount == bincount of the segmentation; %d "
          "segments; nodata %d on %d band pixels"
          % (len(names["scene"]), int(seg.max()), nodata, nulls))

    # the spatial built-ins on band 1: the device engine's box functions
    # against the host engine's halo streaming, and the default 'auto',
    # which must stream on the card and so equal the host's bit for bit
    band1 = rio.open(scene).GetRasterBand(1)
    for fn, param in [(tilingstats.userFuncNumEdgePixels, True),
                      (tilingstats.userFuncVariogram, 3)]:
        if tilingstats._spatialRoute("auto", fn, param, "cuda",
                                     band1)[1] is None:
            raise AssertionError("spatial: 'auto' on the card does not "
                                 "stream %s" % fn.__name__)
    engines = ("device", "host", "auto")
    edge = {e: spatial_run("edge pixels", scene, segpath,
                           [("edge_" + e, rio.GFT_Integer)],
                           tilingstats.userFuncNumEdgePixels, True, e, npix)
            for e in engines}
    if not np.array_equal(edge["device"][0], edge["host"][0]):
        raise AssertionError("spatial: edge pixels differ, device vs host")
    vario = {e: spatial_run("variogram maxDist 3", scene, segpath,
                            [("v%d_%s" % (d, e), rio.GFT_Real)
                             for d in (1, 2, 3)],
                            tilingstats.userFuncVariogram, 3, e, npix)
             for e in engines}
    for a, h in zip(edge["auto"] + vario["auto"], edge["host"] +
                    vario["host"]):
        if not np.array_equal(a, h):
            raise AssertionError("spatial: 'auto' differs from the host's "
                                 "streaming route")
    worst = 0.0
    for dv, hv in zip(vario["device"], vario["host"]):
        # float32 accumulation order (PARITY.md deviation 6)
        np.testing.assert_array_equal(dv == -9999, hv == -9999)
        np.testing.assert_allclose(dv, hv, rtol=1e-5, atol=1e-3)
        live = hv != -9999
        worst = max(worst, float(np.max(np.abs(dv[live] - hv[live]) /
                                        np.maximum(np.abs(hv[live]), 1))))
    transform = (0.0, 1.0, 0.0, 0.0, 0.0, 1.0)
    cols_mc = [("mx", rio.GFT_Real), ("my", rio.GFT_Real)]
    mean_dev = spatial_run("deviceFuncMeanCoord", scene, segpath,
                           [(c + "_dev", t) for c, t in cols_mc],
                           tilingstats.deviceFuncMeanCoord, transform,
                           "device", npix)
    mean_host = spatial_run("userFuncMeanCoord", scene, segpath,
                            [(c + "_host", t) for c, t in cols_mc],
                            tilingstats.userFuncMeanCoord, transform,
                            "host", npix)
    for dv, hv in zip(mean_dev, mean_host):
        np.testing.assert_allclose(dv, hv, rtol=1e-5, atol=1e-2)
    print("spatial: edge pixels device == host == auto; variograms auto == "
          "host, device within rtol 1e-5 (largest relative difference "
          "%.3g); mean coordinates, float32 device vs float64 host, within "
          "atol 1e-2 px" % worst)


def phase_cli(tmp, scene):
    """The tiling CLI in-process on the scene: segmentation, stats of 3
    statistics on all 4 bands, colour table from the band means. Every
    pixel labelled with ids 1..maxSegId, the RAT's stats equal a host
    engine run on the output, K1 and K2 launched. Returns the
    launches."""
    phase("10 tiling CLI end to end on the scene")
    out = os.path.join(tmp, "cli.npseg")
    argv = ["pyshepseg_tpu_torch_tiling", "-i", scene, "-o", out,
            "-b", "1,2,3,4", "--statsbands", "1,2,3,4",
            "--statspec", "mean", "--statspec", "stddev",
            "--statspec", "percentile,50", "--colortablebands", "1,2,3",
            "--fixedkmeansinit"]
    # the CLI's two passes, timed from inside: their Timers and walls
    parts = {}
    segment = tiling.doTiledShepherdSegmentation
    stats = tilingstats.calcPerSegmentStatsTiledMultiBand

    def timed(name, fn):
        def call(*args, **kwargs):
            t = time.time()
            res = fn(*args, **kwargs)
            parts[name] = (time.time() - t, res.timings.makeSummaryDict())
            return res
        return call

    saved = sys.argv
    reset_counts()
    segstats.windowRuns.cuda_calls = 0
    torch.cuda.reset_peak_memory_stats()
    sys.argv = argv
    tiling.doTiledShepherdSegmentation = timed("segmentation", segment)
    tilingstats.calcPerSegmentStatsTiledMultiBand = timed("stats", stats)
    t0 = time.time()
    try:
        tiling_cli.mainCmd()
    finally:
        sys.argv = saved
        tiling.doTiledShepherdSegmentation = segment
        tilingstats.calcPerSegmentStatsTiledMultiBand = stats
    wall = time.time() - t0
    launches, compactions = read_counts(), segstats.windowRuns.cuda_calls
    seg, hist = read_seg(out)
    print("CLI: %s" % " ".join(argv[1:]))
    print("CLI: wall %.3f s, %.2f Mpix/s, peak %.1f MiB, launches %s, "
          "K2 by route %s, compaction on the card %d times"
          % (wall, seg.size / 1e6 / wall,
             torch.cuda.max_memory_allocated() / 2 ** 20, launches,
             read_routes(), compactions))
    for name, (secs, totals) in parts.items():
        print("CLI %s pass: %.3f s | Timers (s): %s"
              % (name, secs, " ".join("%s %.3f" % (k, v['total'])
                                      for k, v in totals.items())))
    if launches["local_ccl"] < 9 or launches["lut_gather"] < 1:
        raise AssertionError("CLI: K1 launched %d times and K2 %d times"
                             % (launches["local_ccl"],
                                launches["lut_gather"]))
    if compactions == 0:
        raise AssertionError("CLI: the stats pass never ran on the card")
    check_mosaic(seg, hist, len(hist) - 1, False, seg.size, "CLI")
    names = ["Band_%d_%s" % (b, s) for b in (1, 2, 3, 4)
             for s in ("mean", "stddev", "pcnt50")]
    sel = [[("host_Band_%d_mean" % b, "mean"),
            ("host_Band_%d_stddev" % b, "stddev"),
            ("host_Band_%d_pcnt50" % b, "percentile", 50)]
           for b in (1, 2, 3, 4)]
    t0 = time.time()
    tilingstats.calcPerSegmentStatsTiledMultiBand(
        scene, [1, 2, 3, 4], out, sel, engine="host", device="cuda")
    host_wall = time.time() - t0
    cols = rat_columns(out, names + ["host_" + n for n in names] +
                       ["Red", "Green", "Blue"])
    for n in names:
        if not np.array_equal(cols[n], cols["host_" + n]):
            raise AssertionError("CLI: %s differs from the host engine's"
                                 % n)
    print("CLI: %d segments, every pixel labelled 1..maxSegId, %d stats "
          "columns equal the host engine's (its run %.3f s), colour "
          "columns present" % (len(hist) - 1, len(names), host_wall))
    return launches


def phase_tiled_dense(tmp):
    """The 8000^2 scene at the density of phase 6's tile (15000 cells),
    serial with the scene cache: with k-means fitted to the whole scene
    its tiles hold 51-60 K clumps, above the JAX kernel's table, and K2
    must launch on every tile. Reports its own launch counts and Timers."""
    phase("7b tiled, 8000x8000 scene at 15000 cells, serial")
    h = w = 8000
    inpath, km = scene_file(tmp, h, w, 15000)
    out = os.path.join(tmp, "dense.npseg")
    per_tile = []
    segment = shepseg.doShepherdSegmentation

    def counted(*args, **kwargs):
        before = lut.lut_gather.launches
        result = segment(*args, **kwargs)
        per_tile.append(lut.lut_gather.launches - before)
        return result

    shepseg.doShepherdSegmentation = counted
    try:
        res, launches = tiled_run(
            "dense serial", inpath, out, km,
            tiling.SegmentationConcurrencyConfig(deviceSceneCache=True),
            h * w)
    finally:
        shepseg.doShepherdSegmentation = segment
    seg, hist = read_seg(out)
    check_mosaic(seg, hist, res.maxSegId, res.hasEmptySegments, h * w,
                 "tiled dense")
    if launches["local_ccl"] < 9:
        raise AssertionError("tiled dense: K1 launched %d times"
                             % launches["local_ccl"])
    if len(per_tile) != 9 or min(per_tile) < 1:
        raise AssertionError("tiled dense: K2 launches per tile %s"
                             % per_tile)
    print("tiled 8000^2 at 15000 cells: %d segments, no empty ids, "
          "histogram sums to %d, launches %s, K2 launches per tile %s"
          % (res.maxSegId, hist.sum(), launches, per_tile))


def phase_tiled_cpu(tmp):
    """1536^2 scene in 2x2 tiles of 1024^2: card == CPU bit for bit."""
    phase("8 tiled, card vs CPU")
    h = w = 1536
    img = make_scene(h, w, 4, ncells=900, seed=11)
    inpath = os.path.join(tmp, "small.npseg")
    write_scene(inpath, img)
    km, _, _ = tiling.fitSpectralClustersWholeFile(
        rio.open(inpath), [1, 2, 3, 4], 60, None, None, True, device="cuda")
    got = {}
    for device in ("cuda", "cpu"):
        out = os.path.join(tmp, "small_%s.npseg" % device)
        reset_counts()
        t0 = time.time()
        res = tiling.doTiledShepherdSegmentation(
            inpath, out, tileSize=1024, overlapSize=256, kmeansObj=km,
            device=device, **TILED)
        print("%s: %d x %d tiles, %d segments, %.3f s, launches %s"
              % (device, res.numTileRows, res.numTileCols, res.maxSegId,
                 time.time() - t0, read_counts()))
        got[device] = (read_seg(out), res.maxSegId, res.hasEmptySegments)
    (seg_g, hist_g), max_g, empty_g = got["cuda"]
    (seg_c, hist_c), max_c, empty_c = got["cpu"]
    check_mosaic(seg_g, hist_g, max_g, empty_g, h * w, "tiled 1536^2")
    if (not np.array_equal(seg_g, seg_c) or not np.array_equal(hist_g, hist_c)
            or (max_g, empty_g) != (max_c, empty_c)):
        raise AssertionError("tiled 1536^2: card and CPU differ at %d "
                             "pixels" % (seg_g != seg_c).sum())
    print("tiled 1536^2: card == CPU bit for bit (raster, histogram, "
          "maxSegId %d)" % max_g)
    return inpath, os.path.join(tmp, "small_cuda.npseg")


def phase_dense_memory(dev):
    """doShepherdSegmentation on a noisy 2048^2 image of many cells, whose
    capacity is above the staged route's int32 table (and the JAX
    kernel's): every K2 gather takes the direct route. Card == CPU."""
    phase("8b in memory, 2048x2048 above K2's staged table, card vs CPU")
    img = make_image(2048, 2048, 4, ncells=12000, noise=40.0, device=dev)
    km = shepseg.fitSpectralClusters(img, 60, 1, None, True, device=dev)
    reset_counts()
    t0 = time.time()
    res = shepseg.doShepherdSegmentation(img, kmeansObj=km, device="cuda",
                                         **CONFIG1)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches, routes = read_counts(), read_routes()
    t0 = time.time()
    res_cpu = shepseg.doShepherdSegmentation(img, kmeansObj=km,
                                             device="cpu", **CONFIG1)
    wall_cpu = time.time() - t0
    nseg = int(res.segimg.max())
    capacity = (nseg + res.singlePixelsEliminated +
                res.smallSegmentsEliminated + 1)
    if lut.lut_route(img[0].size, capacity, torch.int32,
                     lut.smem_limit(dev)) != "direct":
        raise AssertionError("2048^2: capacity %d fits the staged route"
                             % capacity)
    if routes["direct"] == 0 or routes["staged"] != 0:
        raise AssertionError("2048^2: K2 by route %s" % routes)
    if not np.array_equal(res.segimg, res_cpu.segimg):
        raise AssertionError("2048^2: cuda and cpu segimg differ at %d "
                             "pixels" % (res.segimg != res_cpu.segimg).sum())
    print("2048^2 noisy: segimg cuda == cpu bit for bit; capacity %d, %d "
          "segments, %d graph passes, card %.3f s (first call), CPU %.3f s, "
          "launches %s, K2 by route %s"
          % (capacity, nseg, res.elimPasses, wall, wall_cpu, launches,
             routes))


def phase_runtests(dev):
    """The golden end-to-end check, cmdline.runtests, in-process on the
    card at its defaults (1000^2, 101 Voronoi centres, tile 512 / overlap
    128): it must exit 0 with every oracle holding, and launch K1 and K2.
    Then the two timing helpers of the shepseg API at config1. Returns
    the launches."""
    phase("11 runtests on the card at its defaults, timing helpers")
    saved = sys.argv
    with tempfile.TemporaryDirectory() as tmp:
        sys.argv = ["pyshepseg_tpu_torch_runtests", "-d", tmp,
                    "--device", "cuda"]
        reset_counts()
        t0 = time.time()
        try:
            runtests_cli.mainCmd()
            raise AssertionError("runtests: returned without an exit code")
        except SystemExit as exit_info:
            code = exit_info.code
        finally:
            sys.argv = saved
        torch.cuda.synchronize()
        wall = time.time() - t0
    launches = read_counts()
    print("runtests --device cuda: exit %s, wall %.3f s, launches %s, K2 by "
          "route %s, two-level fallbacks %d"
          % (code, wall, launches, read_routes(),
             clump.clump_labels.fallbacks))
    if code != 0:
        raise AssertionError("runtests: exit code %r" % (code,))
    # (its k-means fit sums in float on the card: K4 may launch)
    need_launches("runtests", launches, INT_KERNELS)

    img = make_image(1024, 1024, 4, device=dev)
    km = shepseg.fitSpectralClusters(img, 60, 1, None, True, device=dev)
    args = (img, km, "auto", CONFIG1["minSegmentSize"],
            CONFIG1["fourConnected"])
    mpix = shepseg.deviceResidentThroughput(*args)
    secs, rtt = shepseg.deviceOnlySeconds(*args)
    for v in (mpix, secs, rtt):
        if not (np.isfinite(v) and v > 0):
            raise AssertionError("timing helpers: %r, %r, %r"
                                 % (mpix, secs, rtt))
    print("config1 timing helpers: deviceResidentThroughput %.3f Mpix/s "
          "(%.4f s a call), deviceOnlySeconds %.4f s a run (k 8), sync "
          "round trip %.6f s" % (mpix, 1.048576 / mpix, secs, rtt))
    return launches


def add_counts(total, counts):
    for name, n in counts.items():
        total[name] = total.get(name, 0) + n


def need_launches(what, counts, names=("local_ccl", "lut_gather")):
    for name in names:
        if counts[name] == 0:
            raise AssertionError("%s: %s never launched" % (what, name))


def phase_segment_tile(dev, img, km, seg6):
    """12a: pipeline.segment_tile at tile4096 with the image on the card
    already: labels == phase 6's doShepherdSegmentation bit for bit; warm
    seconds by CUDA events beside the same call with the download.
    Returns (the segment image on the card, launches)."""
    phase("12a pipeline.segment_tile, 4096x4096 tile on the card")
    img_dev = torch.from_numpy(img).to(dev)
    centers = torch.tensor(np.asarray(km.cluster_centers_, np.float32),
                           device=dev)
    maxdiff = float(shepseg.autoMaxSpectralDiff(km, 'auto', 50))

    def tile():
        return pipeline.segment_tile(img_dev, centers, 0, maxdiff,
                                     CONFIG1["minSegmentSize"], True, False)

    def with_download():
        return shepseg.doShepherdSegmentation(img_dev, kmeansObj=km,
                                              device=dev, **CONFIG1)

    reset_counts()
    seg, maxid = tile()
    torch.cuda.synchronize()
    launches, syncs = read_counts(), to_host.syncs
    if not (seg.is_cuda and maxid.is_cuda):
        raise AssertionError("segment_tile: result left the card")
    if not np.array_equal(seg.cpu().numpy().view(np.uint32), seg6):
        raise AssertionError("segment_tile: labels differ from "
                             "doShepherdSegmentation's")
    if int(maxid) != int(seg6.max()):
        raise AssertionError("segment_tile: maxSegId %d, not %d"
                             % (int(maxid), int(seg6.max())))
    need_launches("segment_tile", launches)
    with_download()
    times = {"tile": [], "download": []}
    for _ in range(3):
        times["tile"].append(shepseg._elapsed(tile, dev))
        times["download"].append(shepseg._elapsed(with_download, dev))
    print("segment_tile 4096^2: labels == phase 6 bit for bit, %d segments, "
          "%d host syncs, launches %s; warm CUDA-event seconds %s, the same "
          "through doShepherdSegmentation (with the download) %s"
          % (int(maxid), syncs, launches,
             ["%.4f" % t for t in times["tile"]],
             ["%.4f" % t for t in times["download"]]))
    return seg, launches


def phase_mesh(tmp, inpath, km, serial_out):
    """12b: CONC_MESH over scene8000, tilesPerDevice 1 and 2, in turns
    with CONC_NONE: output == phase 7's serial output bit for bit, every
    pixel labelled, K1 once and K2 at least once a tile, no two-level
    fallback. Returns the mesh runs' launches."""
    phase("12b CONC_MESH, 8000x8000 scene, tilesPerDevice 1 and 2")
    h = w = 8000
    seg0, hist0 = read_seg(serial_out)
    per_tile = []
    segment = mesh.segment_tile

    def counted(*args, **kwargs):
        before = (local_ccl.local_ccl_blocks.launches,
                  lut.lut_gather.launches)
        result = segment(*args, **kwargs)
        per_tile.append((local_ccl.local_ccl_blocks.launches - before[0],
                         lut.lut_gather.launches - before[1]))
        return result

    total = {}
    mesh.segment_tile = counted
    try:
        for name, cfg in [
                ("serial again", tiling.SegmentationConcurrencyConfig(
                    deviceSceneCache=True)),
                ("mesh tpd 1", tiling.SegmentationConcurrencyConfig(
                    concurrencyType=tiling.CONC_MESH, tilesPerDevice=1,
                    deviceSceneCache=True)),
                ("mesh tpd 2", tiling.SegmentationConcurrencyConfig(
                    concurrencyType=tiling.CONC_MESH, tilesPerDevice=2,
                    deviceSceneCache=True))]:
            del per_tile[:]
            out = os.path.join(tmp, "mesh.npseg")
            res, launches = tiled_run(name, inpath, out, km, cfg, h * w)
            seg, hist = read_seg(out)
            check_mosaic(seg, hist, res.maxSegId, res.hasEmptySegments,
                         h * w, name)
            if (not np.array_equal(seg, seg0) or
                    not np.array_equal(hist, hist0)):
                raise AssertionError("%s differs from phase 7's serial "
                                     "output at %d pixels"
                                     % (name, (seg != seg0).sum()))
            if name.startswith("mesh"):
                if (launches["local_ccl"] != 9 or len(per_tile) != 9 or
                        min(k2 for _, k2 in per_tile) < 1 or
                        any(k1 != 1 for k1, _ in per_tile)):
                    raise AssertionError("%s: launches %s, per tile %s"
                                         % (name, launches, per_tile))
                add_counts(total, launches)
                print("%s: == serial bit for bit, K1/K2 launches per tile "
                      "%s" % (name, per_tile))
    finally:
        mesh.segment_tile = segment
    return total


def reset_sharded_counts():
    reset_counts()
    shardmap_clump.exchange_rows.rows = 0
    shardmap_clump._clump_sharded.sweeps = 0
    shardmap_seg._single_pixel_sharded.passes = 0


def phase_sharded(dev, img, km, seg12a):
    """12c: the row-sharded clump and the row-sharded full pipeline on the
    tile4096 image over ["cuda:0"] * 4 and over ["cuda:0"]: == clump and ==
    12a's labels bit for bit; sweeps, halo rows moved, host syncs, wall.
    Returns the sharded segmentations' launches."""
    phase("12c row-sharded clump and segmentation, 4096x4096, 4 stripes "
          "and 1 on one card")
    clusters = tile_clusters(img, km, dev).cpu().numpy()
    torch.cuda.synchronize()
    t0 = time.time()
    want, nxt = clump.clump(clusters, 0, True, device="cuda")
    clump_wall = time.time() - t0
    centers = np.asarray(km.cluster_centers_, np.float32)
    maxdiff = float(shepseg.autoMaxSpectralDiff(km, 'auto', 50))
    want_seg = seg12a.cpu().numpy().view(np.uint32)
    total = {}
    for stripes in (4, 1):
        devices = ["cuda:0"] * stripes
        reset_sharded_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        got, num = shardmap_clump.clump_sharded(clusters, 0, True,
                                                mesh=devices)
        wall = time.time() - t0
        sweeps = shardmap_clump._clump_sharded.sweeps
        if not np.array_equal(got, want) or num != nxt - 1:
            raise AssertionError("clump_sharded over %d stripes differs "
                                 "from clump" % stripes)
        if to_host.syncs != sweeps + 1:
            raise AssertionError("clump_sharded: %d host syncs for %d "
                                 "sweeps" % (to_host.syncs, sweeps))
        print("clump_sharded, %d stripes: == clump bit for bit, %d clumps, "
              "%d sweeps, %d halo rows moved, %d host syncs, wall %.3f s "
              "(clump: %.3f s), peak %.1f MiB"
              % (stripes, num, sweeps, shardmap_clump.exchange_rows.rows,
                 to_host.syncs, wall, clump_wall,
                 torch.cuda.max_memory_allocated() / 2 ** 20))

        reset_sharded_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        seg, maxid = shardmap_seg.segment_image_sharded(
            img, centers, maxSpectralDiff=maxdiff,
            minSegmentSize=CONFIG1["minSegmentSize"], fourConnected=True,
            mesh=devices)
        wall = time.time() - t0
        launches = read_counts()
        if not np.array_equal(seg, want_seg) or maxid != int(want_seg.max()):
            raise AssertionError("segment_image_sharded over %d stripes "
                                 "differs from segment_tile at %d pixels"
                                 % (stripes, (seg != want_seg).sum()))
        need_launches("segment_image_sharded", launches, ("lut_gather",))
        add_counts(total, launches)
        print("segment_image_sharded, %d stripes: == segment_tile bit for "
              "bit, %d segments, %d clump sweeps, %d single-pixel passes, "
              "%d halo rows moved, %d host syncs, launches %s, wall %.3f s, "
              "peak %.1f MiB"
              % (stripes, maxid, shardmap_clump._clump_sharded.sweeps,
                 shardmap_seg._single_pixel_sharded.passes,
                 shardmap_clump.exchange_rows.rows, to_host.syncs, launches,
                 wall, torch.cuda.max_memory_allocated() / 2 ** 20))
    return total


# one DCN worker: the command line's entry point, then its launch counts
DCN_WORKER = """
import json, sys
from pyshepseg_tpu_torch.cmdline import dcnworkercmd
from pyshepseg_tpu_torch.ops import local_ccl, lut
dcnworkercmd.mainCmd()
print("LAUNCHES", json.dumps({
    "local_ccl": local_ccl.local_ccl_blocks.launches,
    "lut_gather": lut.lut_gather.launches}))
"""


def free_port():
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def phase_dcn(tmp, inpath, serial_out):
    """12d: two dcnworkercmd processes on the card over phase 8's 1536^2
    scene, through a TCPStore on localhost: the output equals that scene's
    serial run; both exit 0. Returns the two processes' launches."""
    phase("12d two dcnworkercmd processes on the card, 1536x1536 scene")
    work = os.path.join(tmp, "dcnwork")
    os.makedirs(work)
    out = os.path.join(work, "dcn.npseg")
    coord = "localhost:%d" % free_port()
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root, os.environ.get("PYTHONPATH", "")]))
    t0 = time.time()
    procs = [subprocess.Popen(
        [sys.executable, "-c", DCN_WORKER, "-i", inpath, "-o", out, "-w",
         work, "--coordinator", coord, "--numprocesses", "2", "--procid",
         str(pid), "-t", "1024", "-l", "256", "-m",
         str(TILED["minSegmentSize"]), "-n", str(TILED["numClusters"]),
         "--fixedkmeansinit", "--device", "cuda"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=root) for pid in range(2)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    wall = time.time() - t0
    total = {}
    for pid, (p, (stdout, stderr)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError("dcn: process %d exited %d:\n%s\n%s"
                                 % (pid, p.returncode, stdout, stderr))
        line = [ln for ln in stdout.splitlines()
                if ln.startswith("LAUNCHES")][-1]
        launches = json.loads(line.split(" ", 1)[1])
        need_launches("dcn process %d" % pid, launches)
        add_counts(total, launches)
    seg, hist = read_seg(out)
    seg0, hist0 = read_seg(serial_out)
    if not np.array_equal(seg, seg0) or not np.array_equal(hist, hist0):
        raise AssertionError("dcn: output differs from the serial run at "
                             "%d pixels" % (seg != seg0).sum())
    print("dcn, 2 processes on one card: exit codes 0 0, output == the "
          "serial run bit for bit (%d segments), launches %s, wall %.3f s"
          % (int(seg.max()), total, wall))
    return total


GPUBATCH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "parallel_examples", "gpubatch")
# phase 8's grid and settings (TILED) as the batch scripts take them,
# and phase 7's (the scripts' default grid)
BATCH_GRID = ["--tilesize", "1024", "--overlapsize", "256", "--nclusters",
              str(TILED["numClusters"]), "--fixedkmeansinit"]
BATCH_GRID_8000 = ["--tilesize", "4096", "--overlapsize", "1024",
                   "--nclusters", str(TILED["numClusters"]),
                   "--fixedkmeansinit"]


def run_job(script, args, what, timeout=600):
    """One gpubatch script in a fresh process: (stdout, wall seconds).
    A non-zero exit fails the phase."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root, os.environ.get("PYTHONPATH", "")]))
    t0 = time.time()
    res = subprocess.run(
        [sys.executable, os.path.join(GPUBATCH, script)] + args,
        capture_output=True, text=True, env=env, cwd=root, timeout=timeout)
    if res.returncode != 0:
        raise AssertionError("%s: %s exited %d:\n%s\n%s" % (
            what, script, res.returncode, res.stdout, res.stderr))
    return res.stdout, time.time() - t0


def tile_jobs(stdout, what, ntiles):
    """The TILEJOB records in ``stdout`` by tile index; every job must
    have launched K1 once and K2 at least once, on the card."""
    recs = [json.loads(ln.split(" ", 1)[1]) for ln in stdout.splitlines()
            if ln.startswith("TILEJOB ")]
    if sorted(rec["index"] for rec in recs) != list(range(ntiles)):
        raise AssertionError("%s: tile jobs %s, wanted %d" % (
            what, sorted(rec["index"] for rec in recs), ntiles))
    for rec in recs:
        if (not rec["device"].startswith("cuda")
                or rec["launches"]["local_ccl"] != 1
                or rec["launches"]["lut_gather"] < 1):
            raise AssertionError("%s: tile job %d ran on %s with launches "
                                 "%s" % (what, rec["index"], rec["device"],
                                         rec["launches"]))
    return sorted(recs, key=lambda rec: rec["index"])


STAGES = ("import", "torch", "cudainit", "kernels", "build", "download", "doOne",
          "reading", "upload", "total")


def print_tile_job(name, rec, wall=None):
    print("%s tile job %d (%d, %d): %s s | K1 %d K2 %d | peak %.1f MiB%s"
          % (name, rec["index"], rec["col"], rec["row"],
             " ".join("%s %.3f" % (k, rec["seconds"][k]) for k in STAGES),
             rec["launches"]["local_ccl"], rec["launches"]["lut_gather"],
             rec["peak_mib"],
             "" if wall is None else " | process wall %.3f s" % wall))


def phase_batch(tmp, inpath, serial_out, what, grid, ntiles,
                worker_counts=(2,)):
    """13a: the whole batch run through submit_pyshepseg_job.py's local
    backend over a scene of an earlier phase (``what``; ``grid`` is that
    phase's tile grid and k-means arguments, ``ntiles`` its tile count),
    two tile processes at a time (one run for each of ``worker_counts``;
    (1, 2) compares one process at a time with two): the output equals
    that scene's serial run bit for bit, and every tile job launched K1
    once and K2. Returns the tile jobs' launches."""
    phase("13a batch deployment (gpubatch, local backend), " + what)
    seg0, hist0 = read_seg(serial_out)
    total = {}
    for workers in worker_counts:
        name = "%s, workers %d" % (what, workers)
        store = os.path.join(tmp, "store%d_%d" % (ntiles, workers))
        stdout, wall = run_job(
            "submit_pyshepseg_job.py",
            ["--backend", "local", "--infile", inpath, "--store",
             "file://" + store, "--workers", str(workers), "--device",
             "cuda", "--minsegmentsize", str(TILED["minSegmentSize"])]
            + grid, name)
        recs = tile_jobs(stdout, name, ntiles)
        for rec in recs:
            print_tile_job(name, rec)
            add_counts(total, rec["launches"])
        seg, hist = read_seg(os.path.join(store, "segmentation.npseg"))
        if not np.array_equal(seg, seg0) or not np.array_equal(hist, hist0):
            raise AssertionError("batch, %s: output differs from the serial "
                                 "run at %d pixels" % (name,
                                                       (seg != seg0).sum()))
        if os.listdir(store) != ["segmentation.npseg"]:
            raise AssertionError("batch, %s: the store keeps %s" % (
                name, os.listdir(store)))
        doOne = sum(rec["seconds"]["doOne"] for rec in recs)
        jobs = sum(rec["seconds"]["total"] for rec in recs)
        print("batch, %s: exit 0, wall %.3f s (prepare, %d tile jobs, "
              "stitch); output == the serial run bit for bit (%d segments); "
              "tile jobs %.3f s in all, doOne %.3f s of it (%.1f %%); peak "
              "per process %.1f MiB"
              % (name, wall, ntiles, int(seg.max()), jobs, doOne,
                 100.0 * doOne / jobs,
                 max(rec["peak_mib"] for rec in recs)))
    return total


def read_tile(path):
    return rio.open(path).GetRasterBand(1).ReadAsArray()


def phase_cold_tile_job(tmp, inpath):
    """13b: one do_tile.py job with no kernel library (it compiles it)
    and one with the library in place. Returns their launches."""
    phase("13b one tile job without the kernel library, one with it")
    store = os.path.join(tmp, "store_cold")
    _, wall = run_job("do_prepare.py",
                      ["--infile", inpath, "--store", "file://" + store,
                       "--device", "cuda"] + BATCH_GRID, "prepare")
    print("prepare job: process wall %.3f s" % wall)
    total, tiles = {}, []
    for name in ("cold", "warm"):
        if name == "cold":
            os.remove(_kernels.LIB_PATH)
        stdout, wall = run_job(
            "do_tile.py", ["--store", "file://" + store, "--index", "0",
                           "--device", "cuda"], name)
        rec, = tile_jobs(stdout, name, 1)
        print_tile_job(name, rec, wall)
        built = rec["seconds"]["build"] > 0
        if built != (name == "cold"):
            raise AssertionError("%s tile job: build took %r s" % (
                name, rec["seconds"]["build"]))
        add_counts(total, rec["launches"])
        tiles.append(read_tile(os.path.join(
            store, "tile_%d_%d.npseg" % (rec["col"], rec["row"]))))
    if not os.path.exists(_kernels.LIB_PATH):
        raise AssertionError("the cold tile job left no kernel library")
    if not np.array_equal(tiles[0], tiles[1]):
        raise AssertionError("cold and warm tile jobs differ")
    print("cold and warm tile jobs: exit 0, equal tiles, the library is "
          "back at %s" % _kernels.LIB_PATH)
    return total


def main():
    kind, smi = phase_device()
    dev = torch.device("cuda")
    phase_build()
    rng = np.random.default_rng(0)
    phase_k1(dev, rng)
    graph_pass = phase_k2(dev, rng)
    phase_k2_sweep(dev, rng)
    merge_apply_rec = phase_k3(dev, rng)
    ordered_sum_rec = phase_k4(dev, rng)
    config1_launches, records = phase_config1(dev)
    img6, km6, seg6 = phase_tile(dev)
    with tempfile.TemporaryDirectory() as tmp:
        float_launches = phase_float(dev, tmp)
    # phase 12 runs where its inputs are at hand: 12a and 12c on phase 6's
    # tile, 12b on phase 7's scene, 12d on phase 8's
    seg12a, tile_launches = phase_segment_tile(dev, img6, km6, seg6)
    sharded_launches = phase_sharded(dev, img6, km6, seg12a)
    del img6, seg6, seg12a
    with tempfile.TemporaryDirectory() as tmp:
        launches, scene, segpath, km7 = phase_tiled(tmp)
        phase_stats(scene, segpath)
        cli_launches = phase_cli(tmp, scene)
        mesh_launches = phase_mesh(tmp, scene, km7, segpath)
        batch8000_launches = phase_batch(tmp, scene, segpath,
                                         "8000x8000 scene", BATCH_GRID_8000, 9)
    with tempfile.TemporaryDirectory() as tmp:
        phase_tiled_dense(tmp)
        small, small_out = phase_tiled_cpu(tmp)
        dcn_launches = phase_dcn(tmp, small, small_out)
        batch_launches = phase_batch(tmp, small, small_out,
                                     "1536x1536 scene", BATCH_GRID, 4)
        cold_launches = phase_cold_tile_job(tmp, small)
    phase_dense_memory(dev)
    runtests_launches = phase_runtests(dev)
    print("config1 launches (in-memory path):", config1_launches)
    print("tiling CLI launches (phase 10):", cli_launches)
    print("runtests launches (phase 11):", runtests_launches)
    phase12 = {"12a segment_tile": tile_launches,
               "12b CONC_MESH, two runs": mesh_launches,
               "12c sharded image, two runs": sharded_launches,
               "12d two DCN processes": dcn_launches}
    print("phase 12 launches:", phase12)
    phase13 = {"13a nine tile jobs, 8000x8000 scene": batch8000_launches,
               "13a four tile jobs, 1536x1536 scene": batch_launches,
               "13b two tile jobs": cold_launches}
    print("phase 13 launches (counted by the tile jobs):", phase13)
    # each path was counted from 0 and read just after it ran; the
    # record's count is the serial tiled run's plus phase 12's and 13's
    # (the tile jobs of phase 13 and the DCN processes report no K3)
    for counts in list(phase12.values()) + list(phase13.values()):
        add_counts(launches, counts)
    # integer imagery launches no K4: its count is phase 6b's, the float
    # path's (one card run of each tile and the tiled run)
    launches["ordered_sum"] = float_launches["ordered_sum"]
    print("float path launches (phase 6b):", float_launches)
    graph_pass["shape"] = "graph pass, 72000 int32 from 24000 int64"
    kernels = [dict(name=name, route="cuda", source=SOURCES[name][0],
                    replaces=SOURCES[name][1], launches=launches[name],
                    **rec)
               for name, rec in [("local_ccl", records["local_ccl"]),
                                 ("lut_gather", records["lut_gather"]),
                                 ("lut_gather", graph_pass),
                                 ("merge_apply", merge_apply_rec),
                                 ("ordered_sum", ordered_sum_rec)]]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
