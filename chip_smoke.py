#!/usr/bin/env python3
"""
Smoke run of pyshepseg_tpu_torch on one NVIDIA GPU: builds the CUDA
kernels from pyshepseg_tpu_torch/csrc/, holds each against its plain
PyTorch version on the card (K1 at every block shape it takes, timed by
block shape beside its bound; K2 on both of its routes, beside
torch.index_select, with a sweep of their times by reuse), drives
doShepherdSegmentation end to end at bench config1 (1024x1024) and at the
default tile size (4096x4096), each with an A/B of the clump stage's
two-level merge against the global sweeps (labels equal), then drives
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
table). Last, the golden end-to-end check cmdline.runtests at its
defaults on the card, and the timing helpers deviceResidentThroughput and
deviceOnlySeconds at config1.

    python3 chip_smoke.py

It imports numpy, torch and the port, nothing of JAX. Every phase raises
on failure, so the script exits non-zero and prints no result line; it
also fails where CUDA is absent or the package is missing. The last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}};
before it come the card's name and power limit as nvidia-smi reports them
and the per-kernel JSON record (times, bound, plain version and library
call), whose launch counts are those of the serial tiled run.
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
from pyshepseg_tpu_torch.ops import segreduce, segstats  # noqa: E402
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
                          "pyshepseg_tpu/ops/lut.py:42")}


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


def write_scene(path, img):
    nbands, h, w = img.shape
    ds = rio.create(path, w, h, nbands, img.dtype)
    for b in range(nbands):
        ds.GetRasterBand(b + 1).WriteArray(img[b])
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
    clump.clump_labels.fallbacks = 0
    to_host.syncs = 0


def read_counts():
    return {"local_ccl": local_ccl.local_ccl_blocks.launches,
            "lut_gather": lut.lut_gather.launches}


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
    """A float sum as the port summed before segreduce.index_sum:
    index_add_, in the order of the card's atomics (the A side of the
    A/Bs below; the port no longer calls it)."""
    shape = list(source.shape)
    shape[dim] = size
    return torch.zeros(shape, dtype=source.dtype,
                       device=source.device).index_add_(dim, index, source)


def distinct(fn, calls=5):
    """How many different results ``fn`` gives over ``calls`` calls."""
    return len({fn().cpu().numpy().tobytes() for _ in range(calls)})


def phase_sums(dev):
    """segreduce.index_sum against index_add_ at the float sums' shapes
    on the path: ms of each, distinct results over 5 calls, and the
    largest difference from a float64 sum."""
    phase("4c order-fixed float sums (segreduce.index_sum) vs index_add_")
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    cap = 32768
    merge_to = torch.where(
        torch.rand(cap, generator=gen, device=dev) < 0.05,
        torch.randint(1, cap, (cap,), generator=gen, device=dev), 0)
    rows = [("k-means sums, 1000000 x 4 float32 into 60", 60,
             torch.randint(0, 60, (1_000_000,), generator=gen, device=dev),
             (1_000_000, 4), 2000.0, 0),
            ("float tile spectral sums, 4096^2 x 4 into 24308", 24308,
             torch.randint(0, 24308, (4096 * 4096,), generator=gen,
                           device=dev), (4096 * 4096, 4), 2000.0, 0),
            ("graph pass sums, 4 x 32768 into 32768", cap, merge_to,
             (4, cap), 0.0, 1)]
    for what, size, index, shape, mean, dim in rows:
        source = mean + 600 * torch.randn(shape, generator=gen, device=dev)
        fixed = functools.partial(segreduce.index_sum, size, index, source,
                                  dim)
        atomic = functools.partial(atomic_sum, size, index, source, dim)
        want = atomic_sum(size, index, source.double(), dim)
        err = float((fixed().double() - want).abs().max())
        n_fixed = distinct(fixed)
        print("%s: index_add_ %.4f ms (%d distinct results of 5), index_sum "
              "%.4f ms (%d distinct of 5), largest difference from a "
              "float64 sum %.3g"
              % (what, cuda_ms(atomic, reps=10), distinct(atomic),
                 cuda_ms(fixed, reps=10), n_fixed, err))
        if n_fixed != 1:
            raise AssertionError("index_sum: %s differs between calls"
                                 % what)


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
    for name, count in launches.items():
        if count == 0:
            raise AssertionError("config1: %s never launched" % name)
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
    for name, count in launches.items():
        if count == 0:
            raise AssertionError("4096^2: %s never launched" % name)
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
        # order-fixed, atomic): the order-fixed fits must be equal
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
        print("k-means: the order-fixed fits' centres, inertia and %d "
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
    Returns the serial run's launch counts."""
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
    if serial["local_ccl"] < 9 or serial["lut_gather"] < 1:
        raise AssertionError("tiled: serial run launched K1 %d times and "
                             "K2 %d times" % (serial["local_ccl"],
                                              serial["lut_gather"]))
    print("tiled 8000^2: serial == threads == 3-phase bit for bit; %d "
          "segments, no empty ids, histogram sums to %d"
          % (runs["serial"][1], hist0.sum()))
    return serial, inpath, runs["serial"][0]


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
    for name, count in launches.items():
        if count == 0:
            raise AssertionError("runtests: %s never launched" % name)

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


def main():
    kind, smi = phase_device()
    dev = torch.device("cuda")
    phase_build()
    rng = np.random.default_rng(0)
    phase_k1(dev, rng)
    graph_pass = phase_k2(dev, rng)
    phase_k2_sweep(dev, rng)
    phase_sums(dev)
    config1_launches, records = phase_config1(dev)
    phase_tile(dev)
    with tempfile.TemporaryDirectory() as tmp:
        launches, scene, segpath = phase_tiled(tmp)
        phase_stats(scene, segpath)
        cli_launches = phase_cli(tmp, scene)
    with tempfile.TemporaryDirectory() as tmp:
        phase_tiled_dense(tmp)
        phase_tiled_cpu(tmp)
    phase_dense_memory(dev)
    runtests_launches = phase_runtests(dev)
    print("config1 launches (in-memory path):", config1_launches)
    print("tiling CLI launches (phase 10):", cli_launches)
    print("runtests launches (phase 11):", runtests_launches)
    graph_pass["shape"] = "graph pass, 72000 int32 from 24000 int64"
    kernels = [dict(name=name, route="cuda", source=SOURCES[name][0],
                    replaces=SOURCES[name][1], launches=launches[name],
                    **rec)
               for name, rec in [("local_ccl", records["local_ccl"]),
                                 ("lut_gather", records["lut_gather"]),
                                 ("lut_gather", graph_pass)]]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
