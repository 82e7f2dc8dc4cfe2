#!/usr/bin/env python3
"""
Smoke run of pyshepseg_tpu_torch on one NVIDIA GPU: builds the CUDA
kernels from pyshepseg_tpu_torch/csrc/, holds each against its plain
PyTorch version on the card, drives doShepherdSegmentation end to end at
bench config1 (1024x1024) and at the default tile size (4096x4096), then
drives the tiled driver doTiledShepherdSegmentation over an 8000x8000
scene in 9 tiles of 4096^2 (serial, two worker threads and the 3-phase
API, equal bit for bit), serially over a denser 8000x8000 scene whose
tiles exceed K2's table, and over a 1536x1536 scene on the card and on
the CPU (equal bit for bit).

    python3 chip_smoke.py

It imports numpy, torch and the port, nothing of JAX. Every phase raises
on failure, so the script exits non-zero and prints no result line; it also fails where CUDA is absent or
the package is missing. The last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}};
before it come the card's name and power limit as nvidia-smi reports them
and the per-kernel JSON record, whose launch counts are those of the
serial tiled run.
"""

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
from pyshepseg_tpu_torch import io as rio, native  # noqa: E402
from pyshepseg_tpu_torch.ops import clump, local_ccl, lut  # noqa: E402
from pyshepseg_tpu_torch.ops.sync import to_host  # noqa: E402
from pyshepseg_tpu_torch.timinghooks import Timers  # noqa: E402

CONFIG1 = dict(numClusters=60, clusterSubsamplePcnt=1, minSegmentSize=50,
               maxSpectralDiff='auto', fourConnected=True)
# config1's settings as doTiledShepherdSegmentation takes them
TILED = dict(numClusters=60, minSegmentSize=50, maxSpectralDiff='auto',
             fourConnected=True)
INTERVALS = ("reading", "segmentation", "stitchwait", "stitchtiles",
             "stitchfinalize", "walltime")
SOURCES = {"local_ccl": ("pyshepseg_tpu_torch/csrc/local_ccl.cu",
                         "pyshepseg_tpu/ops/pallas_ccl.py:92"),
           "lut_gather": ("pyshepseg_tpu_torch/csrc/lut_gather.cu",
                          "pyshepseg_tpu/ops/lut.py:42")}


def phase(name):
    print("== %s" % name, flush=True)


def make_image(h, w, nbands, ncells=400, seed=7, device="cuda"):
    """Synthetic Landsat-like tile: Voronoi patches + noise, uint16 — the
    same draws and float32 arithmetic as bench.py's make_image, with the
    nearest-centre search done on ``device``."""
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
    img = img + rng.normal(0, 8.0, img.shape)
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
    to_host.syncs = 0


def read_counts():
    return {"local_ccl": local_ccl.local_ccl_blocks.launches,
            "lut_gather": lut.lut_gather.launches}


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


def phase_k1(dev, rng):
    phase("3 K1 local_ccl vs plain version (tolerance: exact)")
    # (4096, 4096) is the cluster image of one default tile, the shape K1
    # runs at on the tiled path
    for shape, block in [((200, 328), 32), ((1000, 1000), None),
                         ((517, 771), 32), ((256, 384), None),
                         ((4096, 4096), None)]:
        for four in (True, False):
            raw = random_clusters(rng, shape)
            if block is None:
                (by, bx), _ = local_ccl.block_shape_for(*shape)
            else:
                by = bx = block
            hp, wp = -(-shape[0] // by) * by, -(-shape[1] // bx) * bx
            img = np.zeros((hp, wp), np.int32)
            img[:shape[0], :shape[1]] = raw
            img_t = torch.from_numpy(img).to(dev)
            got = local_ccl.local_ccl_blocks(img_t, 0, four, block=(by, bx))
            want = local_ccl.local_ccl_blocks_reference(img_t, 0, four,
                                                        block=(by, bx))
            check_equal(got, want, "K1 %s block %s four=%s"
                        % (shape, (by, bx), four))
            if shape == (4096, 4096):
                print("K1 at 4096^2 four=%s: kernel %.3f ms, plain %.2f ms"
                      % (four, cuda_ms(lambda: local_ccl.local_ccl_blocks(
                          img_t, 0, four, block=(by, bx))),
                         cuda_ms(lambda: local_ccl.local_ccl_blocks_reference(
                             img_t, 0, four, block=(by, bx)),
                             reps=3, warmup=1)))
            raw_t = torch.from_numpy(raw).to(dev)
            seg_k, n_k, _ = clump.clump_labels(raw_t, 0, four)
            seg_p, n_p, _ = clump.clump_labels(
                raw_t, 0, four,
                local_ccl=local_ccl.local_ccl_blocks_reference)
            check_equal(seg_k, seg_p, "clump_labels K1 vs plain seed %s"
                        % (shape,))
            assert n_k == n_p
            print("K1 %s block %s four=%s: equal, clump_labels equal "
                  "(%d clumps)" % (shape, (by, bx), four, n_k))


def phase_k2(dev, rng):
    phase("4 K2 lut_gather vs plain version (tolerance: exact)")
    # (72000, 24000) is a graph-pass gather of a 4096^2 tile: 2E indices
    # from a table of capacity entries
    for n_idx, c, two_d in [((1024, 1024), 4096, True),
                            ((777, 1031), 32768, True),
                            (26000, 13000, False), (123457, 32768, False),
                            (72000, 24000, False),
                            ((4096, 4096), 13000, True)]:
        table = torch.from_numpy(rng.integers(
            0, 2 ** 32, size=c, dtype=np.int64)).to(dev)
        idx = torch.from_numpy(rng.integers(
            0, c, size=n_idx).astype(np.int32)).to(dev)
        fn = lut.lut_gather if two_d else lut.lut_gather_flat
        check_equal(fn(idx, table), lut.lut_gather_reference(idx, table),
                    "K2 %s from %d" % (n_idx, c))
        t32 = table.to(torch.int32)
        k_ms = cuda_ms(lambda: fn(idx, t32))
        p_ms = cuda_ms(lambda: lut.lut_gather_reference(idx, t32))
        print("K2 %s from %d entries: equal; kernel %.4f ms, plain %.4f ms"
              % (n_idx, c, k_ms, p_ms))


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
    launches, syncs = read_counts(), to_host.syncs
    res_cpu = shepseg.doShepherdSegmentation(img, kmeansObj=km,
                                             device="cpu", **CONFIG1)
    if not np.array_equal(res.segimg, res_cpu.segimg):
        raise AssertionError("config1: cuda and cpu segimg differ at %d "
                             "pixels" % (res.segimg != res_cpu.segimg).sum())
    for name, count in launches.items():
        if count == 0:
            raise AssertionError("config1: %s never launched" % name)
    nseg = int(res.segimg.max())
    print("config1: segimg cuda == cpu; %d segments, %d clumps, %d sweeps, "
          "%d graph passes, %d host syncs, %.3f s (first call), launches %s"
          % (nseg, nseg + res.singlePixelsEliminated +
             res.smallSegmentsEliminated, res.clumpSweeps, res.elimPasses,
             syncs, wall, launches))

    # each kernel's time at its shape on this path, beside the plain one
    clusters = shepseg.assign_clusters(
        shepseg.image_tensor(img, dev),
        torch.as_tensor(km.cluster_centers_, device=dev), 0, False)
    blk, _ = local_ccl.block_shape_for(1024, 1024)
    k1 = local_ccl.local_ccl_blocks(clusters, 0, True, block=blk)
    k1_ref = local_ccl.local_ccl_blocks_reference(clusters, 0, True,
                                                  block=blk)
    check_equal(k1, k1_ref, "K1 at config1 clusters")
    records = {"local_ccl": dict(
        ms=cuda_ms(lambda: local_ccl.local_ccl_blocks(clusters, 0, True,
                                                      block=blk)),
        plain_ms=cuda_ms(lambda: local_ccl.local_ccl_blocks_reference(
            clusters, 0, True, block=blk), reps=3, warmup=1),
        max_abs_err=max_abs_err(k1, k1_ref))}
    seg_t = torch.from_numpy(res.segimg.astype(np.int32)).to(dev)
    table = torch.arange(nseg + 1, dtype=torch.int32, device=dev).flip(0)
    k2 = lut.lut_gather(seg_t, table)
    k2_ref = lut.lut_gather_reference(seg_t, table)
    check_equal(k2, k2_ref, "K2 at config1 relabel")
    records["lut_gather"] = dict(
        ms=cuda_ms(lambda: lut.lut_gather(seg_t, table)),
        plain_ms=cuda_ms(lambda: lut.lut_gather_reference(seg_t, table)),
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
    launches, syncs = read_counts(), to_host.syncs
    seg = res.segimg
    nseg = int(seg.max())
    nclumps = nseg + res.singlePixelsEliminated + res.smallSegmentsEliminated
    if nclumps + 1 > lut.LUT_MAX_TABLE:
        raise AssertionError("4096^2: capacity %d is above K2's table limit"
                             % (nclumps + 1))
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
    print("4096^2: %d clumps (capacity %d), %d segments, %d sweeps, "
          "%d graph passes, %d host syncs, first %.3f s, second %.3f s, "
          "peak %.1f MiB, launches %s; labels contiguous, every segment "
          "one component"
          % (nclumps, nclumps + 1, nseg, res.clumpSweeps, res.elimPasses,
             syncs, walls[0], walls[1], peak / 2 ** 20, launches))


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
          "launches %s | Timers (s): %s"
          % (name, ntiles, wall, npix / 1e6 / wall, peak / 2 ** 20,
             launches, ivals))


def scene_file(tmp, h, w, ncells):
    """Make an (h, w) 4-band scene of ``ncells`` cells, write it as
    ``.npseg`` and fit k-means to its whole-file subsample on the card.
    Returns (path, kmeans)."""
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
    return res, launches


def phase_tiled(tmp):
    """8000^2 scene, default tile 4096 / overlap 1024 (uniform grid: 3x3
    tiles of 4096^2), config1's settings. Serial with the scene cache,
    two worker threads, and the 3-phase API must agree bit for bit.
    Returns the serial run's launch counts."""
    phase("7 tiled, 8000x8000 scene, default tile")
    h = w = 8000
    # 4000 cells: with k-means fitted to the whole scene, a 4096^2 tile
    # of this scene has 16-27 K clumps, so every tile stays under K2's
    # 32768-entry table and K2 runs on each (15000 cells give 51-60 K,
    # see phase_tiled_dense)
    inpath, km = scene_file(tmp, h, w, 4000)
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
    return serial


def phase_tiled_dense(tmp):
    """The 8000^2 scene at the density of phase 6's tile (15000 cells),
    serial with the scene cache: with k-means fitted to the whole scene
    most tiles then exceed K2's table, so the graph passes gather by
    plain indexing. Reports its own launch counts and Timers."""
    phase("7b tiled, 8000x8000 scene at 15000 cells, serial")
    h = w = 8000
    inpath, km = scene_file(tmp, h, w, 15000)
    out = os.path.join(tmp, "dense.npseg")
    res, launches = tiled_run(
        "dense serial", inpath, out, km,
        tiling.SegmentationConcurrencyConfig(deviceSceneCache=True), h * w)
    seg, hist = read_seg(out)
    check_mosaic(seg, hist, res.maxSegId, res.hasEmptySegments, h * w,
                 "tiled dense")
    if launches["local_ccl"] < 9:
        raise AssertionError("tiled dense: K1 launched %d times"
                             % launches["local_ccl"])
    print("tiled 8000^2 at 15000 cells: %d segments, no empty ids, "
          "histogram sums to %d, launches %s"
          % (res.maxSegId, hist.sum(), launches))


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


def main():
    kind, smi = phase_device()
    dev = torch.device("cuda")
    phase_build()
    rng = np.random.default_rng(0)
    phase_k1(dev, rng)
    phase_k2(dev, rng)
    config1_launches, records = phase_config1(dev)
    phase_tile(dev)
    with tempfile.TemporaryDirectory() as tmp:
        launches = phase_tiled(tmp)
    with tempfile.TemporaryDirectory() as tmp:
        phase_tiled_dense(tmp)
        phase_tiled_cpu(tmp)
    print("config1 launches (in-memory path):", config1_launches)
    kernels = [dict(name=name, route="cuda", source=SOURCES[name][0],
                    replaces=SOURCES[name][1], launches=launches[name],
                    **records[name]) for name in ("local_ccl", "lut_gather")]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
