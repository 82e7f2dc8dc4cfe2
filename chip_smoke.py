#!/usr/bin/env python3
"""
Smoke run of pyshepseg_tpu_torch on one NVIDIA GPU: builds the CUDA
kernels from pyshepseg_tpu_torch/csrc/, holds each against its plain
PyTorch version on the card, then drives doShepherdSegmentation end to end
at bench config1 (1024x1024) and at the default tile size (4096x4096).

    python3 chip_smoke.py

numpy + torch only. Every phase raises on failure, so the script exits
non-zero and prints no result line; it also fails where CUDA is absent or
the package is missing. The last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}};
before it come the card's name and power limit as nvidia-smi reports them
and the per-kernel JSON record.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

# the package lives beside this script in a checkout
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from pyshepseg_tpu_torch import _kernels, shepseg  # noqa: E402
from pyshepseg_tpu_torch.ops import clump, local_ccl, lut  # noqa: E402
from pyshepseg_tpu_torch.ops.sync import to_host  # noqa: E402

CONFIG1 = dict(numClusters=60, clusterSubsamplePcnt=1, minSegmentSize=50,
               maxSpectralDiff='auto', fourConnected=True)
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


def phase_k1(dev, rng):
    phase("3 K1 local_ccl vs plain version (tolerance: exact)")
    for shape, block in [((200, 328), 32), ((1000, 1000), None),
                         ((517, 771), 32), ((256, 384), None)]:
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
    for n_idx, c, two_d in [((1024, 1024), 4096, True),
                            ((777, 1031), 32768, True),
                            (26000, 13000, False), (123457, 32768, False),
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


def main():
    kind, smi = phase_device()
    dev = torch.device("cuda")
    phase_build()
    rng = np.random.default_rng(0)
    phase_k1(dev, rng)
    phase_k2(dev, rng)
    launches, records = phase_config1(dev)
    phase_tile(dev)
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
