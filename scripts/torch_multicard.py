#!/usr/bin/env python3
"""
The port's multi-device backends over every visible CUDA card of one host
(pyshepseg_tpu_torch.parallel): what chip_smoke.py's phase 12 runs on one
card with a device list that names it several times, here with distinct
cards, so that CONC_MESH's per-card threads and streams and the halo
copies between cards run for real. Needs two CUDA cards or more and nvcc;
imports nothing of JAX.

    python3 scripts/torch_multicard.py

1. The 4096^2 4-band tile of chip_smoke.py's phase 6 through
   pipeline.segment_tile on card 0, then row-sharded over all cards
   (clump_sharded, segment_image_sharded): labels equal bit for bit;
   sweeps, halo rows copied between cards, host syncs and wall printed.
2. The 8000^2 scene of phase 7 (3 x 3 tiles of 4096^2) through CONC_NONE
   and through CONC_MESH over all cards with tilesPerDevice 1 and 2, in
   turns: mosaics equal bit for bit; walltime, Timers and Mpix/s printed.

Every check raises on failure. Prints the cards' names and power limits
first.
"""

import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as smoke  # noqa: E402
from pyshepseg_tpu_torch import shepseg, tiling  # noqa: E402
from pyshepseg_tpu_torch.ops import clump  # noqa: E402
from pyshepseg_tpu_torch.ops.sync import to_host  # noqa: E402
from pyshepseg_tpu_torch.parallel import pipeline, shardmap_clump  # noqa: E402
from pyshepseg_tpu_torch.parallel import shardmap_seg  # noqa: E402


def sharded_tile(devices):
    dev = torch.device("cuda:0")
    img = smoke.make_image(4096, 4096, 4, ncells=4096, device=dev)
    km = shepseg.fitSpectralClusters(img, 60, 1, None, True, device=dev)
    centers = np.asarray(km.cluster_centers_, np.float32)
    maxdiff = float(shepseg.autoMaxSpectralDiff(km, 'auto', 50))
    img_dev = torch.from_numpy(img).to(dev)
    centers_dev = torch.from_numpy(centers).to(dev)

    def tile():
        return pipeline.segment_tile(img_dev, centers_dev, 0, maxdiff, 50,
                                     True, False)

    want, _ = tile()
    secs = min(shepseg._elapsed(tile, dev) for _ in range(3))
    want = want.cpu().numpy().view(np.uint32)
    print("segment_tile on card 0: %d segments, %.4f s warm"
          % (want.max(), secs))

    clusters = smoke.tile_clusters(img, km, dev).cpu().numpy()
    ref, nxt = clump.clump(clusters, 0, True, device="cuda")
    for what in ("clump_sharded", "segment_image_sharded"):
        for _ in range(2):   # the second call is warm on every card
            smoke.reset_sharded_counts()
            t0 = time.time()
            if what == "clump_sharded":
                got, num = shardmap_clump.clump_sharded(clusters, 0, True,
                                                        mesh=devices)
                ok = np.array_equal(got, ref) and num == nxt - 1
            else:
                got, num = shardmap_seg.segment_image_sharded(
                    img, centers, maxSpectralDiff=maxdiff,
                    minSegmentSize=50, fourConnected=True, mesh=devices)
                ok = np.array_equal(got, want) and num == want.max()
            wall = time.time() - t0
            if not ok:
                raise AssertionError("%s over %d cards differs from the "
                                     "single-card result"
                                     % (what, len(devices)))
            print("%s over %d cards: equal bit for bit, %d ids, %d sweeps, "
                  "%d halo rows copied, %d host syncs, launches %s, wall "
                  "%.3f s" % (what, len(devices), num,
                              shardmap_clump._clump_sharded.sweeps,
                              shardmap_clump.exchange_rows.rows,
                              to_host.syncs, smoke.read_counts(), wall))


def mesh_scene(tmp, ncards):
    h = w = 8000
    inpath, km = smoke.scene_file(tmp, h, w, 4000)
    first = None
    for name, cfg in [
            ("CONC_NONE", tiling.SegmentationConcurrencyConfig(
                deviceSceneCache=True)),
            ("CONC_MESH tpd 1", tiling.SegmentationConcurrencyConfig(
                concurrencyType=tiling.CONC_MESH, tilesPerDevice=1)),
            ("CONC_MESH tpd 2", tiling.SegmentationConcurrencyConfig(
                concurrencyType=tiling.CONC_MESH, tilesPerDevice=2)),
            ("CONC_NONE again", tiling.SegmentationConcurrencyConfig(
                deviceSceneCache=True)),
            ("CONC_MESH tpd 1 again", tiling.SegmentationConcurrencyConfig(
                concurrencyType=tiling.CONC_MESH, tilesPerDevice=1))]:
        out = os.path.join(tmp, "out.npseg")
        res, launches = smoke.tiled_run(
            "%s, %d cards" % (name, ncards), inpath, out, km, cfg, h * w)
        seg, hist = smoke.read_seg(out)
        smoke.check_mosaic(seg, hist, res.maxSegId, res.hasEmptySegments,
                           h * w, name)
        if first is None:
            first = (seg, hist)
        elif not (np.array_equal(seg, first[0]) and
                  np.array_equal(hist, first[1])):
            raise AssertionError("%s differs from CONC_NONE at %d pixels"
                                 % (name, (seg != first[0]).sum()))
        if launches["local_ccl"] != 9:
            raise AssertionError("%s: K1 launched %d times"
                                 % (name, launches["local_ccl"]))
    print("scene8000: CONC_MESH over %d cards == CONC_NONE bit for bit"
          % ncards)


def main():
    ncards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if ncards < 2:
        raise SystemExit("torch_multicard: needs two CUDA cards, found %d"
                         % ncards)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    smoke.phase_build()
    devices = ["cuda:%d" % i for i in range(ncards)]
    sharded_tile(devices)
    with tempfile.TemporaryDirectory() as tmp:
        mesh_scene(tmp, ncards)
    print("ok")


if __name__ == "__main__":
    main()
