"""
Multi-device and multi-host execution backends
(counterpart: pyshepseg_tpu/parallel).

The tiled driver scales over overlapping tiles with thread, subprocess and
Fargate workers (tiling.py's CONC_* managers). This package adds the
multi-device axis, for a list of ``torch.device``s driven by one process:

- :mod:`.pipeline`: the device-resident segmentation of one tile, and the
  three-step decomposition of a batch
- :mod:`.mesh`: chunks of tiles dealt to the devices of the list, one
  host thread per distinct device, registered as the CONC_MESH
  concurrency backend
- :mod:`.shardmap_clump`, :mod:`.shardmap_seg`: ONE image with its rows
  sharded over the list, halo rows exchanged between neighbouring stripes
- :mod:`.dcn`: multi-host execution, one process per host: control plane
  over a ``torch.distributed.TCPStore``, per-host tile shards on the local
  devices, stitch on process 0

A device list may name one device more than once (``["cuda:0"] * 4``):
every exchange between stripes or shares then still runs, on one card.
"""

from .mesh import SegMeshMgr  # noqa: F401  (registers CONC_MESH subclass)
