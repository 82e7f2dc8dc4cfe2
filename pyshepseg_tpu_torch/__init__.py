"""
pyshepseg_tpu_torch — the PyTorch + CUDA counterpart of :mod:`pyshepseg_tpu`.

It keeps the JAX package's module names and public names, so each function
here has its counterpart at the same path under ``pyshepseg_tpu`` (for
example ``pyshepseg_tpu_torch.ops.clump.clump_labels`` and
``pyshepseg_tpu.ops.clump.clump_labels``). Plain tensor code is PyTorch; the
two Pallas kernels of the JAX package are CUDA C++ kernels for Hopper
(``csrc/``), built with ``nvcc`` at first use (see :mod:`._kernels`).

Covered: in-memory segmentation,
:func:`pyshepseg_tpu_torch.shepseg.doShepherdSegmentation`; the tiled
driver :func:`pyshepseg_tpu_torch.tiling.doTiledShepherdSegmentation` with
its stitch, the CONC_NONE / CONC_THREADS / CONC_SUBPROC / CONC_FARGATE
backends and the 3-phase API; the per-segment statistics engine
:mod:`.tilingstats` with its device run compaction (:mod:`.ops.segstats`)
and spatial box functions (:mod:`.ops.spatialstats`); :mod:`.subset`,
:mod:`.utils`, :mod:`.timinghooks`; the multi-device backends of
:mod:`.parallel` (the device-resident tile pipeline, CONC_MESH over a list
of devices, the row-sharded single image, and the multi-host DCN run); and
the ``run_seg``, ``tiling``, ``variograms``, ``subset``, ``runtests``,
segmentation-worker and DCN-worker command lines. Every public entry point that
computes takes an explicit ``device`` (default ``"cuda"``, which raises
when CUDA is absent); on a CPU device each kernel wrapper runs its plain
PyTorch version, and the stats engine's torch ops run on the CPU.

This package imports torch and numpy, never JAX nor the JAX package. Its
raster I/O (:mod:`.io`, the ``.npseg`` driver that both packages share)
and host flood fill and stitch loops (:mod:`.native`) are its own.
"""

SHEPSEG_TPU_TORCH_VERSION = "0.1.0"
__version__ = SHEPSEG_TPU_TORCH_VERSION
