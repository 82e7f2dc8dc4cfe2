"""
pyshepseg_tpu_torch — the PyTorch + CUDA counterpart of :mod:`pyshepseg_tpu`.

It keeps the JAX package's module names and public names, so each function
here has its counterpart at the same path under ``pyshepseg_tpu`` (for
example ``pyshepseg_tpu_torch.ops.clump.clump_labels`` and
``pyshepseg_tpu.ops.clump.clump_labels``). Plain tensor code is PyTorch; the
two Pallas kernels of the JAX package are CUDA C++ kernels for Hopper
(``csrc/``), built with ``nvcc`` at first use (see :mod:`._kernels`).

Covered so far: in-memory segmentation,
:func:`pyshepseg_tpu_torch.shepseg.doShepherdSegmentation`. Every public
entry point takes an explicit ``device`` (default ``"cuda"``, which raises
when CUDA is absent); on a CPU device each kernel wrapper runs its plain
PyTorch version.

This package imports torch and numpy only, never JAX.
"""

SHEPSEG_TPU_TORCH_VERSION = "0.1.0"
__version__ = SHEPSEG_TPU_TORCH_VERSION
