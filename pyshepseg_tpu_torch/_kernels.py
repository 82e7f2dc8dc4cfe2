"""
Build and load the CUDA kernels of ``csrc/``.

The sources are compiled at first use with ``nvcc`` for Hopper
(``sm_90a``) into one shared library with a plain C interface under
``build/pyshepseg_tpu_torch/`` beside the package, and loaded with ctypes
(the same pattern as pyshepseg_tpu/native/__init__.py uses for g++). The
library is rebuilt when a source is newer than it. A failed build raises:
no caller may go on with a plain version on a CUDA tensor.

Each C entry point launches on the stream it is given (PyTorch's current
stream), allocates nothing, and returns ``cudaGetLastError()`` after the
launch; :func:`check` turns a non-zero code into an exception.
"""

import ctypes
import glob
import os
import shutil
import subprocess
import threading
import time

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "build",
                         "pyshepseg_tpu_torch")
LIB_PATH = os.path.join(BUILD_DIR, "libpyshepseg_tpu_torch_kernels.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_lib = None
_lock = threading.Lock()
_count_lock = threading.Lock()


def torch_device(device):
    """``device`` as a torch.device; raises when CUDA is asked for and
    absent (the port never moves to the CPU by itself)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device %r requested but torch.cuda.is_available()"
                           " is False" % str(device))
    return device


def _nvcc():
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (looked on PATH and in %s)"
                           % cuda_home)
    return path


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def build(force=False):
    """Compile ``csrc/*.cu`` into LIB_PATH if it is missing, older than a
    source, or ``force``. Returns the seconds spent (0.0 when up to date)."""
    srcs = _sources()
    deps = srcs + glob.glob(os.path.join(CSRC, "*.cuh"))
    if (not force and os.path.exists(LIB_PATH) and
            os.path.getmtime(LIB_PATH) >= max(map(os.path.getmtime, deps))):
        return 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = LIB_PATH + ".tmp%d" % os.getpid()
    cmd = [_nvcc()] + NVCC_FLAGS + ["-o", tmp] + srcs
    t0 = time.time()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed (%d): %s\n%s" % (
            proc.returncode, " ".join(cmd), proc.stderr))
    os.replace(tmp, LIB_PATH)
    return time.time() - t0


def lib():
    """The loaded kernel library (built first if needed)."""
    global _lib
    with _lock:
        if _lib is None:
            build()
            handle = ctypes.CDLL(LIB_PATH)
            vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
            handle.local_ccl_launch.restype = i32
            handle.local_ccl_launch.argtypes = [
                vp, vp, i32, i32, i32, i32, i32, i32, vp]
            handle.lut_gather_launch.restype = i32
            handle.lut_gather_launch.argtypes = [vp, vp, vp, i64, i32, vp]
            _lib = handle
    return _lib


def check(code, name):
    """Raise when a launch returned a CUDA error code."""
    if code != 0:
        raise RuntimeError("%s launch failed: CUDA error %d" % (name, code))


def count(fn, attr="launches"):
    """Add one to the counter ``fn.<attr>``. Under a lock: the tiled
    driver's worker threads launch kernels concurrently, and a bare
    ``+= 1`` could lose an update."""
    with _count_lock:
        setattr(fn, attr, getattr(fn, attr) + 1)


def stream_ptr(t):
    """The raw handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream
