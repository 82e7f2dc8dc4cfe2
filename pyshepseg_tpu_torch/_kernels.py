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
              "-O3", "-Xcompiler", "-fPIC"]

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


def cuda_devices():
    """Every visible CUDA device, ``cuda:0 .. cuda:N-1``: the default of
    the multi-device entry points. Raises when there is none (the port
    never moves to the CPU by itself)."""
    if not torch.cuda.is_available():
        raise RuntimeError("no device list given and "
                           "torch.cuda.is_available() is False")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def device_list(mesh):
    """A ``mesh`` argument as a list of torch.devices: a sequence of
    devices (or their names; one may appear more than once), or None for
    :func:`cuda_devices`. A CUDA device without CUDA raises."""
    if mesh is None:
        return cuda_devices()
    devices = [torch_device(d) for d in mesh]
    if not devices:
        raise ValueError("an empty device list")
    return devices


def _nvcc():
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (looked on PATH and in %s)"
                           % cuda_home)
    return path


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _run(procs):
    """Wait for every (command, Popen) pair; raise on the first failure."""
    failed = None
    for cmd, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0 and failed is None:
            failed = "nvcc failed (%d): %s\n%s" % (
                proc.returncode, " ".join(cmd), err)
    if failed:
        raise RuntimeError(failed)


def build(force=False):
    """Compile ``csrc/*.cu`` into LIB_PATH if it is missing, older than a
    source, or ``force``: one nvcc per source, all started together, then
    one link. Returns the seconds spent (0.0 when up to date)."""
    srcs = _sources()
    deps = srcs + glob.glob(os.path.join(CSRC, "*.cuh"))
    if (not force and os.path.exists(LIB_PATH) and
            os.path.getmtime(LIB_PATH) >= max(map(os.path.getmtime, deps))):
        return 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = ".tmp%d" % os.getpid()
    objs = [os.path.join(BUILD_DIR, os.path.basename(src) + tag + ".o")
            for src in srcs]
    t0 = time.time()
    compiles = []
    for src, obj in zip(srcs, objs):
        cmd = [_nvcc()] + NVCC_FLAGS + ["-c", "-o", obj, src]
        compiles.append((cmd, subprocess.Popen(
            cmd, stderr=subprocess.PIPE, text=True)))
    _run(compiles)
    tmp = LIB_PATH + tag
    cmd = [_nvcc(), "-shared", "-o", tmp] + objs
    _run([(cmd, subprocess.Popen(cmd, stderr=subprocess.PIPE, text=True))])
    for obj in objs:
        os.remove(obj)
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
            handle.local_ccl_occupancy.restype = i32
            ip = ctypes.POINTER(i32)
            handle.local_ccl_occupancy.argtypes = [i32, i32, i32, ip, ip]
            handle.lut_gather_launch.restype = i32
            handle.lut_gather_launch.argtypes = [
                vp, i32, vp, i32, vp, i64, i64, i32, i32, vp]
            handle.lut_gather_smem_limit.restype = i32
            handle.lut_gather_smem_limit.argtypes = [i32]
            _lib = handle
    return _lib


def check(code, name):
    """Raise when a launch returned a CUDA error code."""
    if code != 0:
        raise RuntimeError("%s launch failed: CUDA error %d" % (name, code))


def count(fn, attr="launches", n=1):
    """Add ``n`` (one by default) to the counter ``fn.<attr>``. Under a
    lock: the tiled driver's worker threads launch kernels concurrently,
    and a bare ``+= 1`` could lose an update."""
    with _count_lock:
        setattr(fn, attr, getattr(fn, attr) + n)


def stream_ptr(t):
    """The raw handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream
