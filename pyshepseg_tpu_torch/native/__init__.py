"""
Native (C++) host loops for order-dependent sequential operations
(counterpart: pyshepseg_tpu/native). ``ccl.cpp`` is compiled with g++ at
first use into ``build/pyshepseg_tpu_torch/`` beside the package (as the
CUDA kernels are, see :mod:`.._kernels`) and loaded through ctypes.

Public surface:

- ``available()`` — True when the shared library compiled and loaded.
- ``flood_fill_clump(img, ignoreVal, fourConnected, maxClumpSize, clumpId)``
  — reference-parity scan-order flood fill
  (reference: pyshepseg/shepseg.py:452-541 incl. the MAX_CLUMP_SIZE cap).
- ``subset_recode(tile, mask, lut, nextId, hist)`` — first-encounter dense
  recode (reference: pyshepseg/subset.py:367-424).
- ``stitch_mapping(tileData, mapping, recoded, start_id, top, bottom,
  left, right)`` — the per-tile stitch relabel's counting and id
  assignment (reference: pyshepseg/tiling.py:1231-1290); returns None
  when the library is unavailable and the caller runs its numpy path.
- ``stitch_relabel(...)`` — the same plus the relabelled tile (the
  stitcher itself gathers only the regions it consumes and calls
  ``stitch_mapping``).

All have fallbacks, so the package works without a compiler.
"""

import os
import ctypes
import threading
import subprocess

import numpy as np

from .._kernels import BUILD_DIR

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "ccl.cpp")
LIB_PATH = os.path.join(BUILD_DIR, "libpyshepseg_tpu_torch_native.so")

_lib = None
_build_error = None
_lock = threading.Lock()


def _build_and_load():
    """Compile ccl.cpp to LIB_PATH (when missing or older than the
    source) and dlopen it; None when that fails."""
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        try:
            if (not os.path.exists(LIB_PATH) or
                    os.path.getmtime(LIB_PATH) < os.path.getmtime(_SRC)):
                os.makedirs(BUILD_DIR, exist_ok=True)
                tmp = LIB_PATH + ".tmp%d" % os.getpid()
                subprocess.run(["g++", "-O3", "-shared", "-fPIC",
                                "-std=c++17", _SRC, "-o", tmp],
                               check=True, capture_output=True)
                os.replace(tmp, LIB_PATH)
            lib = ctypes.CDLL(LIB_PATH)
        except (OSError, subprocess.CalledProcessError) as e:
            _build_error = e
            return None

        lib.flood_fill_clump.restype = ctypes.c_uint32
        lib.flood_fill_clump.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint32), ctypes.c_uint32]
        lib.subset_recode.restype = ctypes.c_uint32
        lib.subset_recode.argtypes = [
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64, ctypes.POINTER(ctypes.c_uint32), ctypes.c_uint32,
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint32)]
        lib.stitch_mapping.restype = ctypes.c_uint32
        lib.stitch_mapping.argtypes = [
            ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64, ctypes.c_uint32,
            ctypes.POINTER(ctypes.c_uint32)]
        lib.stitch_relabel.restype = ctypes.c_uint32
        lib.stitch_relabel.argtypes = lib.stitch_mapping.argtypes + [
            ctypes.POINTER(ctypes.c_uint32)]
        _lib = lib
        return _lib


def available():
    """True when the native library is (or can be) built and loaded."""
    return _build_and_load() is not None


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def flood_fill_clump(img, ignoreVal, fourConnected=True, maxClumpSize=None,
                     clumpId=1):
    """
    Scan-order flood-fill clumping with the reference's clump-size cap
    semantics. Returns (seg uint32 (H, W), nextClumpId).
    """
    img = np.ascontiguousarray(img, dtype=np.int32)
    h, w = img.shape
    out = np.zeros((h, w), dtype=np.uint32)
    cap = -1 if maxClumpSize is None else int(maxClumpSize)
    lib = _build_and_load()
    if lib is not None:
        nxt = lib.flood_fill_clump(
            _ptr(img, ctypes.c_int32), h, w, int(ignoreVal),
            int(bool(fourConnected)), cap, _ptr(out, ctypes.c_uint32),
            int(clumpId))
        return out, int(nxt)
    return _flood_fill_py(img, int(ignoreVal), bool(fourConnected),
                          cap, int(clumpId), out)


def _flood_fill_py(img, ignoreVal, fourConnected, cap, clumpId, out):
    """Pure-Python fallback (slow; for compiler-less environments)."""
    h, w = img.shape
    capval = float("inf") if cap < 0 else cap
    for y in range(h):
        for x in range(w):
            if img[y, x] == ignoreVal or out[y, x] != 0:
                continue
            val = img[y, x]
            size = 0
            stack = [(y, x)]
            out[y, x] = clumpId
            while stack and size < capval:
                sy, sx = stack.pop()
                for cx in range(max(sx - 1, 0), min(sx + 1, w - 1) + 1):
                    for cy in range(max(sy - 1, 0), min(sy + 1, h - 1) + 1):
                        conn = not fourConnected or (cy == sy or cx == sx)
                        if (conn and img[cy, cx] != ignoreVal and
                                out[cy, cx] == 0 and img[cy, cx] == val):
                            out[cy, cx] = clumpId
                            size += 1
                            stack.append((cy, cx))
            clumpId += 1
    return out, clumpId


def _check_mapping(mapping):
    """The C side updates ``mapping`` in place through a raw pointer: any
    other layout would be silently reinterpreted, so reject it loudly."""
    if mapping.dtype != np.uint32 or not mapping.flags.c_contiguous:
        raise TypeError(
            "mapping must be a C-contiguous uint32 array (updated in "
            f"place by the native code); got {mapping.dtype}")


def stitch_mapping(tileData, mapping, recoded, start_id,
                   top, bottom, left, right):
    """
    Window count + ascending owned-id assignment into ``mapping`` (in
    place, uint32; see ccl.cpp). Returns ``(newMaxSegId, winCounts)`` —
    winCounts[id] is the old id's pixel count inside the trimmed window —
    or ``None`` when the native library is unavailable (the caller runs
    its numpy path).
    """
    lib = _build_and_load()
    if lib is None:
        return None
    _check_mapping(mapping)
    tileData = np.ascontiguousarray(tileData, dtype=np.uint32)
    recoded = np.ascontiguousarray(recoded, dtype=np.uint8)
    h, w = tileData.shape
    cnt = np.zeros(mapping.shape[0], dtype=np.uint32)
    newMax = lib.stitch_mapping(
        _ptr(tileData, ctypes.c_uint32), h, w,
        int(top), int(bottom), int(left), int(right),
        _ptr(mapping, ctypes.c_uint32), _ptr(recoded, ctypes.c_uint8),
        mapping.shape[0], int(start_id),
        _ptr(cnt, ctypes.c_uint32))
    return int(newMax), cnt


def stitch_relabel(tileData, mapping, recoded, start_id,
                   top, bottom, left, right):
    """
    :func:`stitch_mapping` plus the full-tile gather (see ccl.cpp).
    Returns ``(outTile, newMaxSegId, winCounts)``, ``outTile`` being
    ``mapping[tileData]`` after the update, or ``None`` when the native
    library is unavailable (the caller runs its numpy path).
    """
    lib = _build_and_load()
    if lib is None:
        return None
    _check_mapping(mapping)
    tileData = np.ascontiguousarray(tileData, dtype=np.uint32)
    recoded = np.ascontiguousarray(recoded, dtype=np.uint8)
    h, w = tileData.shape
    cnt = np.zeros(mapping.shape[0], dtype=np.uint32)
    out = np.empty_like(tileData)
    newMax = lib.stitch_relabel(
        _ptr(tileData, ctypes.c_uint32), h, w,
        int(top), int(bottom), int(left), int(right),
        _ptr(mapping, ctypes.c_uint32), _ptr(recoded, ctypes.c_uint8),
        mapping.shape[0], int(start_id),
        _ptr(cnt, ctypes.c_uint32), _ptr(out, ctypes.c_uint32))
    return out, int(newMax), cnt


def subset_recode(tile, mask, lut, nextId, hist):
    """
    First-encounter dense recode of one tile (scan order). ``lut`` (uint32,
    len maxOldId+1, 0 = unassigned) and ``hist`` (uint64 pixel counts by
    new id) are updated in place. Returns (outTile, nextId).
    """
    # updated in place through raw pointers: reject any other layout
    for arr, dtype in ((lut, np.uint32), (hist, np.uint64)):
        if arr.dtype != dtype or not arr.flags.c_contiguous:
            raise TypeError("lut and hist must be C-contiguous uint32 and "
                            f"uint64 arrays; got {lut.dtype}, {hist.dtype}")
    tile = np.ascontiguousarray(tile, dtype=np.uint32)
    out = np.empty_like(tile)
    n = tile.size
    lib = _build_and_load()
    if mask is not None:
        # Nonzero-ness in the ORIGINAL dtype — a plain uint8 cast would
        # wrap values like 256 to 0 and silently drop kept pixels
        mask = np.ascontiguousarray(np.asarray(mask) != 0, dtype=np.uint8)
    if lib is not None:
        maskp = (ctypes.POINTER(ctypes.c_uint8)() if mask is None else
                 _ptr(mask, ctypes.c_uint8))
        nxt = lib.subset_recode(
            _ptr(tile, ctypes.c_uint32), maskp, n,
            _ptr(lut, ctypes.c_uint32), int(nextId),
            _ptr(hist, ctypes.c_uint64), _ptr(out, ctypes.c_uint32))
        return out.reshape(tile.shape), int(nxt)
    # Python fallback
    flat = tile.ravel()
    outf = out.ravel()
    maskf = None if mask is None else mask.ravel()
    for i in range(n):
        v = flat[i]
        if v == 0 or (maskf is not None and maskf[i] == 0):
            outf[i] = 0
            continue
        nid = lut[v]
        if nid == 0:
            nid = nextId
            lut[v] = nid
            nextId += 1
        outf[i] = nid
        hist[nid] += 1
    return out.reshape(tile.shape), int(nextId)
