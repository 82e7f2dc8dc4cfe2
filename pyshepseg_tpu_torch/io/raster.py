"""
Raster driver abstraction: GDAL pass-through + pure-numpy ``.npseg`` format
(counterpart: pyshepseg_tpu/io/raster.py, the same driver and file format,
kept in the port so that it never loads the JAX package).

The numpy format stores a raster as a directory:

- ``meta.json`` — sizes, dtype, geotransform, projection, per-band nodata,
  metadata dicts
- ``band_<i>.npy`` — one memmap-able array per band (windowed access)
- ``rat_<i>/`` — raster attribute table: ``schema.json`` + one ``.npy``
  per column
- ``ovr_<i>_<level>.npy`` — overview arrays

The class surfaces mirror the slice of the GDAL API the framework uses, so
GDAL Dataset/Band/RAT objects and these classes are interchangeable.
"""

import os
import io
import json
import shutil
import builtins

import numpy as np

try:
    from osgeo import gdal
    gdal.UseExceptions()
    HAVE_GDAL = True
except ImportError:
    gdal = None
    HAVE_GDAL = False

# ------------------------------------------------------------------ enums
# Numeric values identical to GDAL's so the two backends interoperate.
GDT_Byte = 1
GDT_UInt16 = 2
GDT_Int16 = 3
GDT_UInt32 = 4
GDT_Int32 = 5
GDT_Float32 = 6
GDT_Float64 = 7

GFT_Integer = 0
GFT_Real = 1
GFT_String = 2

GFU_Generic = 0
GFU_PixelCount = 1
GFU_Name = 2
GFU_Red = 6
GFU_Green = 7
GFU_Blue = 8
GFU_Alpha = 9

GA_ReadOnly = 0
GA_Update = 1

_NP_TO_GDT = {
    np.dtype(np.uint8): GDT_Byte,
    np.dtype(np.uint16): GDT_UInt16,
    np.dtype(np.int16): GDT_Int16,
    np.dtype(np.uint32): GDT_UInt32,
    np.dtype(np.int32): GDT_Int32,
    np.dtype(np.float32): GDT_Float32,
    np.dtype(np.float64): GDT_Float64,
}


def gdalTypeFromNumpy(dtype):
    return _NP_TO_GDT[np.dtype(dtype)]


NUMPY_DRIVER_EXT = ".npseg"


def isNumpyDriverPath(path):
    """True if the path should be handled by the numpy directory driver."""
    if not isinstance(path, str):
        return False
    return (path.endswith(NUMPY_DRIVER_EXT) or
            os.path.isfile(os.path.join(path, "meta.json")))


# ----------------------------------------------------------- numpy driver


class NumpyRAT:
    """Raster attribute table stored as per-column .npy files."""

    _GFT_DTYPE = {GFT_Integer: np.int64, GFT_Real: np.float64,
                  GFT_String: object}

    def __init__(self, path):
        self.path = path
        self.schema_path = os.path.join(path, "schema.json")
        if os.path.exists(self.schema_path):
            with builtins.open(self.schema_path) as f:
                s = json.load(f)
            self._names = s["names"]
            self._types = s["types"]
            self._usages = s["usages"]
            self._rowcount = s["rowcount"]
        else:
            os.makedirs(path, exist_ok=True)
            self._names, self._types, self._usages = [], [], []
            self._rowcount = 0
            self._save_schema()
        self._cols = {}
        for i, name in enumerate(self._names):
            self._cols[i] = self._load_col(i)

    def _save_schema(self):
        with builtins.open(self.schema_path, "w") as f:
            json.dump({"names": self._names, "types": self._types,
                       "usages": self._usages,
                       "rowcount": self._rowcount}, f)

    def _col_path(self, i):
        return os.path.join(self.path, f"col_{i}.npy")

    def _load_col(self, i):
        p = self._col_path(i)
        if os.path.exists(p):
            arr = np.load(p, allow_pickle=(self._types[i] == GFT_String))
            return arr
        return np.zeros(self._rowcount,
                        dtype=self._GFT_DTYPE[self._types[i]])

    def _flush_col(self, i):
        np.save(self._col_path(i), self._cols[i])

    def _reset(self):
        """Drop all columns and rows (SetDefaultRAT REPLACES the table,
        as GDAL's does)."""
        for i in range(len(self._names)):
            p = self._col_path(i)
            if os.path.exists(p):
                os.remove(p)
        self._names, self._types, self._usages = [], [], []
        self._rowcount = 0
        self._cols = {}
        self._save_schema()

    # --- GDAL-compatible surface
    def GetColumnCount(self):
        return len(self._names)

    def GetRowCount(self):
        return self._rowcount

    def SetRowCount(self, n):
        n = int(n)
        for i in list(self._cols):
            col = self._cols[i]
            if len(col) < n:
                pad = np.zeros(n - len(col), dtype=col.dtype)
                self._cols[i] = np.concatenate([col, pad])
            elif len(col) > n:
                self._cols[i] = col[:n]
            self._flush_col(i)
        self._rowcount = n
        self._save_schema()

    def GetNameOfCol(self, i):
        return self._names[i]

    def GetTypeOfCol(self, i):
        return self._types[i]

    def GetUsageOfCol(self, i):
        return self._usages[i]

    def GetColOfUsage(self, usage):
        for i, u in enumerate(self._usages):
            if u == usage:
                return i
        return -1

    def CreateColumn(self, name, coltype, usage):
        self._names.append(name)
        self._types.append(int(coltype))
        self._usages.append(int(usage))
        i = len(self._names) - 1
        self._cols[i] = np.zeros(self._rowcount,
                                 dtype=self._GFT_DTYPE[int(coltype)])
        self._flush_col(i)
        self._save_schema()
        return 0

    def WriteArray(self, arr, colNum, start=0):
        arr = np.asarray(arr)
        end = start + len(arr)
        col = self._cols[colNum]
        if end > len(col):
            grow = np.zeros(end - len(col), dtype=col.dtype)
            col = np.concatenate([col, grow])
        col[start:end] = arr
        self._cols[colNum] = col
        self._rowcount = max(self._rowcount, end)
        for i in list(self._cols):
            c = self._cols[i]
            if len(c) < self._rowcount:
                self._cols[i] = np.concatenate(
                    [c, np.zeros(self._rowcount - len(c), dtype=c.dtype)])
                self._flush_col(i)
        self._flush_col(colNum)
        self._save_schema()

    def ReadAsArray(self, colNum, start=0, length=None):
        col = self._cols[colNum]
        if length is None:
            length = len(col) - start
        return np.array(col[start:start + length])


class NumpyBand:
    """One raster band backed by a memmap-able .npy file."""

    def __init__(self, ds, idx):
        self._ds = ds
        self._idx = idx  # 1-based, like GDAL

    @property
    def _meta(self):
        return self._ds._meta

    @property
    def _bandmeta(self):
        return self._ds._meta["bands"][self._idx - 1]

    @property
    def DataType(self):
        return gdalTypeFromNumpy(self._ds._dtype)

    @property
    def XSize(self):
        return self._ds.RasterXSize

    @property
    def YSize(self):
        return self._ds.RasterYSize

    def _mmap(self, mode=None):
        if mode is None:
            mode = "r+" if self._ds._update else "r"
        path = self._ds._band_path(self._idx)
        return self._ds._cachedMmap(path, mode)

    def ReadAsArray(self, xoff=0, yoff=0, win_xsize=None, win_ysize=None):
        m = self._mmap(mode="r")
        if win_xsize is None:
            win_xsize = self._ds.RasterXSize - xoff
        if win_ysize is None:
            win_ysize = self._ds.RasterYSize - yoff
        return np.array(m[yoff:yoff + win_ysize, xoff:xoff + win_xsize])

    def WriteArray(self, arr, xoff=0, yoff=0):
        m = self._mmap()
        m[yoff:yoff + arr.shape[0], xoff:xoff + arr.shape[1]] = arr
        return 0

    def SetNoDataValue(self, val):
        self._bandmeta["nodata"] = None if val is None else float(val)
        self._ds._save_meta()

    def GetNoDataValue(self):
        return self._bandmeta["nodata"]

    def SetMetadataItem(self, key, value):
        self._bandmeta["metadata"][key] = str(value)
        self._ds._save_meta()

    def GetMetadataItem(self, key):
        return self._bandmeta["metadata"].get(key)

    def GetMetadata(self):
        return dict(self._bandmeta["metadata"])

    def GetDefaultRAT(self):
        path = os.path.join(self._ds._path, f"rat_{self._idx}")
        return NumpyRAT(path)

    def SetDefaultRAT(self, rat):
        # RATs are written in place through GetDefaultRAT; only needed for
        # GDAL interop where a standalone RAT object is attached.
        if isinstance(rat, NumpyRAT) and rat.path == os.path.join(
                self._ds._path, f"rat_{self._idx}"):
            return 0
        mine = self.GetDefaultRAT()
        # GDAL's SetDefaultRAT replaces the existing table; appending
        # would duplicate column names on a second call and name lookups
        # would keep returning the stale originals
        mine._reset()
        mine.SetRowCount(rat.GetRowCount())
        for i in range(rat.GetColumnCount()):
            mine.CreateColumn(rat.GetNameOfCol(i), rat.GetTypeOfCol(i),
                              rat.GetUsageOfCol(i))
            mine.WriteArray(rat.ReadAsArray(i), mine.GetColumnCount() - 1)
        return 0

    # --- overviews
    def GetOverviewCount(self):
        return len(self._bandmeta["overviews"])

    def GetOverview(self, i):
        level = self._bandmeta["overviews"][i]
        return NumpyOverviewBand(self._ds, self._idx, level)

    def ComputeStatistics(self, approx_ok):
        m = self._mmap(mode="r")
        nodata = self.GetNoDataValue()
        data = np.asarray(m)
        if nodata is not None:
            data = data[data != nodata]
        if data.size == 0:
            return [0.0, 0.0, 0.0, 0.0]
        stats = [float(data.min()), float(data.max()),
                 float(data.mean()), float(data.std())]
        self.SetMetadataItem("STATISTICS_MINIMUM", repr(stats[0]))
        self.SetMetadataItem("STATISTICS_MAXIMUM", repr(stats[1]))
        self.SetMetadataItem("STATISTICS_MEAN", repr(stats[2]))
        self.SetMetadataItem("STATISTICS_STDDEV", repr(stats[3]))
        return stats


class NumpyOverviewBand:
    """A single overview level of a band (subsampled array)."""

    def __init__(self, ds, band_idx, level):
        self._ds = ds
        self._band_idx = band_idx
        self._level = level

    def _path(self):
        return os.path.join(self._ds._path,
                            f"ovr_{self._band_idx}_{self._level}.npy")

    @property
    def XSize(self):
        return self._ds._cachedMmap(self._path(), mode="r").shape[1]

    @property
    def YSize(self):
        return self._ds._cachedMmap(self._path(), mode="r").shape[0]

    def ReadAsArray(self, xoff=0, yoff=0, win_xsize=None, win_ysize=None):
        m = self._ds._cachedMmap(self._path(), mode="r")
        if win_xsize is None:
            win_xsize = m.shape[1] - xoff
        if win_ysize is None:
            win_ysize = m.shape[0] - yoff
        return np.array(m[yoff:yoff + win_ysize, xoff:xoff + win_xsize])

    def WriteArray(self, arr, xoff=0, yoff=0):
        m = self._ds._cachedMmap(self._path(), mode="r+")
        m[yoff:yoff + arr.shape[0], xoff:xoff + arr.shape[1]] = arr
        return 0


class NumpyDataset:
    """Directory-backed raster dataset with a GDAL-like surface."""

    def __init__(self, path, update=False):
        self._path = path
        self._update = update
        with builtins.open(os.path.join(path, "meta.json")) as f:
            self._meta = json.load(f)
        self._dtype = np.dtype(self._meta["dtype"])
        # (file path, mode) -> live memmap. Opening a fresh memmap per
        # window access costs an open+header parse, and msync'ing after
        # every window write costs a full-file writeback (the stitcher
        # writes 64+ windows into a multi-hundred-MB band: per-write
        # flush() was ~60% of its host time). Same-host readers see the
        # writes through the shared page cache without msync; dirty
        # pages reach disk on FlushCache()/close/GC in any case.
        self._mmaps = {}

    def _cachedMmap(self, path, mode):
        key = (path, mode)
        m = self._mmaps.get(key)
        if m is None:
            m = np.lib.format.open_memmap(path, mode=mode)
            self._mmaps[key] = m
        return m

    def _dropMmap(self, path):
        """Forget cached maps of a file about to be re-created."""
        for key in [k for k in self._mmaps if k[0] == path]:
            del self._mmaps[key]

    # --- creation
    @classmethod
    def create(cls, path, xsize, ysize, nbands, dtype):
        if os.path.exists(path):
            shutil.rmtree(path)
        os.makedirs(path)
        dtype = np.dtype(dtype)
        meta = {
            "xsize": int(xsize), "ysize": int(ysize), "nbands": int(nbands),
            "dtype": dtype.name,
            "geotransform": None, "projection": "",
            "metadata": {},
            "bands": [{"nodata": None, "metadata": {}, "overviews": []}
                      for _ in range(nbands)],
        }
        with builtins.open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta, f)
        for i in range(1, nbands + 1):
            m = np.lib.format.open_memmap(
                os.path.join(path, f"band_{i}.npy"), mode="w+",
                dtype=dtype, shape=(int(ysize), int(xsize)))
            del m
        return cls(path, update=True)

    def _band_path(self, i):
        return os.path.join(self._path, f"band_{i}.npy")

    def _save_meta(self):
        if not self._update:
            raise IOError("dataset opened read-only")
        with builtins.open(os.path.join(self._path, "meta.json"), "w") as f:
            json.dump(self._meta, f)

    # --- GDAL-compatible surface
    @property
    def RasterXSize(self):
        return self._meta["xsize"]

    @property
    def RasterYSize(self):
        return self._meta["ysize"]

    @property
    def RasterCount(self):
        return self._meta["nbands"]

    def GetRasterBand(self, i):
        if not (1 <= i <= self.RasterCount):
            raise ValueError(f"band {i} out of range")
        return NumpyBand(self, i)

    def GetGeoTransform(self):
        gt = self._meta["geotransform"]
        return None if gt is None else tuple(gt)

    def SetGeoTransform(self, gt):
        self._meta["geotransform"] = list(gt)
        self._save_meta()

    def GetProjection(self):
        return self._meta["projection"]

    def SetProjection(self, proj):
        self._meta["projection"] = proj or ""
        self._save_meta()

    def SetMetadataItem(self, key, value):
        self._meta["metadata"][key] = str(value)
        self._save_meta()

    def GetMetadataItem(self, key):
        return self._meta["metadata"].get(key)

    def BuildOverviews(self, method, levels):
        """Allocate overview arrays (optionally filled by subsampling)."""
        for bi in range(1, self.RasterCount + 1):
            band = self.GetRasterBand(bi)
            bm = self._meta["bands"][bi - 1]
            for level in levels:
                if level in bm["overviews"]:
                    continue
                oy = max(1, self.RasterYSize // level)
                ox = max(1, self.RasterXSize // level)
                ovrPath = os.path.join(self._path, f"ovr_{bi}_{level}.npy")
                self._dropMmap(ovrPath)  # file is being re-created
                m = np.lib.format.open_memmap(
                    ovrPath, mode="w+", dtype=self._dtype, shape=(oy, ox))
                if method and method.upper().startswith("NEAREST"):
                    full = band._mmap(mode="r")
                    o = level // 2
                    # clamped index grids: for ordinary levels these are
                    # exactly full[o::level, o::level][:oy, :ox]; for a
                    # level >= 2x the raster dimension that slice is
                    # EMPTY and broadcasting into (oy, ox) would raise —
                    # clamp to the last pixel instead (GDAL accepts such
                    # levels)
                    yi = np.minimum(o + np.arange(oy) * level,
                                    self.RasterYSize - 1)
                    xi = np.minimum(o + np.arange(ox) * level,
                                    self.RasterXSize - 1)
                    m[...] = full[np.ix_(yi, xi)]
                del m
                bm["overviews"].append(level)
        self._save_meta()
        return 0

    def FlushCache(self):
        for (path, mode), m in self._mmaps.items():
            if mode != "r":
                m.flush()
        return 0


# ------------------------------------------------------------- public API


def open(path, access=GA_ReadOnly):
    """Open a raster with the appropriate backend."""
    if isinstance(path, (NumpyDataset,)):
        return path
    if gdal is not None and isinstance(path, gdal.Dataset):
        return path
    if isNumpyDriverPath(path):
        return NumpyDataset(path, update=(access == GA_Update))
    if not HAVE_GDAL:
        raise IOError(
            f"GDAL not available and '{path}' is not a numpy-driver "
            f"({NUMPY_DRIVER_EXT}) dataset")
    return gdal.Open(path, gdal.GA_Update if access == GA_Update
                     else gdal.GA_ReadOnly)


def create(path, xsize, ysize, nbands, dtype, driverName=None,
           creationOptions=None):
    """Create a raster with the appropriate backend. dtype is numpy."""
    if isNumpyDriverPath(path) or (driverName is None and not HAVE_GDAL) \
            or driverName == "NPSEG":
        return NumpyDataset.create(path, xsize, ysize, nbands, dtype)
    if not HAVE_GDAL:
        raise IOError("GDAL not available; use a .npseg path")
    drvr = gdal.GetDriverByName(driverName or "KEA")
    if drvr is None:
        raise IOError(f"GDAL driver {driverName} not available")
    return drvr.Create(path, xsize, ysize, nbands,
                       gdalTypeFromNumpy(dtype),
                       creationOptions or [])

