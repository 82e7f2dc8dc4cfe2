"""
Host-side raster / RAT I/O (counterpart: pyshepseg_tpu/io).

All raster access goes through a small driver abstraction (:mod:`.raster`)
with two backends:

- a GDAL pass-through (used when ``osgeo`` is importable), so real
  KEA/GTiff workflows behave exactly like the reference;
- a pure-numpy directory format (``.npseg``), memmap-backed for windowed
  reads/writes, so the full pipeline (including RATs, overviews, colour
  tables and metadata) runs and is testable without GDAL.

The code is written against the GDAL method names (ReadAsArray,
WriteArray, GetDefaultRAT, ...), so objects from either backend are
interchangeable. The ``.npseg`` format is the JAX package's, so either
package reads what the other writes.
"""

from .raster import (  # noqa: F401
    open, create, createCopyStructure, isNumpyDriverPath,
    GDT_Byte, GDT_UInt16, GDT_Int16, GDT_UInt32, GDT_Int32,
    GDT_Float32, GDT_Float64,
    GFT_Integer, GFT_Real, GFT_String,
    GFU_Generic, GFU_PixelCount, GFU_Name, GFU_Red, GFU_Green, GFU_Blue,
    GFU_Alpha,
    GA_ReadOnly, GA_Update,
    gdalTypeFromNumpy, numpyTypeFromGdal, HAVE_GDAL)
