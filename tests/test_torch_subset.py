"""The port's subset against the JAX package's on the same files made
from a seed: ``subsetImage``'s raster and every RAT column (int and
float, the Histogram and the orig-id column) must be equal bit for bit,
over one stats tile and several, one RAT page and several, on the native
recode and on the numpy one; the errors must be the same."""

import numpy as np
import pytest

from pyshepseg_tpu import subset as jax_subset
from pyshepseg_tpu import tiling as jax_tiling
from pyshepseg_tpu import tilingstats as jax_tilingstats
from pyshepseg_tpu_torch import io as rio, native, subset, tiling
from pyshepseg_tpu_torch import tilingstats
import torch_parity  # noqa: F401  (one torch thread)


def write_seg(path, seg, nrows=None):
    """A segmentation raster with a Histogram, an int and a float RAT
    column of ``nrows`` rows (default: one per id)."""
    h, w = seg.shape
    nrows = int(seg.max()) + 1 if nrows is None else nrows
    ds = rio.create(path, w, h, 1, np.uint32)
    ds.SetGeoTransform((1000.0, 5.0, 0.0, 2000.0, 0.0, -5.0))
    ds.GetRasterBand(1).WriteArray(seg)
    rat = ds.GetRasterBand(1).GetDefaultRAT()
    hist = np.bincount(seg.ravel(), minlength=nrows)[:nrows].astype(
        np.float64)
    hist[0] = 0
    rat.CreateColumn("Histogram", rio.GFT_Real, rio.GFU_PixelCount)
    rat.WriteArray(hist, 0)
    rat.CreateColumn("code", rio.GFT_Integer, rio.GFU_Generic)
    rat.WriteArray(np.arange(nrows) * 7, 1)
    rat.CreateColumn("score", rio.GFT_Real, rio.GFU_Generic)
    rat.WriteArray(np.arange(nrows) * 1.5, 2)
    ds.FlushCache()


@pytest.fixture
def seg_path(tmp_path, rng):
    """tests/test_subset.py's raster: 90 x 110 Voronoi cells of 30
    segments, a null strip, RAT columns with known per-segment data."""
    h, w, nseg = 90, 110, 30
    centres = rng.uniform(0, [h, w], size=(nseg, 2))
    yy, xx = np.mgrid[0:h, 0:w]
    d = ((yy[..., None] - centres[:, 0]) ** 2 +
         (xx[..., None] - centres[:, 1]) ** 2)
    seg = (d.argmin(axis=-1) + 1).astype(np.uint32)
    seg[:2, :] = 0
    path = str(tmp_path / "seg.npseg")
    write_seg(path, seg)
    return path


def read_all(path):
    """(raster, {column: values}, geotransform) of a subset output."""
    ds = rio.open(path)
    band = ds.GetRasterBand(1)
    rat = band.GetDefaultRAT()
    cols = {rat.GetNameOfCol(i): rat.ReadAsArray(i)
            for i in range(rat.GetColumnCount())}
    return band.ReadAsArray(), cols, ds.GetGeoTransform()


def assert_same_output(got, want):
    seg, cols, gt = read_all(got)
    wseg, wcols, wgt = read_all(want)
    np.testing.assert_array_equal(seg, wseg)
    assert seg.dtype == wseg.dtype
    assert list(cols) == list(wcols)
    for name in cols:
        np.testing.assert_array_equal(cols[name], wcols[name], err_msg=name)
        assert cols[name].dtype == wcols[name].dtype, name
    assert tuple(gt) == tuple(wgt)
    return seg, cols


def small_pages(monkeypatch, tile, page):
    """The same stats-tile and RAT-page sizes in both packages."""
    for mod in (tiling, jax_tiling):
        monkeypatch.setattr(mod, "TILESIZE", tile)
    for mod in (tilingstats, jax_tilingstats):
        monkeypatch.setattr(mod, "RAT_PAGE_SIZE", page)


def numpy_route(monkeypatch):
    monkeypatch.setattr(native, "available", lambda: False)


@pytest.mark.parametrize("route", ["native", "numpy"])
@pytest.mark.parametrize("tile,page", [(1024, 100000), (32, 100000),
                                       (32, 7)])
def test_subset_matches_jax(tmp_path, seg_path, monkeypatch, route, tile,
                            page):
    """First-encounter recode over tiles, every RAT column, the
    Histogram and the orig-id column, on either recode route."""
    small_pages(monkeypatch, tile, page)
    if route == "numpy":
        numpy_route(monkeypatch)
    else:
        assert native.available()
    got, want = str(tmp_path / "got.npseg"), str(tmp_path / "want.npseg")
    args = (20, 10, 60, 50, None)
    subset.subsetImage(seg_path, got, *args, origSegIdColName="orig")
    jax_subset.subsetImage(seg_path, want, *args, origSegIdColName="orig")
    seg, cols = assert_same_output(got, want)
    used = np.unique(seg[seg > 0])
    np.testing.assert_array_equal(used, np.arange(1, len(used) + 1))
    full = rio.open(seg_path).GetRasterBand(1).ReadAsArray()
    np.testing.assert_array_equal(cols["orig"][seg], full[10:60, 20:80])
    assert set(cols) == {"Histogram", "code", "score", "orig"}


def test_native_route_equals_numpy_route(tmp_path, seg_path, monkeypatch):
    monkeypatch.setattr(tiling, "TILESIZE", 32)
    args = (5, 3, 100, 80, None)
    nat, nump = str(tmp_path / "n.npseg"), str(tmp_path / "p.npseg")
    subset.subsetImage(seg_path, nat, *args, origSegIdColName="orig")
    numpy_route(monkeypatch)
    subset.subsetImage(seg_path, nump, *args, origSegIdColName="orig")
    assert_same_output(nat, nump)


@pytest.mark.parametrize("route", ["native", "numpy"])
def test_subset_mask_matches_jax(tmp_path, seg_path, rng, monkeypatch,
                                 route):
    if route == "numpy":
        numpy_route(monkeypatch)
    tlx, tly, xs, ys = 10, 10, 40, 40
    maskpath = str(tmp_path / "mask.npseg")
    # values that a uint8 cast would wrap to 0 must still keep a pixel
    mask = (rng.random((ys, xs)) < 0.6).astype(np.uint16) * 256
    mds = rio.create(maskpath, xs, ys, 1, np.uint16)
    mds.GetRasterBand(1).WriteArray(mask)
    mds.FlushCache()
    got, want = str(tmp_path / "got.npseg"), str(tmp_path / "want.npseg")
    subset.subsetImage(seg_path, got, tlx, tly, xs, ys, None,
                       maskImage=maskpath)
    jax_subset.subsetImage(seg_path, want, tlx, tly, xs, ys, None,
                           maskImage=maskpath)
    seg, _ = assert_same_output(got, want)
    assert (seg[mask == 0] == 0).all() and (seg[mask != 0] > 0).all()


@pytest.mark.parametrize("case", ["out of bounds", "empty window",
                                  "stale RAT", "mask shape"])
def test_subset_errors_match_jax(tmp_path, seg_path, case):
    """Both packages refuse the same requests."""
    path, window, kw = seg_path, (100, 100, 50, 50), {}
    if case == "empty window":
        window = (0, 0, 30, 2)     # the null strip
    elif case == "stale RAT":
        seg = rio.open(seg_path).GetRasterBand(1).ReadAsArray()
        path = str(tmp_path / "stale.npseg")
        write_seg(path, seg, nrows=20)   # ids up to 30
        window = (0, 0, 110, 90)
    elif case == "mask shape":
        kw["maskImage"] = str(tmp_path / "m.npseg")
        rio.create(kw["maskImage"], 5, 5, 1, np.uint8).FlushCache()
        window = (0, 0, 10, 10)
    for mod, out in ((subset, "got"), (jax_subset, "want")):
        with pytest.raises(mod.PyShepSegSubsetError):
            mod.subsetImage(path, str(tmp_path / (out + ".npseg")),
                            *window, None, **kw)


def test_dict_helpers_match_jax():
    """The reference-compatible dict -> array writers and the RAT page
    reader (tests/test_subset.py's cases) against the JAX package's."""
    for fn in ("setHistogramFromDictionary",
               "setSubsetRecodeFromDictionary"):
        for d in ({0: 5, 3: 7, 9: 2}, {42: 3, 77: 9}):
            got = np.zeros(100, dtype=np.int64)
            want = np.zeros(100, dtype=np.int64)
            getattr(subset, fn)(d, got)
            getattr(jax_subset, fn)(d, want)
            np.testing.assert_array_equal(got, want)

    def page_of(mod, stats):
        page = stats.RatPage(1, 1, 100, 6)
        page.intcols[:] = -1
        page.floatcols[:] = -1
        mod.readColDataIntoPage(page, np.array([7, 8]), 0,
                                stats.STAT_DTYPE_INT, 103)
        mod.readColDataIntoPage(page, np.array([0.5, 1.5, 2.5]), 0,
                                stats.STAT_DTYPE_FLOAT, 100)
        return page

    got = page_of(subset, tilingstats)
    want = page_of(jax_subset, jax_tilingstats)
    np.testing.assert_array_equal(got.intcols, want.intcols)
    np.testing.assert_array_equal(got.floatcols, want.floatcols)
    assert got.intcols[0, 3:5].tolist() == [7, 8]


def test_subset_recode_routes_match_jax(rng):
    """native.subset_recode against the JAX package's, on the library and
    on its Python loop, tile after tile with one running table."""
    from pyshepseg_tpu import native as jax_native
    tiles = [rng.integers(0, 40, size=(9, 11)).astype(np.uint32)
             for _ in range(3)]
    masks = [None, rng.integers(0, 3, size=(9, 11)) * 128, None]

    def run(mod):
        lut = np.zeros(41, np.uint32)
        hist = np.zeros(41, np.uint64)
        nxt, outs = 1, []
        for tile, mask in zip(tiles, masks):
            out, nxt = mod.subset_recode(tile, mask, lut, nxt, hist)
            outs.append(out)
        return outs, lut, hist, nxt

    want = run(jax_native)
    got = run(native)
    lib = native._lib
    try:
        native._lib = None
        native._build_error = RuntimeError("no compiler")
        slow = run(native)
    finally:
        native._lib, native._build_error = lib, None
    for other in (got, slow):
        for a, b in zip(other[0], want[0]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(other[1], want[1])
        np.testing.assert_array_equal(other[2], want[2])
        assert other[3] == want[3]


def test_subset_recode_rejects_wrong_table_types():
    tile = np.ones((2, 2), np.uint32)
    with pytest.raises(TypeError):
        native.subset_recode(tile, None, np.zeros(3, np.int64), 1,
                             np.zeros(3, np.uint64))
    with pytest.raises(TypeError):
        native.subset_recode(tile, None, np.zeros(3, np.uint32), 1,
                             np.zeros(3, np.uint32))


def test_io_copy_structure_matches_jax(tmp_path, seg_path):
    """io.createCopyStructure and io.numpyTypeFromGdal: the same surface
    as the JAX package's io."""
    from pyshepseg_tpu import io as jax_io
    like = rio.open(seg_path)
    for gdt in (rio.GDT_Byte, rio.GDT_UInt16, rio.GDT_Int16,
                rio.GDT_UInt32, rio.GDT_Int32, rio.GDT_Float32,
                rio.GDT_Float64):
        assert rio.numpyTypeFromGdal(gdt) == jax_io.numpyTypeFromGdal(gdt)
    got = rio.createCopyStructure(str(tmp_path / "c.npseg"), like, nbands=2)
    want = jax_io.createCopyStructure(str(tmp_path / "w.npseg"), like,
                                      nbands=2)
    for ds in (got, want):
        ds.FlushCache()
    got, want = rio.open(str(tmp_path / "c.npseg")), rio.open(
        str(tmp_path / "w.npseg"))
    assert (got.RasterXSize, got.RasterYSize, got.RasterCount) == (
        want.RasterXSize, want.RasterYSize, want.RasterCount) == (110, 90, 2)
    assert tuple(got.GetGeoTransform()) == tuple(want.GetGeoTransform())
    assert (got.GetRasterBand(1).DataType == want.GetRasterBand(1).DataType
            == rio.GDT_UInt32)
