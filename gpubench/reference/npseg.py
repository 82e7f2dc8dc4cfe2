"""
Reads the program's ``.npseg`` output with NumPy alone: a directory with
``meta.json``, one ``band_<i>.npy`` a band and, per band, a raster
attribute table ``rat_<i>/`` of ``schema.json`` and one ``col_<j>.npy`` a
column.
"""

import json
import os

import numpy as np


def band(path, index=1):
    """Band ``index`` (1-based) as a read-only memory map."""
    return np.load(os.path.join(path, "band_%d.npy" % index), mmap_mode="r")


def rat_columns(path, names=None, index=1):
    """{name: column array} of band ``index``'s attribute table, for
    ``names`` or every column."""
    rat = os.path.join(path, "rat_%d" % index)
    with open(os.path.join(rat, "schema.json")) as f:
        schema = json.load(f)
    cols = {}
    for j, name in enumerate(schema["names"]):
        if names is None or name in names:
            cols[name] = np.load(os.path.join(rat, "col_%d.npy" % j))
    return cols


def histogram(path):
    """The 'Histogram' column of band 1's attribute table (int64)."""
    return rat_columns(path, ["Histogram"])["Histogram"].astype(np.int64)
