"""
Gather from a lookup table (counterpart: pyshepseg_tpu/ops/lut.py, whose
Pallas kernel ``_lut_kernel`` this module's CUDA kernel K2,
csrc/lut_gather.cu, replaces).

The id remaps of small-segment elimination gather many indices from a
table of ``capacity`` entries: 2E int32 edge ends from the int64 remap and
the int64 remap from the int64 merge map in every graph pass, then the
H*W segment image from an int32 table in the final relabel. K2 takes the
index and table types as they are, and any table size; the JAX package's
32768-entry limit (its ``LUT_MAX_TABLE``) came from the TPU kernel's loop
over table rows and has no counterpart here. K2 has two routes, chosen by
:func:`lut_route`:

- ``"direct"``: every thread reads its entries through the read-only
  path, from L2 or, for a table of up to ~100-150 KB, from each SM's L1,
  which then holds it as a staged copy would;
- ``"staged"``: each block copies the table into shared memory with one
  TMA bulk copy and looks up there. It pays only where the direct route's
  L1 no longer holds the table (from ~192 KB) and the copy is amortised
  (reuse n / c of 32 and more), and the table must fit shared memory.
"""

import torch

from .. import _kernels

# The staged route is taken from this reuse n / c and this table size on
# (and when the table fits shared memory): below either the direct route
# was as fast or faster in chip_smoke.py's phase 4b sweep (PERF.md).
STAGED_MIN_REUSE = 32
STAGED_MIN_BYTES = 192 * 1024
# Shared memory the staged route needs beside the table: the mbarrier and
# up to 15 bytes that align the table as in global memory.
STAGED_PAD = 32
# K2 addresses table positions as int32.
MAX_TABLE = 2 ** 31 - 1

_DTYPES = (torch.int32, torch.int64)
_smem_limits = {}


def use_lut(table_size: int, device) -> bool:
    """Whether a gather from a table of ``table_size`` entries on
    ``device`` goes through K2: every CUDA device, any table K2 can
    address."""
    return torch.device(device).type == "cuda" and table_size <= MAX_TABLE


def lut_route(n: int, c: int, table_dtype, smem_limit: int) -> str:
    """K2's route for ``n`` indices into a table of ``c`` entries of
    ``table_dtype``, where a block may use ``smem_limit`` bytes of shared
    memory: ``"staged"`` when the table fits, holds at least
    STAGED_MIN_BYTES and the reuse ``n / c`` is at least STAGED_MIN_REUSE,
    else ``"direct"``. The index type does not enter: both routes stream
    the same index bytes."""
    nbytes = c * table_dtype.itemsize
    if (STAGED_MIN_BYTES <= nbytes <= smem_limit - STAGED_PAD and
            n >= STAGED_MIN_REUSE * c):
        return "staged"
    return "direct"


def smem_limit(device) -> int:
    """Bytes of shared memory a block on the CUDA ``device`` may use (the
    staged route's bound), queried once per device."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    if index not in _smem_limits:
        with torch.cuda.device(index):
            limit = _kernels.lib().lut_gather_smem_limit(index)
        _kernels.check(max(0, -limit), "lut_gather_smem_limit")
        _smem_limits[index] = limit
    return _smem_limits[index]


def lut_gather_reference(idx, table):
    """Plain PyTorch version of :func:`lut_gather`: ``table[idx]``."""
    return table[idx.long()]


def lut_gather_flat(idx, table):
    """``table[idx]`` for a 1-D index vector (the graph passes' form)."""
    return lut_gather(idx, table)


def lut_gather(idx, table, route=None):
    """
    ``table[idx]`` for int32/int64 indices of any shape, all in
    [0, len(table)), from a 1-D int32/int64 table, exact; returns the
    table's dtype. On a CUDA tensor this launches kernel K2 on the route
    :func:`lut_route` picks (or ``route``, "direct" or "staged"); on a CPU
    tensor it runs :func:`lut_gather_reference`.
    """
    if idx.device.type == "cpu" and table.device.type == "cpu":
        return lut_gather_reference(idx, table)
    if idx.device.type != "cuda" or table.device != idx.device:
        raise ValueError("lut_gather: idx on %s, table on %s"
                         % (idx.device, table.device))
    if table.dim() != 1 or not 0 < table.shape[0] <= MAX_TABLE:
        raise ValueError("lut_gather: table must be 1-D with 1 to %d "
                         "entries, got %s" % (MAX_TABLE, tuple(table.shape)))
    if idx.dtype not in _DTYPES or table.dtype not in _DTYPES:
        raise ValueError("lut_gather: int32/int64 idx and table only, got "
                         "%s, %s" % (idx.dtype, table.dtype))
    idx = idx.contiguous()
    table = table.contiguous()
    out = torch.empty(idx.shape, dtype=table.dtype, device=idx.device)
    n, c = idx.numel(), table.shape[0]
    if n == 0:
        return out
    limit = smem_limit(idx.device)
    if route is None:
        route = lut_route(n, c, table.dtype, limit)
    elif route not in ("direct", "staged"):
        raise ValueError("lut_gather: route %r" % (route,))
    if route == "staged" and STAGED_PAD + c * table.element_size() > limit:
        raise ValueError("lut_gather: a table of %d x %d B does not fit the "
                         "staged route's %d B" % (c, table.element_size(),
                                                  limit))
    lib = _kernels.lib()
    with torch.cuda.device(idx.device):
        code = lib.lut_gather_launch(
            idx.data_ptr(), idx.element_size(), table.data_ptr(),
            table.element_size(), out.data_ptr(), n, c, route == "staged",
            idx.device.index, _kernels.stream_ptr(idx))
    _kernels.check(code, "lut_gather")
    _kernels.count(lut_gather)
    _kernels.count(lut_gather, route + "_launches")
    return out


lut_gather.launches = 0
lut_gather.direct_launches = 0
lut_gather.staged_launches = 0
