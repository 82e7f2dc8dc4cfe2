"""
Gather from a small lookup table (counterpart: pyshepseg_tpu/ops/lut.py,
whose Pallas kernel ``_lut_kernel`` this module's CUDA kernel K2,
csrc/lut_gather.cu, replaces).

The id remaps of small-segment elimination gather many indices (2E per
graph pass, H*W for the final relabel) from a table of at most
``capacity`` entries. On the card the table fits in one block's shared
memory, so K2 stages it there and streams the indices. Above
LUT_MAX_TABLE entries the JAX package uses a generic gather too; here that
is plain indexing.
"""

import torch

from .. import _kernels

# Largest table K2 takes: 32768 x 4 B = 128 KB of shared memory.
LUT_MAX_TABLE = 32768


def use_lut(table_size: int, device) -> bool:
    """Whether a gather from a table of ``table_size`` entries on
    ``device`` goes through K2: a CUDA device and a small enough table."""
    return torch.device(device).type == "cuda" and table_size <= LUT_MAX_TABLE


def lut_gather_reference(idx, table):
    """Plain PyTorch version of :func:`lut_gather`: ``table[idx]``."""
    return table[idx.long()]


def lut_gather_flat(idx, table):
    """``table[idx]`` for a 1-D index vector (the graph passes' form)."""
    return lut_gather(idx, table)


def lut_gather(idx, table):
    """
    ``table[idx]`` for int32/int64 indices of any shape, all in
    [0, len(table)), from a 1-D int32/int64 table whose values fit 32 bits
    (uint32 ids are carried through int32 lanes, as on the TPU). Returns
    the table's dtype. On a CUDA tensor this launches kernel K2; on a CPU
    tensor it runs :func:`lut_gather_reference`.
    """
    if idx.device.type == "cpu" and table.device.type == "cpu":
        return lut_gather_reference(idx, table)
    if idx.device.type != "cuda" or table.device != idx.device:
        raise ValueError("lut_gather: idx on %s, table on %s"
                         % (idx.device, table.device))
    if table.dim() != 1 or table.shape[0] > LUT_MAX_TABLE:
        raise ValueError("lut_gather: table must be 1-D with at most %d "
                         "entries, got %s" % (LUT_MAX_TABLE,
                                              tuple(table.shape)))
    if (idx.dtype not in (torch.int32, torch.int64) or
            table.dtype not in (torch.int32, torch.int64)):
        raise ValueError("lut_gather: int32/int64 idx and table only, got "
                         "%s, %s" % (idx.dtype, table.dtype))
    idx32 = idx.to(torch.int32).contiguous()
    tab32 = table.to(torch.int32).contiguous()
    out = torch.empty_like(idx32)
    lib = _kernels.lib()
    with torch.cuda.device(idx.device):
        code = lib.lut_gather_launch(
            idx32.data_ptr(), tab32.data_ptr(), out.data_ptr(),
            idx32.numel(), tab32.shape[0], _kernels.stream_ptr(idx))
    _kernels.check(code, "lut_gather")
    lut_gather.launches += 1
    if table.dtype == torch.int64:
        return out.to(torch.int64) & 0xFFFFFFFF
    return out


lut_gather.launches = 0
