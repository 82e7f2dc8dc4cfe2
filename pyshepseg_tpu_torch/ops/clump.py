"""
Connected-component labelling ("clumping")
(counterpart: pyshepseg_tpu/ops/clump.py).

Every valid pixel starts with a block-local label from kernel K1
(ops/local_ccl.py) and labels only decrease, through three mechanisms per
global sweep:

1. neighbour min over the diagonal offsets (8-connectivity only),
2. segmented min-scans along rows and columns (Hillis-Steele doubling over
   same-value runs), which carry a label across a whole run per sweep,
3. every JUMP_EVERY-th sweep, one pointer-jumping step
   (label = label[label]) that collapses long label chains.

At the fixpoint every component carries the flat index of its first pixel
in row-major scan order, the order in which the reference's flood fill
seeds clumps, so the scan-order rank relabel reproduces the reference's
clump IDs bit for bit.

Only the JAX package's global-sweep path is ported. Its two-level
boundary-root merge gives identical output by construction and is left for
later, as is the reference's ``maxClumpSize`` cap.
"""

import numpy as np
import torch

from .. import _kernels
from .constants import SegIdType, SEGNULLVAL
from .shifts import shift, offsets_for
from .sync import to_host

# Run the pointer-jumping hop (a full-image gather) on every JUMP_EVERY-th
# sweep: typical scenes converge from the block-local seeds in a few sweeps
# without it, while spiral-shaped label chains still collapse.
JUMP_EVERY = 8


def _run_min(labels, conn_prev, axis, sentinel):
    """
    Min of each label over its whole same-value run along ``axis``.
    ``conn_prev`` is True where an element is connected to its predecessor
    along the axis. Hillis-Steele doubling: forward and backward sweeps of
    log2(size) shifted minima.
    """

    def sweep(lab, conn, sign):
        reach = conn
        d = 1
        size = lab.shape[axis]
        while d < size:
            off = (sign * d, 0) if axis == 0 else (0, sign * d)
            lab_s = shift(lab, *off, sentinel)
            reach_s = shift(reach, *off, False)
            lab = torch.where(reach, torch.minimum(lab, lab_s), lab)
            reach = reach & reach_s
            d *= 2
        return lab

    fwd = sweep(labels, conn_prev, -1)          # take from predecessors
    conn_next = shift(conn_prev, *((1, 0) if axis == 0 else (0, 1)), False)
    bwd = sweep(labels, conn_next, 1)           # take from successors
    return torch.minimum(fwd, bwd)


def _seed_labels(img, ignore_val, four_connected, valid, sentinel,
                 local_ccl=None):
    """
    Block-locally converged seed labels from ``local_ccl`` (default
    :func:`local_ccl_blocks`, kernel K1 on the card). The kernel works on
    the image padded to whole blocks; its flat indices are translated from
    padded to unpadded coordinates (both row-major, so the lexicographic
    (y, x) order, and with it the min-index root rule, is preserved).
    """
    from .local_ccl import local_ccl_blocks, block_shape_for

    if local_ccl is None:
        local_ccl = local_ccl_blocks
    h, w = img.shape
    blk, (hp, wp) = block_shape_for(h, w)
    img_p = torch.nn.functional.pad(img, (0, wp - w, 0, hp - h),
                                    value=int(ignore_val))
    lab = local_ccl(img_p.contiguous(), ignore_val, four_connected,
                    block=blk)[:h, :w]
    ly = torch.div(lab, wp, rounding_mode="floor")
    lx = lab - ly * wp
    return torch.where(valid, ly * w + lx, sentinel)


def clump_labels(img, ignore_val, four_connected=True, local_ccl=None):
    """
    Label connected components of equal-valued pixels.

    Parameters
    ----------
    img : int32 tensor (nRows, nCols)
        Values to clump; pixels equal to ``ignore_val`` are null.
    ignore_val : int
        Null value in ``img``.
    four_connected : bool
        4-way vs 8-way connectedness.
    local_ccl : callable or None
        The block-local seed: None for :func:`local_ccl_blocks` (kernel
        K1 on a CUDA tensor), or ``local_ccl_blocks_reference`` to seed
        from the plain version.

    Returns
    -------
    seg : int32 tensor (nRows, nCols)
        Scan-order component labels starting at 1; null pixels are 0.
    num_clumps : int
        Number of components found.
    num_sweeps : int
        Global propagation sweeps until the fixpoint (each decided on the
        host).
    """
    h, w = img.shape
    n = h * w
    sentinel = n
    valid = img != ignore_val
    labels = _seed_labels(img, ignore_val, four_connected, valid, sentinel,
                          local_ccl)

    def conn(dy, dx):
        # the valid shift masks out-of-image and null neighbours, so the
        # fill value of the img shift never decides the result
        return (valid & shift(valid, dy, dx, False) &
                (img == shift(img, dy, dx, ignore_val)))

    conn_row = conn(0, -1)   # connected to left neighbour
    conn_col = conn(-1, 0)   # connected to upper neighbour
    # diagonal offsets only: the run scans carry rows and columns
    nbr_same = [(dy, dx, conn(dy, dx))
                for dy, dx in offsets_for(four_connected)
                if dy != 0 and dx != 0]

    num_sweeps = 0
    while True:
        new = labels
        for dy, dx, same in nbr_same:
            new = torch.minimum(new, torch.where(
                same, shift(new, dy, dx, sentinel), sentinel))
        new = _run_min(new, conn_row, 1, sentinel)
        new = _run_min(new, conn_col, 0, sentinel)
        if num_sweeps % JUMP_EVERY == JUMP_EVERY - 1:
            flat_ext = torch.cat([new.reshape(-1),
                                  new.new_full((1,), sentinel)])
            new = flat_ext[new.reshape(-1).long()].reshape(h, w)
        new = torch.where(valid, new, sentinel)
        changed = to_host(torch.any(new != labels))
        labels = new
        num_sweeps += 1
        if not changed:
            break

    # Scan-order relabel: component root = min flat index = first pixel
    # the reference's raster scan would have seeded from.
    flat = labels.reshape(-1)
    is_root = (flat == torch.arange(n, dtype=flat.dtype, device=flat.device)
               ) & valid.reshape(-1)
    rank = torch.cumsum(is_root, 0, dtype=torch.int32)
    rank_ext = torch.cat([rank, rank.new_zeros(1)])
    seg = torch.where(valid.reshape(-1), rank_ext[flat.long()], SEGNULLVAL)
    num_clumps = to_host(rank[-1]) if n else 0
    return seg.reshape(h, w), int(num_clumps), num_sweeps


def clump(img, ignoreVal, fourConnected=True, clumpId=1, maxClumpSize=None,
          device="cuda"):
    """
    Host API matching the reference signature
    (reference: pyshepseg/shepseg.py:452-541). Returns
    ``(clumpimg, nextClumpId)`` where clumpimg (uint32) has IDs starting at
    ``clumpId`` in scan order and nextClumpId is the highest ID used + 1.
    The reference's ``maxClumpSize`` cap is not ported yet.
    """
    if maxClumpSize is not None:
        raise NotImplementedError("maxClumpSize is not ported yet")
    device = _kernels.torch_device(device)
    img_t = torch.from_numpy(
        np.ascontiguousarray(img).astype(np.int32)).to(device)
    seg, num, _ = clump_labels(img_t, int(ignoreVal),
                               four_connected=bool(fourConnected))
    seg = seg.cpu().numpy().astype(SegIdType)
    if clumpId != 1:
        seg = np.where(seg != SEGNULLVAL, seg + SegIdType(clumpId - 1), seg)
    return seg.astype(SegIdType), clumpId + num
