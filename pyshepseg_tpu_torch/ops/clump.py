"""
Connected-component labelling ("clumping")
(counterpart: pyshepseg_tpu/ops/clump.py).

Every valid pixel starts with its block-local label from kernel K1
(ops/local_ccl.py): the smallest flat index of its component inside its
block. Two ways take it to the global answer:

- the two-level merge (default): only the label pairs that straddle block
  boundaries are extracted (:func:`_boundary_edges`), the contracted graph
  of block roots is solved in edge-sized tensors
  (:func:`_merge_boundary_roots`), and one streaming pass verifies that
  every connected pixel pair ended with the same label;
- the global sweeps, which run where the verify fails (a seed that was not
  block-converged), where the image is one block, or when asked for
  (``two_level=False``). Labels only decrease, through three mechanisms per
  sweep:

  1. neighbour min over the diagonal offsets (8-connectivity only),
  2. segmented min-scans along rows and columns (Hillis-Steele doubling
     over same-value runs), which carry a label across a whole run per
     sweep,
  3. every JUMP_EVERY-th sweep, one pointer-jumping step
     (label = label[label]) that collapses long label chains.

Either way every component ends at the flat index of its first pixel in
row-major scan order, the order in which the reference's flood fill seeds
clumps, so the scan-order rank relabel reproduces the reference's clump
IDs bit for bit. The reference's ``maxClumpSize`` cap runs the host flood
fill (pyshepseg_tpu_torch.native), as the JAX package does.
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


def _boundary_edges(labels, img, ignore_val, by, bx, four_connected,
                    sentinel):
    """
    Label pairs of adjacent same-value pixels that straddle a block
    boundary of the (by, bx) block grid, as two flat (E,) tensors (invalid
    slots hold ``sentinel``). Strided slices of the block grid: a few thin
    streaming compares, no sort and no compaction. Pairs wholly inside one
    block (the image-edge corner duplicates) are harmless self-edges once
    the labels are block-converged.
    """
    ea_parts, eb_parts = [], []

    def add(lab_lo, lab_hi, img_lo, img_hi):
        m = min(lab_lo.shape[0], lab_hi.shape[0])
        n = min(lab_lo.shape[1], lab_hi.shape[1])
        lab_lo, lab_hi = lab_lo[:m, :n], lab_hi[:m, :n]
        img_lo, img_hi = img_lo[:m, :n], img_hi[:m, :n]
        ok = (img_lo == img_hi) & (img_lo != ignore_val) & (
            img_hi != ignore_val)
        ea_parts.append(torch.where(ok, lab_lo, sentinel).reshape(-1))
        eb_parts.append(torch.where(ok, lab_hi, sentinel).reshape(-1))

    # vertical pairs across horizontal block boundaries
    add(labels[by - 1::by], labels[by::by], img[by - 1::by], img[by::by])
    # horizontal pairs across vertical block boundaries
    add(labels[:, bx - 1::bx], labels[:, bx::bx],
        img[:, bx - 1::bx], img[:, bx::bx])
    if not four_connected:
        # diagonals across horizontal boundaries
        add(labels[by - 1::by, :-1], labels[by::by, 1:],
            img[by - 1::by, :-1], img[by::by, 1:])
        add(labels[by - 1::by, 1:], labels[by::by, :-1],
            img[by - 1::by, 1:], img[by::by, :-1])
        # diagonals across vertical boundaries (interior rows)
        add(labels[:-1, bx - 1::bx], labels[1:, bx::bx],
            img[:-1, bx - 1::bx], img[1:, bx::bx])
        add(labels[:-1, bx::bx], labels[1:, bx - 1::bx],
            img[:-1, bx::bx], img[1:, bx - 1::bx])
    return torch.cat(ea_parts), torch.cat(eb_parts)


def _merge_boundary_roots(ea, eb, sentinel):
    """
    Connected components of the contracted boundary-root graph: nodes are
    the block-local root labels in the edge lists; each converges to its
    contracted component's minimum label, which is the global component's
    minimum flat index (a component's global min root is reachable from
    each of its block roots through boundary edges). Min-hooking over the
    edges plus one value-chasing hop per iteration (m <- m[id(m)], ids by
    binary search over the sorted unique labels), each iteration decided
    on the host.

    Returns (uniq (2E,) sorted node labels padded with ``sentinel``,
    m (2E,) final min label per node, iterations).
    """
    keys, _ = torch.sort(torch.cat([ea, eb]))
    two_e = keys.shape[0]
    first = torch.ones_like(keys, dtype=torch.bool)
    first[1:] = keys[1:] != keys[:-1]
    first &= keys != sentinel
    uniq, _ = torch.sort(torch.where(first, keys, sentinel))
    # sentinel edges find the first sentinel slot, which stays sentinel
    ca = torch.searchsorted(uniq, ea).clamp_(max=two_e - 1)
    cb = torch.searchsorted(uniq, eb).clamp_(max=two_e - 1)
    m = uniq
    iterations = 0
    while True:
        em = torch.minimum(m[ca], m[cb])
        m2 = m.scatter_reduce(0, ca, em, "amin").scatter_reduce_(
            0, cb, em, "amin")
        j = torch.searchsorted(uniq, m2).clamp_(max=two_e - 1)
        m3 = torch.minimum(m2, m2[j])
        iterations += 1
        changed = to_host(torch.any(m3 != m))
        m = m3
        if not changed:
            return uniq, m, iterations


def _connected(img, valid, ignore_val, dy, dx):
    """Whether each pixel is connected to its neighbour at (dy, dx). The
    valid shift masks out-of-image and null neighbours, so the fill value
    of the img shift never decides the result."""
    return (valid & shift(valid, dy, dx, False) &
            (img == shift(img, dy, dx, ignore_val)))


def _two_level(labels, ea, eb, img, ignore_val, valid, four_connected,
               sentinel, stats):
    """
    The merge of block-local labels through their boundary-root graph
    (boundary pairs ``ea``, ``eb``). Returns (seg, num_clumps), or None
    where the verify finds a connected pair with two labels (a seed that
    was not block-converged).
    """
    h, w = img.shape
    n = h * w
    uniq, m, iterations = _merge_boundary_roots(ea, eb, sentinel)
    if stats is not None:
        stats["edges"] = int(to_host(torch.count_nonzero(ea != sentinel)))
        stats["merge_iterations"] = iterations
    flat0 = labels.reshape(-1)
    # one slot past the image takes the sentinel's writes
    is_root = torch.zeros(n + 1, dtype=torch.bool, device=img.device)
    is_root[:n] = (flat0 == torch.arange(n, dtype=flat0.dtype,
                                         device=flat0.device)) & (
        valid.reshape(-1))
    # block roots whose contracted component has a smaller root are
    # demoted: their pixels' rank comes through F below
    is_root[torch.where(m < uniq, uniq, sentinel).long()] = False
    rank_ext = torch.cumsum(is_root, 0, dtype=torch.int32)
    rank_ext[n] = 0
    # the rank table with merged roots redirected to their final root's
    # rank (the sentinel slot n keeps its 0)
    F = rank_ext.clone()
    F[uniq.long()] = rank_ext[m.long()]
    seg = torch.where(valid, F[flat0.long()].reshape(h, w), SEGNULLVAL)
    # verify: every connected pixel pair shares a label (each pair once)
    offsets = [(0, -1), (-1, 0)] + ([] if four_connected else
                                    [(-1, -1), (-1, 1)])
    bad = torch.zeros((), dtype=torch.bool, device=img.device)
    for dy, dx in offsets:
        bad |= torch.any(_connected(img, valid, ignore_val, dy, dx) &
                         (seg != shift(seg, dy, dx, SEGNULLVAL)))
    bad, num_clumps = to_host(torch.stack([bad.to(torch.int32),
                                           rank_ext[n - 1]]))
    if bad:
        return None
    return seg, num_clumps


def _sweeps(labels, img, ignore_val, valid, four_connected, sentinel):
    """The global fixpoint loop from any monotone label state; returns
    (scan-order segments, clump count, sweeps)."""
    h, w = img.shape
    n = h * w
    conn_row = _connected(img, valid, ignore_val, 0, -1)
    conn_col = _connected(img, valid, ignore_val, -1, 0)
    # diagonal offsets only: the run scans carry rows and columns
    nbr_same = [(dy, dx, _connected(img, valid, ignore_val, dy, dx))
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


def clump_labels(img, ignore_val, four_connected=True, local_ccl=None,
                 two_level=None, stats=None):
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
        The block-local labels: None for :func:`local_ccl_blocks` (kernel
        K1 on a CUDA tensor), or ``local_ccl_blocks_reference`` to start
        from the plain version.
    two_level : bool or None
        Merge the block-local labels through the boundary-root graph,
        verified, with the global sweeps as the fallback (None or True), or
        always sweep (False). The JAX package takes the merge on every
        backend but the TPU; on the H100 ``chip_smoke.py`` phases 5-6 A/B
        the two (PERF.md).
    stats : dict or None
        If given, filled with ``two_level`` (whether the merge's answer was
        taken), ``fallback`` (the verify failed and the sweeps ran),
        ``sweeps``, and on the merge path ``edges`` (valid boundary pairs)
        and ``merge_iterations``; the edge count costs one more host sync.

    Returns
    -------
    seg : int32 tensor (nRows, nCols)
        Scan-order component labels starting at 1; null pixels are 0.
    num_clumps : int
        Number of components found.
    num_sweeps : int
        Global propagation sweeps run (0 when the merge's answer stood).
    """
    from .local_ccl import block_shape_for

    h, w = img.shape
    sentinel = h * w
    valid = img != ignore_val
    labels = _seed_labels(img, ignore_val, four_connected, valid, sentinel,
                          local_ccl)
    fallback = False
    if two_level is None or two_level:
        (by, bx), _ = block_shape_for(h, w)
        ea, eb = _boundary_edges(labels, img, ignore_val, by, bx,
                                 four_connected, sentinel)
        if ea.shape[0]:  # more than one block
            merged = _two_level(labels, ea, eb, img, ignore_val, valid,
                                four_connected, sentinel, stats)
            if merged is not None:
                if stats is not None:
                    stats.update(two_level=True, fallback=False, sweeps=0)
                return merged[0], int(merged[1]), 0
            fallback = True
            _kernels.count(clump_labels, "fallbacks")
    seg, num_clumps, num_sweeps = _sweeps(labels, img, ignore_val, valid,
                                          four_connected, sentinel)
    if stats is not None:
        stats.update(two_level=False, fallback=fallback, sweeps=num_sweeps)
    return seg, num_clumps, num_sweeps


# times the two-level merge's verify failed and the sweeps ran instead
clump_labels.fallbacks = 0


def clump(img, ignoreVal, fourConnected=True, clumpId=1, maxClumpSize=None,
          device="cuda"):
    """
    Host API matching the reference signature
    (reference: pyshepseg/shepseg.py:452-541). Returns
    ``(clumpimg, nextClumpId)`` where clumpimg (uint32) has IDs starting at
    ``clumpId`` in scan order and nextClumpId is the highest ID used + 1.

    ``maxClumpSize`` opts into the reference's MAX_CLUMP_SIZE cap
    semantics (splitting big clumps in flood-fill stack order,
    shepseg.py:477-481). The cap's geometry is sequential, so that path
    runs the native C++ flood fill on the host
    (pyshepseg_tpu_torch/native/ccl.cpp) and ``device`` is not used.
    """
    device = _kernels.torch_device(device)
    if maxClumpSize is not None:
        from ..native import flood_fill_clump
        return flood_fill_clump(img, ignoreVal, fourConnected,
                                maxClumpSize, clumpId)
    img_t = torch.from_numpy(
        np.ascontiguousarray(img).astype(np.int32)).to(device)
    seg, num, _ = clump_labels(img_t, int(ignoreVal),
                               four_connected=bool(fourConnected))
    seg = seg.cpu().numpy().astype(SegIdType)
    if clumpId != 1:
        seg = np.where(seg != SEGNULLVAL, seg + SegIdType(clumpId - 1), seg)
    return seg.astype(SegIdType), clumpId + num
