"""
Connected-component labelling of ONE image whose rows are sharded over a
list of devices (counterpart: pyshepseg_tpu/parallel/shardmap_clump.py):
the halo-exchange analogue of the tiled driver's overlapping tiles, where
the "halo" is one row of labels handed between neighbouring stripes every
sweep.

The JAX package drives all devices from one process through ``shard_map``;
here a row-sharded array is a Python list of per-stripe tensors, each on
its stripe's device, and one process steps the stripes through the same
body. Each stripe runs the min-label propagation of ops/clump.py's sweeps
(diagonal neighbour minima + Hillis-Steele run scans along rows and
columns), with its neighbours' border rows supplied by
:func:`exchange_rows` (the JAX ``ppermute``: one row copied to the
neighbour's device), so labels cross a stripe boundary each sweep. The
global fixpoint is decided from the stripes' change flags, stacked on one
device and read with ONE host sync a sweep (the JAX ``psum``). Pointer
jumping is absent on purpose: label values are global flat indices that
may live on other stripes, so chain collapsing would need a gather of the
whole image; the run scans keep convergence at O(stripes + shape turns)
sweeps.

The final scan-order relabel (component root = minimum flat index, the
reference flood fill's seed order) is a prefix sum over the stripes: each
counts its roots, the counts' running sum gives each stripe's offset, and
every pixel looks its root's rank up in the concatenation of the stripes'
rank rows (the JAX ``all_gather``).

The stripes are seeded with their own flat indices, as in the JAX package,
not with kernel K1's block-local labels: no hand-written kernel runs here.

This module complements parallel/mesh.py (CONC_MESH): CONC_MESH scales by
giving whole tiles to devices; this spreads a SINGLE oversized image over
devices when it exceeds one device's memory. A list that names one device
several times runs every exchange for real on that device.
"""

import numpy as np
import torch

from .. import _kernels
from ..ops.constants import SegIdType, SEGNULLVAL
from ..ops.clump import _run_min
from ..ops.shifts import shift, offsets_for
from ..ops.sync import to_host

AXIS = "rows"

# The JAX package's flat pixel indices (the clump labels before relabel)
# are int32, so its sharded image may hold at most this many pixels. The
# port's labels are int64; the limit and its message are kept so that both
# packages accept the same images.
MAX_SHARDED_PIXELS = 2 ** 31 - 1


def exchange_rows(arrs, fill):
    """
    The halo rows of a row-sharded array: ``arrs`` is the list of
    per-stripe (s, W) tensors in top-to-bottom order. Returns
    (tops, bots), lists of (W,) tensors on each stripe's device: the last
    row of the stripe above and the first row of the stripe below, with
    ``fill`` beyond the image's first and last stripe. Shared by the
    sharded clump and the sharded full pipeline (shardmap_seg). Each row
    handed to a neighbour adds one to ``exchange_rows.rows``.
    """
    n = len(arrs)
    tops, bots = [], []
    for i, arr in enumerate(arrs):
        if i == 0:
            tops.append(torch.full_like(arr[0], fill))
        else:
            tops.append(arrs[i - 1][-1].to(arr.device, non_blocking=True))
        if i == n - 1:
            bots.append(torch.full_like(arr[0], fill))
        else:
            bots.append(arrs[i + 1][0].to(arr.device, non_blocking=True))
    _kernels.count(exchange_rows, "rows", 2 * (n - 1))
    return tops, bots


exchange_rows.rows = 0


def with_halo(arr, top, bot):
    """(s + 2, W): the stripe with its neighbours' rows attached."""
    return torch.cat([top[None], arr, bot[None]], dim=0)


def any_over_stripes(flags):
    """Whether any of the per-stripe 0-dim flags (or counts) is non-zero:
    they are stacked on the first stripe's device and read with one host
    sync, whatever the number of stripes. Returns their sum."""
    dev = flags[0].device
    return to_host(torch.stack(
        [f.to(dev, non_blocking=True).long() for f in flags]).sum())


def _clump_stripe_body(imgs, ignore_val, four_connected, sentinel):
    """Build the per-sweep step over all stripes; returns (body, valids).
    The connectivity masks do not change between sweeps and are computed
    once, on the stripes with their halo rows attached."""
    valids = [img != ignore_val for img in imgs]
    img_tops, img_bots = exchange_rows(imgs, ignore_val)
    val_tops, val_bots = exchange_rows(valids, False)
    offs = offsets_for(four_connected)
    masks = []
    for i, img in enumerate(imgs):
        img_h = with_halo(img, img_tops[i], img_bots[i])
        valid_h = with_halo(valids[i], val_tops[i], val_bots[i])

        def conn(dy, dx):
            # connectivity of the stripe's rows (offset +1 into the halo)
            nbr_valid = shift(valid_h, dy, dx, False)[1:-1]
            nbr_same = (img_h == shift(img_h, dy, dx, ignore_val))[1:-1]
            return valid_h[1:-1] & nbr_valid & nbr_same

        # As in ops/clump.py the per-sweep neighbour min covers the
        # DIAGONALS only: rows and columns inside the stripe are carried
        # (much further a sweep) by the run scans, and the vertical link
        # across the stripe boundary is seen by the first and last rows.
        masks.append(dict(
            row=conn(0, -1), col=conn(-1, 0),
            diag=[(dy, dx, conn(dy, dx)) for dy, dx in offs
                  if dy != 0 and dx != 0],
            top=conn(-1, 0)[0], bot=conn(1, 0)[-1]))

    def body(labels):
        lab_tops, lab_bots = exchange_rows(labels, sentinel)
        out = []
        for i, lab in enumerate(labels):
            m = masks[i]
            lab_h = with_halo(lab, lab_tops[i], lab_bots[i])
            new = lab
            for dy, dx, same in m["diag"]:   # includes halo-crossing diags
                cand = shift(lab_h, dy, dx, sentinel)[1:-1]
                new = torch.minimum(new, torch.where(same, cand, sentinel))
            # vertical across the boundary: two rows, not the whole stripe
            new = new.clone() if new is lab else new
            new[0] = torch.minimum(new[0], torch.where(
                m["top"], lab_tops[i], sentinel))
            new[-1] = torch.minimum(new[-1], torch.where(
                m["bot"], lab_bots[i], sentinel))
            new = _run_min(new, m["row"], 1, sentinel)
            new = _run_min(new, m["col"], 0, sentinel)
            out.append(torch.where(valids[i], new, sentinel))
        return out

    return body, valids


def _clump_sharded(imgs, ignore_val: int, four_connected: bool):
    """
    The full clump over the stripes ``imgs`` (a list of equal-shaped int32
    (rows, width) tensors, top to bottom, each on its device).
    Returns (segs, num): the per-stripe int32 scan-order labels from 1
    (0 for null) and the number of components. Every sweep adds one to
    ``_clump_sharded.sweeps``.
    """
    stripe_h, width = imgs[0].shape
    sentinel = stripe_h * len(imgs) * width
    gidx = [(torch.arange(stripe_h * width, device=img.device) +
             i * stripe_h * width).reshape(stripe_h, width)
            for i, img in enumerate(imgs)]
    body, valids = _clump_stripe_body(imgs, ignore_val, four_connected,
                                      sentinel)
    labels = [torch.where(v, g, sentinel) for v, g in zip(valids, gidx)]

    while True:
        new = body(labels)
        # the global fixpoint: one host sync a sweep for all stripes
        changed = any_over_stripes(
            [torch.any(n != lab) for n, lab in zip(new, labels)])
        labels = new
        _kernels.count(_clump_sharded, "sweeps")
        if not changed:
            break

    # Scan-order relabel over the stripes: rank roots by global flat index.
    is_root = [((lab == g) & v).reshape(-1)
               for lab, g, v in zip(labels, gidx, valids)]
    dev0 = imgs[0].device
    counts = to_host(torch.stack(
        [r.sum().to(dev0, non_blocking=True) for r in is_root]))
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank_local = [torch.cumsum(r, 0, dtype=torch.int32) + int(off)
                  for r, off in zip(is_root, offsets)]
    # Every pixel needs the rank of its component's root, which may live
    # on another stripe: the stripes' rank rows are concatenated on every
    # device that holds a stripe (one image-sized copy, the same order as
    # one sweep's traffic), with one zero slot for the sentinel.
    rank_ext = {}
    segs = []
    for lab, v in zip(labels, valids):
        dev = lab.device
        if dev not in rank_ext:
            rank_ext[dev] = torch.cat(
                [r.to(dev, non_blocking=True) for r in rank_local] +
                [torch.zeros(1, dtype=torch.int32, device=dev)])
        segs.append(torch.where(v, rank_ext[dev][lab], SEGNULLVAL))
    return segs, int(sum(counts))


_clump_sharded.sweeps = 0


def row_stripes(arr, n_dev, devices, axis=0):
    """``arr`` (numpy, its ``axis`` a multiple of ``n_dev`` long) cut into
    ``n_dev`` equal stripes along ``axis``, stripe i on ``devices[i]``."""
    return [torch.from_numpy(np.ascontiguousarray(part)).to(dev)
            for part, dev in zip(np.split(arr, n_dev, axis=axis), devices)]


def clump_sharded(img, ignoreVal, fourConnected=True, mesh=None):
    """
    Host API: clump one large image with its rows sharded over the devices
    of ``mesh``: a sequence of torch.devices or their names, one stripe to
    each, in which one device may appear more than once; None for every
    visible CUDA device (raises when there is none; pass CPU devices to
    run on the CPU).
    Label semantics match ops.clump.clump (scan-order IDs from 1), but
    note the second return value is numClumps (= the highest ID), NOT
    the reference clump()'s nextClumpId (= highest ID + 1).
    Rows are padded with ``ignoreVal`` to a multiple of the stripe count.

    Returns (seg uint32 (H, W), numClumps int).
    """
    devices = _kernels.device_list(mesh)
    n_dev = len(devices)
    img = np.ascontiguousarray(img).astype(np.int32)
    h, w = img.shape
    if h * w > MAX_SHARDED_PIXELS:
        raise ValueError(
            f"image of {h}x{w} = {h * w} pixels exceeds the sharded "
            f"pipeline's int32 flat-index range ({MAX_SHARDED_PIXELS}); "
            "tile the scene with the tiled driver instead")
    pad = (-h) % n_dev
    if pad:
        img = np.pad(img, ((0, pad), (0, 0)), constant_values=ignoreVal)

    segs, num = _clump_sharded(row_stripes(img, n_dev, devices),
                               int(ignoreVal), bool(fourConnected))
    seg = np.concatenate([s.cpu().numpy() for s in segs])[:h]
    return seg.astype(SegIdType), num
