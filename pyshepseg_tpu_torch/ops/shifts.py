"""
Masked neighbour-shift utilities (counterpart: pyshepseg_tpu/ops/shifts.py).

The reference accesses 3x3 neighbourhoods with scalar loops and explicit
edge clamping; here the same access is a whole-tensor shift with a constant
fill at the image border.
"""

import torch

# Neighbour offsets in the reference's scan order (row-major over the 3x3
# window, centre excluded). Order matters for tie-breaking parity in
# single-pixel elimination (the first strict minimum wins).
OFFSETS_8 = (
    (-1, -1), (-1, 0), (-1, 1),
    (0, -1), (0, 1),
    (1, -1), (1, 0), (1, 1),
)

# 4-connected subset, in the same scan order
OFFSETS_4 = ((-1, 0), (0, -1), (0, 1), (1, 0))


def offsets_for(four_connected: bool):
    """Neighbour offsets for the requested connectedness, in scan order."""
    return OFFSETS_4 if four_connected else OFFSETS_8


def shift(a, dy: int, dx: int, fill, dims=(0, 1)):
    """
    Return ``b`` with ``b[y, x] = a[y + dy, x + dx]`` where the source index
    is in bounds, and ``fill`` elsewhere — "the value of my neighbour at
    offset (dy, dx)". ``dims`` names the two axes shifted (default the
    first two, e.g. per-pixel vectors of shape (H, W, nBands)).
    """
    if dy == 0 and dx == 0:
        return a
    ay, ax = dims
    h, w = a.shape[ay], a.shape[ax]
    out = torch.full_like(a, fill)
    dst = [slice(None)] * a.dim()
    src = [slice(None)] * a.dim()
    dst[ay] = slice(max(-dy, 0), h - max(dy, 0))
    src[ay] = slice(max(dy, 0), h + min(dy, 0))
    dst[ax] = slice(max(-dx, 0), w - max(dx, 0))
    src[ax] = slice(max(dx, 0), w + min(dx, 0))
    out[tuple(dst)] = a[tuple(src)]
    return out
