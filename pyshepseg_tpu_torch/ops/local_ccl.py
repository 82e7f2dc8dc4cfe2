"""
Block-local connected-component labels, the seed of the global clump loop
(counterpart: pyshepseg_tpu/ops/pallas_ccl.py, whose Pallas kernel
``_local_ccl_kernel`` this module's CUDA kernel K1, csrc/local_ccl.cu,
replaces).

Contract, as the TPU kernel's: the image is cut into by x bx blocks; every
valid pixel (``img != ignore_val``) is labelled with the smallest global
flat index, in the padded image, of its connected component inside its
block; invalid pixels get INT32_MAX. Labels only decrease toward the
global component minimum and always hold the flat index of a pixel of the
same component, so the seed speeds up the global fixpoint loop of
ops/clump.py without changing its result.
"""

import torch

from .. import _kernels
from .shifts import shift, offsets_for

# Default block edge. The TPU kernel's 256 (512 KB of labels + image) does
# not fit the 227 KB of shared memory an H100 block can use; 128 x 128
# takes 128 KB.
BLOCK = 128
INT32_MAX = 2147483647
# shared memory one H100 block may use (bytes); the kernel needs 8 a pixel
MAX_SHARED_BYTES = 232448


def block_shape_for(h: int, w: int):
    """
    Per-axis block sizes and the padded image shape:
    ((block_y, block_x), (padded_h, padded_w)). An axis shorter than
    BLOCK becomes one block, rounded up to a multiple of 8.
    """
    block_y = BLOCK if h >= BLOCK else max(8, -(-h // 8) * 8)
    block_x = BLOCK if w >= BLOCK else max(8, -(-w // 8) * 8)
    hp = -(-h // block_y) * block_y
    wp = -(-w // block_x) * block_x
    return (block_y, block_x), (hp, wp)


def _block_arg(block, h, w):
    if block is None:
        return (min(BLOCK, h), min(BLOCK, w))
    if isinstance(block, int):
        return (block, block)
    return tuple(block)


def local_ccl_blocks_reference(img, ignore_val, four_connected: bool,
                               block=None):
    """
    Plain PyTorch version of :func:`local_ccl_blocks`: the image reshaped
    to (nblocks, by, bx), masked neighbour-min iterated to the block-local
    fixpoint, with no iteration cap.
    """
    h, w = img.shape
    by, bx = _block_arg(block, h, w)
    nby, nbx = h // by, w // bx
    blocks = img.reshape(nby, by, nbx, bx).permute(0, 2, 1, 3).reshape(
        nby * nbx, by, bx)
    flat = torch.arange(h * w, device=img.device, dtype=torch.int32)
    flat = flat.reshape(nby, by, nbx, bx).permute(0, 2, 1, 3).reshape(
        nby * nbx, by, bx)
    valid = blocks != ignore_val
    labels = torch.where(valid, flat, INT32_MAX)
    same = []
    for dy, dx in offsets_for(four_connected):
        nbr = shift(blocks, dy, dx, ignore_val, dims=(1, 2))
        same.append((dy, dx, valid & (nbr == blocks)))
    while True:
        new = labels
        for dy, dx, s in same:
            new = torch.minimum(new, torch.where(
                s, shift(new, dy, dx, INT32_MAX, dims=(1, 2)), INT32_MAX))
        if torch.equal(new, labels):
            break
        labels = new
    return labels.reshape(nby, nbx, by, bx).permute(0, 2, 1, 3).reshape(h, w)


def local_ccl_blocks(img, ignore_val, four_connected: bool, block=None):
    """
    Per-block locally converged labels (global flat indices; invalid
    pixels get INT32_MAX). ``img`` is int32 (H, W) with H, W multiples of
    the block shape; callers pad with ``ignore_val`` (see
    block_shape_for). On a CUDA tensor this launches kernel K1; on a CPU
    tensor it runs :func:`local_ccl_blocks_reference`.
    """
    h, w = img.shape
    by, bx = _block_arg(block, h, w)
    if h % by or w % bx:
        raise ValueError("image %s is not a multiple of block %s"
                         % ((h, w), (by, bx)))
    if 8 * by * bx > MAX_SHARED_BYTES:
        raise ValueError("block %s needs more shared memory than a block "
                         "has" % ((by, bx),))
    if img.device.type == "cpu":
        return local_ccl_blocks_reference(img, ignore_val, four_connected,
                                          (by, bx))
    if img.device.type != "cuda":
        raise ValueError("local_ccl_blocks: unsupported device %s"
                         % img.device)
    if img.dtype != torch.int32 or not img.is_contiguous():
        raise ValueError("local_ccl_blocks needs a contiguous int32 image")
    if h * w >= INT32_MAX:
        raise ValueError("image too large for int32 flat indices")
    lib = _kernels.lib()
    out = torch.empty_like(img)
    with torch.cuda.device(img.device):
        code = lib.local_ccl_launch(
            img.data_ptr(), out.data_ptr(), h, w, by, bx, int(ignore_val),
            int(bool(four_connected)), _kernels.stream_ptr(img))
    _kernels.check(code, "local_ccl")
    local_ccl_blocks.launches += 1
    return out


local_ccl_blocks.launches = 0
