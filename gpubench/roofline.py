"""
Peaks of the device and the bytes a kernel must move, from shapes only.
"""

# NVIDIA H100 SXM5 80GB: HBM3 bandwidth (data sheet), at its 700 W limit
HBM_BYTES_PER_S = 3.35e12


def local_ccl_bytes(height, width):
    """K1 (csrc/local_ccl.cu) on one (height, width) tile: its int32
    cluster image read once and its int32 labels written once."""
    return 8 * int(height) * int(width)


def roofline_pct(nbytes, seconds, rate=HBM_BYTES_PER_S):
    """The share (%) of the least time the bytes need at ``rate`` in the
    time the kernel took."""
    return 100.0 * nbytes / rate / seconds
