"""
Command-line entry points (counterpart: pyshepseg_tpu/cmdline/): run_seg
and the remote segmentation worker so far.
"""
