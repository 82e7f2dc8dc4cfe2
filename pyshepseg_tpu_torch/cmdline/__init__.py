"""
Command-line entry points (counterpart: pyshepseg_tpu/cmdline/): run_seg,
tiling, variograms and the remote segmentation worker so far.
"""
