"""
Shared constants and dtypes for the segmentation engine
(counterpart: pyshepseg_tpu/ops/constants.py).

Segment IDs are uint32 at the numpy boundary, 0 is the null segment, real
IDs start at 1. Inside the port labels are int32 or int64 tensors: shifts
on ``torch.uint32`` are not implemented on every device.
"""

import numpy as np

# dtype used for segment ID numbers (numpy boundary only)
SegIdType = np.uint32

# Null value used in both cluster-ID and segment-ID images
SEGNULLVAL = 0
MINSEGID = SEGNULLVAL + 1
