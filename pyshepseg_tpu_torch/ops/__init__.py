"""
Tensor operations of the segmentation engine, one module per counterpart in
:mod:`pyshepseg_tpu.ops`:

- :mod:`.shifts` — masked neighbour shifts
- :mod:`.kmeans` — Lloyd's k-means and cluster assignment
- :mod:`.local_ccl` — block-local connected components (CUDA kernel K1)
- :mod:`.clump` — connected-component labelling
- :mod:`.segreduce` — segment sizes, spectral sums, relabelling
- :mod:`.elim_single` — single-pixel elimination
- :mod:`.lut` — small-table gather (CUDA kernel K2)
- :mod:`.elim_small` — graph-space small-segment elimination
- :mod:`.sync` — the counted host synchronisation points
"""
