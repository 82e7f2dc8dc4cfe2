"""
The plain reference that decides ``correct``: the Shepherd segmentation
of one tile, the cross-tile stitch and the per-segment statistics,
written from their stated semantics in plain PyTorch and NumPy. It loads
nothing of the program under test (nor JAX); it reads the program's
output files with NumPy, only to judge them.
"""
