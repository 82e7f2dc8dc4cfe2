"""The tiled driver's seconds outside per-tile segmentation a scene: each
``walltime`` span of the program less the union of the workers'
``segmentation`` spans inside it (initialise, scene cache, stitch tail)."""
from gpubench.spans import outside


def read(run):
    return outside("walltime", "segmentation")
