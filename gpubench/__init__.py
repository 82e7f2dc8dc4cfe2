"""
The benchmark of pyshepseg_tpu_torch on an NVIDIA GPU.

``python gpubench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line. Everything that belongs to one configuration, traffic mix,
landscape, job or per-layer metric is a file of its own under this
folder, found by the name ``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: a deployment (grid, bands, values, the
  segmentation settings);
- ``traffic/<mix>.json``: a job (``jobs/<job>.py``) and the landscape it
  runs on (``landscapes/<name>.json``);
- ``metrics/<metric>.py``: the reader of one per-layer metric.

The plain reference that decides ``correct`` is under ``reference/`` and
loads nothing of the program.
"""
