"""The benchmark's checks on the card, at the small test size: each
cell's run is correct, and each control is not. Run on a machine with an
NVIDIA GPU: ``python -m pytest -m cuda gpubench/tests``."""

import pytest
import torch

from gpubench import bench, control

CELLS = ["s2-cropland.segment", "landsat-rangeland.segment",
         "s2-cropland.stats", "s2-cropland.tile"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False here)")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(small_spec, cell, card):
    res = bench.run_cell(small_spec, cell, 2 ** 31 + 5, 0.5, 1, card)
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
    assert res["device"]["busy_s"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_on_the_card(small_spec, cell, card, tmp_path):
    run = bench.Run(small_spec, cell, 31, 0, 0, card)
    run.workdir = str(tmp_path)
    run.job.prepare(run)
    checks = control.control_checks(run)
    assert not bench.correct(checks), checks
