"""Shared fixtures of the benchmark's own tests: the checkout on the
path, and a small copy of the benchmark's data under a temporary root."""

import json
import os
import shutil
import sys

import pytest

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if CHECKOUT not in sys.path:
    sys.path.insert(0, CHECKOUT)

SMALL = 320
TILE = 128
OVERLAP = 32


def make_small_root(root):
    """A copy of BENCHMARK.json and the benchmark's data files under
    ``root`` with every grid cut to SMALL^2 and tiles of TILE, so that a
    run fits a CPU test. Returns ``root``."""
    src = os.path.join(CHECKOUT, "gpubench")
    for sub in ("configs", "landscapes", "traffic", "metrics", "jobs"):
        shutil.copytree(os.path.join(src, sub),
                        os.path.join(root, "gpubench", sub),
                        ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(CHECKOUT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    for c in spec["configs"]:
        path = os.path.join(root, c["file"])
        with open(path) as f:
            cfg = json.load(f)
        grid = cfg["grid"]
        if cfg.get("footprint"):
            fp = cfg["footprint"]
            fp["width"] *= SMALL / grid["width"]
            fp["height"] *= SMALL / grid["height"]
        grid["width"] = grid["height"] = SMALL
        cfg["segmentation"]["tileSize"] = TILE
        cfg["segmentation"]["overlapSize"] = OVERLAP
        cfg["kmeans"]["subsample"] = 20000
        with open(path, "w") as f:
            json.dump(cfg, f)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    return root


@pytest.fixture
def small_root(tmp_path):
    return make_small_root(str(tmp_path / "root"))


@pytest.fixture
def small_spec(small_root):
    from gpubench import bench
    return bench.Spec(small_root)
