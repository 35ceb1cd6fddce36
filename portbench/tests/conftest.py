"""Shared set-up of the benchmark's CPU tests: a copy of the benchmark
with its cells cut to a size the CPU route runs in seconds.  The card is
looked for inside fixtures only."""

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

TINY_SCENE = {"golden": {"points": 400, "model_seeds": [1, 4]},
              "kitti07_road": {"points": 1200, "max_index": 10}}
TINY_BATCH = 4          # the tiny golden scene holds 4 models


def _edit(path: Path, fn) -> None:
    d = json.loads(path.read_text())
    fn(d)
    path.write_text(json.dumps(d))


def make_tiny_root(dst: Path) -> Path:
    """A checkout-like folder: BENCHMARK.json and the benchmark's data
    files, every scene and batch cut down; the limits kept."""
    shutil.copytree(REPO / "portbench", dst / "portbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__",
                                                  ".cache"))
    shutil.copy(REPO / "BENCHMARK.json", dst)
    for name, scene in TINY_SCENE.items():
        _edit(dst / "portbench" / "configs" / f"{name}.json",
              lambda d, s=scene: d["scene"].update(s))
    def cut(d):
        d.update(warm_units=1, trace_units=2)
        if "batch" in d:
            d["batch"] = TINY_BATCH
        # a sample as large as a short window's answers
        d["sample"] = {k: 12 if k == "pairs" else 3 for k in d["sample"]}
    for path in (dst / "portbench" / "traffic").glob("*.json"):
        _edit(path, cut)
    return dst


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return make_tiny_root(tmp_path_factory.mktemp("bench"))


@pytest.fixture
def card():
    """Skips where there is no CUDA device."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
