"""``BENCHMARK.json`` and the files it names, found by name.

Everything that belongs to one configuration, traffic mix, cell or
metric is a file of its own under the benchmark's folder:

  * ``configs/<config>.json``     (the path ``BENCHMARK.json`` gives)
  * ``traffic/<traffic>.json``    a traffic mix's parameters
  * ``scenes/<kind>.py``          what a configuration's clouds are
                                  (its ``scene.kind``): ``Scene``
  * ``patterns/<pattern>.py``     how a mix's units arrive (its
                                  ``pattern``): the loop and the
                                  program's entry call
  * ``limits/<cell>.json``        a cell's comparison: its limits
                                  (``compare``) and its control
  * ``metrics/<metric>.py``       a metric's reader, ``read(run)``
  * ``references/<name>.py``      a configuration's plain reference

so a cell, a configuration, a mix or a metric is added by adding files
and entries.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
HERE = "portbench"


class Bench:
    """The benchmark of the checkout at ``root``."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.dir = self.root / HERE
        with open(self.root / "BENCHMARK.json") as f:
            self.spec = json.load(f)

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return _json(self.root / c["file"])
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return _json(self.dir / "traffic" / f"{name}.json")

    def limits(self, cell: str) -> dict:
        return _json(self.dir / "limits" / f"{cell}.json")

    def metrics(self, cell: dict, traced: bool) -> list:
        """The cell's metric entries: its end-to-end metrics, or (traced)
        its per-layer ones: those that list it, or that list no cells and
        move an end-to-end metric the cell reports."""
        e2e = [m for m in self.spec["end_to_end"] if _in(m, cell["name"])]
        if not traced:
            return e2e
        names = {m["name"] for m in e2e}
        return [m for m in self.spec["per_layer"]
                if cell["name"] in m.get("workloads", ())
                or ("workloads" not in m and m["moves"] in names)]

    def scene(self, config: dict, traffic: dict, seed: int):
        """The clouds of a configuration's scene under a traffic mix."""
        kind = config["scene"]["kind"]
        return _module(self.dir / "scenes" / f"{kind}.py").Scene(
            config["scene"], traffic, seed)

    def pattern(self, traffic: dict):
        return _module(self.dir / "patterns" / f"{traffic['pattern']}.py")

    def reader(self, metric: str):
        return _module(self.dir / "metrics" / f"{metric}.py").read

    def reference(self, name: str):
        return _module(self.dir / "references" / f"{name}.py")


def _in(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


_LOADED: dict = {}


def _module(path: Path):
    if path in _LOADED:
        return _LOADED[path]
    name = "portbench_file_" + "".join(c if c.isalnum() else "_"
                                       for c in str(path))
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    _LOADED[path] = mod
    return mod
