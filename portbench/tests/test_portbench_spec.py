"""``BENCHMARK.json`` keeps the benchmark's contract, and every name in
it has the files it needs."""

import json
import re

import pytest

from portbench.spec import Bench

from conftest import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


@pytest.fixture(scope="module")
def spec():
    return json.loads((REPO / "BENCHMARK.json").read_text())


def test_keys_and_characters(spec):
    assert set(spec) == KEYS["top"]
    assert (REPO / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert all(PATH.match(p) and ".." not in p for p in spec["paths"])
    assert len(spec["command"]) <= 32
    assert all(LINE.match(w) for w in spec["command"])
    assert 1 <= spec["run_seconds"] <= 51
    for part in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in spec[part]]
        assert len(names) == len(set(names))
        for e in spec[part]:
            assert set(e) - {"workloads"} == KEYS[part], e["name"]
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                                "higher")
            for key in ("why", "layer", "source"):
                if key in e and part != "end_to_end":
                    assert LINE.match(e[key]), (e["name"], key)


def test_names_resolve_to_files(spec):
    bench = Bench(REPO)
    configs = {c["name"]: c for c in spec["configs"]}
    for c in spec["configs"]:
        assert c["file"].startswith(spec["paths"][0] + "/")
        data = bench.config(c["name"])
        assert all(NAME.match(k) and (k in data or k in data["scene"])
                   for k in c["reduced"])
        assert data["source"] == c["source"]
    for w in spec["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        t = bench.traffic(w["traffic"])
        bench.limits(w["name"])
        kind = bench.config(w["config"])["scene"]["kind"]
        assert (bench.dir / "scenes" / f"{kind}.py").is_file()
        assert bench.pattern(t).UNITS in ("batch", "lap")
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(bench.reader(m["name"]))


def test_metric_coverage(spec):
    cells = {w["name"] for w in spec["workloads"]}
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in spec["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in spec["per_layer"]:
        assert m["moves"] in e2e
        for c in m.get("workloads", cells):
            assert c in cells
            assert c in e2e[m["moves"]].get("workloads", cells)
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
    for c in cells:
        has = [m for m in spec["end_to_end"]
               if c in m.get("workloads", cells)]
        assert "setup_s" in [m["name"] for m in has] and len(has) >= 2
        assert any(c in m.get("workloads", cells) for m in spec["per_layer"])
