"""Whole runs of the cells on the program's CPU route at a small size:
they come out correct; with the timed path broken underneath they do
not; a lower precision in the program's place fails the limits; and a
cell, a traffic mix and a metric are added by files alone."""

import json
import shutil
import time

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.spec import Bench

from conftest import REPO

CELLS = [w["name"] for w in json.loads(
    (REPO / "BENCHMARK.json").read_text())["workloads"]]


def run(root, cell, seconds=1.0, seed=2 ** 31 + 99):
    return harness.run_cell(Bench(root), cell, seed, seconds, False,
                            time.perf_counter(), device="cpu")[0]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_correct(tiny_root, cell):
    res = run(tiny_root, cell)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    want = {m["name"] for m in Bench(tiny_root).metrics(
        Bench(tiny_root).cell(cell), False)}
    assert set(res["metrics"]) == want
    assert set(res["checks"]) == set(Bench(tiny_root).limits(cell)["compare"])
    assert list(res)[-1] == "checks"


def _unchanged_step(monkeypatch):
    from se3_icp_tpu_torch.models import registration
    monkeypatch.setattr(registration, "loop_step", lambda s, ms, c: s)


def _half_batch(monkeypatch):
    """Half of each batch registered, its answers repeated for the rest."""
    from se3_icp_tpu_torch.models import registration
    orig = registration.dispatch_arrays

    def half(src, n_src, tgt, n_tgt, *a, **kw):
        b = src.shape[0]
        h = max(1, b // 2)
        out = orig(src[:h], n_src[:h], tgt[:h], n_tgt[:h], *a,
                   **kw).settle()
        return registration.Dispatched(tuple(
            torch.cat([x, x[:h].repeat((-(-b // h),) + (1,) * (x.dim() - 1))
                       ])[:b] for x in out))
    monkeypatch.setattr(registration, "dispatch_arrays", half)


def _altered_answer(monkeypatch):
    """Every transform turned by 0.3 degrees where it is produced: inside
    the 2 degree gate, outside the limits."""
    from se3_icp_tpu_torch.models import registration
    orig = registration.to_original
    a = np.radians(0.3)
    turn = torch.tensor([[np.cos(a), -np.sin(a), 0, 0],
                         [np.sin(a), np.cos(a), 0, 0], [0, 0, 1, 0],
                         [0, 0, 0, 1]])

    def altered(T, pre, is_se3):
        out = orig(T, pre, is_se3)
        return turn.to(out) @ out
    monkeypatch.setattr(registration, "to_original", altered)


FAULTS = {"unchanged_step": _unchanged_step, "half_batch": _half_batch,
          "altered_answer": _altered_answer}


@pytest.mark.parametrize("cell,fault", [
    (c, f) for c in CELLS for f in FAULTS
    if not (c == "kitti.online" and f == "half_batch")])
def test_broken_path_is_not_correct(tiny_root, monkeypatch, cell, fault):
    """Each fault a one-card cell can have (the exchange between cards
    is not on its path; an online scan is a batch of one)."""
    FAULTS[fault](monkeypatch)
    assert not run(tiny_root, cell, seconds=0.5)["correct"]


CONTROLS = [(c, p) for c in CELLS for p in json.loads(
    (REPO / "portbench" / "limits" / f"{c}.json").read_text())["controls"]]
# TF32 departs from the float64 reference on the road by more than the
# road's limits only at the cells' size: the CPU's tiny road reads
# 0.0018-0.0037 degrees against the 0.004 limit.  The card test below
# holds it at the cell's size.
AT_CELL_SIZE_ONLY = {("kitti.batch32", "tf32"), ("kitti.online", "tf32")}


@pytest.mark.parametrize("cell,control", [
    x for x in CONTROLS if x not in AT_CELL_SIZE_ONLY])
def test_control_fails_the_limits(tiny_root, cell, control):
    """The reference in the control's precision, in the program's place,
    is judged as a run's answers are, and comes out not correct."""
    from portbench.control import readings
    got = readings(Bench(tiny_root), cell, 5, 8, [control], "cpu")[0]
    assert not got["correct"], got


@pytest.mark.gpu
@pytest.mark.parametrize("cell,control", CONTROLS)
def test_control_fails_the_limits_at_cell_size(card, cell, control):
    """The same at the cell's own size, on the card, as many units as a
    run completes in a short window."""
    from portbench.control import readings
    units = 40 if Bench(REPO).traffic(Bench(REPO).cell(cell)["traffic"])[
        "pattern"] == "online" else 20
    for seed in (11, 12, 13):
        got = readings(Bench(REPO), cell, seed, units, [control], "cuda")[0]
        assert not got["correct"], got


def test_cell_added_by_files(tiny_root, tmp_path):
    """A new configuration, traffic mix, cell and per-layer metric: only
    new files and new entries."""
    root = tmp_path / "b"
    shutil.copytree(tiny_root, root)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    d = root / "portbench"
    cfg = json.loads((d / "configs" / "golden.json").read_text())
    cfg["scene"]["model_seeds"] = [5, 6]
    (d / "configs" / "golden_b.json").write_text(json.dumps(cfg))
    mix = json.loads((d / "traffic" / "sync64.json").read_text())
    mix["batch"] = 2
    (d / "traffic" / "sync2.json").write_text(json.dumps(mix))
    (d / "limits" / "golden_b.sync2.json").write_text(
        (d / "limits" / "golden.sync64.json").read_text())
    (d / "metrics" / "pairs_done.batch.py").write_text(
        "def read(run):\n    return float(sum(len(u.it) for u in "
        "run.units))\n")
    spec["configs"].append(dict(spec["configs"][0], name="golden_b",
                                file="portbench/configs/golden_b.json"))
    spec["workloads"].append({"name": "golden_b.sync2", "config": "golden_b",
                              "traffic": "sync2", "chips": 1, "why": "test"})
    spec["end_to_end"][0]["workloads"].append("golden_b.sync2")
    spec["per_layer"].append({"name": "pairs_done.batch", "unit": "count",
                              "better": "higher", "source": "program_counter",
                              "layer": "solver", "moves": "pairs_per_s",
                              "workloads": ["golden_b.sync2"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    res = run(root, "golden_b.sync2")
    assert res["correct"] and "pairs_per_s" in res["metrics"]
    run_ = Bench(root)
    names = [m["name"] for m in run_.metrics(run_.cell("golden_b.sync2"),
                                              True)]
    assert names == ["pairs_done.batch"]


@pytest.mark.gpu
def test_cell_on_card(card, tmp_path):
    """The command as the benchmark's check gives it, traced, on the
    card: a correct result line with the traced metrics and the device's
    readings."""
    import subprocess
    import sys
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "golden.serve64",
         "--seed", "123456789012", "--seconds", "2", "--trace", "1"],
        cwd=REPO, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
    assert "k4_roofline.batch" in res["metrics"]


NEW_SCENE = '''
"""Scan-to-model registration of one model seen from fresh random poses
of up to 4 degrees, both sides new arrays."""
import numpy as np
from portbench import clouds
from portbench.traffic import stream


class Scene:
    def __init__(self, scene, traffic, seed):
        self.model = clouds.golden_problem(scene["model_seed"],
                                           scene["points"])[0]
        self.seed, self.n = seed, scene["points"]

    def count_range(self):
        return self.n, self.n

    def batch(self, kind, k, size):
        rng = stream(self.seed, kind, k)
        M = clouds.small_motions(rng, size, 4.0, 0.1)
        N = clouds.small_motions(rng, size, 4.0, 0.1)
        return (list(zip(clouds.moved(self.model, M),
                         clouds.moved(self.model, N))),
                N @ np.linalg.inv(M))
'''

NEW_PATTERN = '''
"""Each pair of a batch through ``register_pair``, one at a time."""
import time
from portbench import traffic

UNITS = "batch"


def warm(driver):
    pairs, _ = driver.scene.batch("warm", 0, 1)
    one(driver.port, *pairs[0])


def one(port, src, tgt):
    return port.reg.register_pair(src, tgt, port.algorithm, port.cfg,
                                  dtype=port.torch_dtype, device=port.device)


def run(driver, spans, open_, kind, start):
    out, k = [], start
    while open_(k - start):
        pairs, gts = driver.make(spans, kind, k, driver.traffic["batch"])
        t_sub = time.perf_counter()
        with spans("submit"):
            res = [one(driver.port, s, t) for s, t in pairs]
        out.append(traffic.unit(k, t_sub, time.perf_counter(), res, gts,
                                pairs))
        k += 1
    return out
'''


def test_scene_and_pattern_added_by_files(tiny_root, tmp_path):
    """A configuration of a new scene kind under a traffic mix of a new
    pattern, with a new entry call: only new files and new entries."""
    root = tmp_path / "b"
    shutil.copytree(tiny_root, root)
    d = root / "portbench"
    (d / "scenes" / "posed_model.py").write_text(NEW_SCENE)
    (d / "patterns" / "pair_by_pair.py").write_text(NEW_PATTERN)
    cfg = json.loads((d / "configs" / "golden.json").read_text())
    cfg["scene"] = {"kind": "posed_model", "model_seed": 9, "points": 300}
    (d / "configs" / "posed.json").write_text(json.dumps(cfg))
    (d / "traffic" / "pairs2.json").write_text(json.dumps(
        {"pattern": "pair_by_pair", "batch": 2, "warm_units": 1,
         "trace_units": 1, "sample": {"pairs": 3}}))
    (d / "limits" / "posed.pairs2.json").write_text(
        (d / "limits" / "golden.sync64.json").read_text())
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append(dict(spec["configs"][0], name="posed",
                                file="portbench/configs/posed.json"))
    spec["workloads"].append({"name": "posed.pairs2", "config": "posed",
                              "traffic": "pairs2", "chips": 1,
                              "why": "test"})
    spec["end_to_end"][0]["workloads"].append("posed.pairs2")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    res = run(root, "posed.pairs2")
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 2
    assert "pairs_per_s" in res["metrics"]
