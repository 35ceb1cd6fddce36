"""What the harness and the reference import, and where a run refuses
to give a result: no JAX package in the process, no program in the
reference, no result without a card or without the program."""

import ast
import json
import shutil
import subprocess
import sys

from conftest import REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "se3_icp_tpu"}


def _py(code: str, cwd=REPO) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=cwd,
                          capture_output=True, text=True, timeout=600)


def test_no_source_imports_the_jax_package():
    """By whole top-level names: ``se3_icp_tpu_torch`` is allowed,
    ``se3_icp_tpu`` is not."""
    for path in (REPO / "portbench").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN, (path, n)


def test_dry_run_loads_no_jax(tiny_root):
    """A whole run of a cell on the CPU route: afterwards no module of
    the process has a forbidden top-level name."""
    code = f"""
import json, sys, time
sys.path.insert(0, {str(REPO)!r})
from portbench import harness
from portbench.spec import Bench
res, _, _ = harness.run_cell(Bench({str(tiny_root)!r}), "golden.serve64",
                          7, 0.5, False, time.perf_counter(), device="cpu")
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    out = _py(code)
    assert out.returncode == 0, out.stderr[-3000:]
    top = set(json.loads(out.stdout.splitlines()[-1]))
    assert "se3_icp_tpu_torch" in top
    assert not top & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    code = f"""
import json, sys
sys.path.insert(0, {str(REPO)!r})
from portbench import compare, clouds, traffic
from portbench.spec import Bench
Bench({str(REPO)!r}).reference("se3_icp")
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    out = _py(code)
    assert out.returncode == 0, out.stderr[-3000:]
    top = set(json.loads(out.stdout.splitlines()[-1]))
    assert not top & (FORBIDDEN | {"se3_icp_tpu_torch"})


def _run(cwd) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "golden.serve64",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=cwd,
        capture_output=True, text=True, timeout=600,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})


def _no_result(out) -> bool:
    for line in out.stdout.splitlines():
        try:
            if "correct" in json.loads(line):
                return False
        except ValueError:
            pass
    return True


def test_no_card_no_result():
    """It never falls back to the CPU."""
    out = _run(REPO)
    assert out.returncode != 0 and _no_result(out)
    assert "no CUDA device" in out.stderr


def test_benchmark_files_alone_no_result(tmp_path):
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    out = _run(tmp_path)
    assert out.returncode != 0 and _no_result(out)
