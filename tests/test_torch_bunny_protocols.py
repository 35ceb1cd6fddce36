"""The bunny protocols of the port (``bench/synthetic_bench.py``,
``bench/extreme_noise_bench.py``, ``bench/scaling_bench.py``) against
the JAX package's, on the CPU, on a small bunny stand-in
(``fixtures.write_bunny_standin`` at 25,000 points, so the protocols'
2% downsample keeps 500).

Both packages read the same stand-in: the JAX package through its
``synthetic.BUNNY_PATH``, the port through ``SE3_ICP_TPU_BUNNY``.  The
port runs with ``device="cpu"`` and ``exact_knn=True`` in float64, the
JAX package's CPU route (exact sorted kNN, x64 on through
``tests/conftest.py``): per pair the success and the iteration counts
are EQUAL and the errors agree to 1e-6 relative.

Run as a script, this file is the survey of the JAX package's own
protocols on the full-size stand-in (208,353 points, 4,167 a cloud) on
its CPU route in float32, whose per-pair outcomes are
``tests/data/bunny_survey.json``:

    PYTHONPATH=. python tests/test_torch_bunny_protocols.py --json OUT
"""

import json
import os

import numpy as np
import pytest
import torch

from se3_icp_tpu.bench import common as j_common
from se3_icp_tpu.bench import extreme_noise_bench as j_noise
from se3_icp_tpu.bench import scaling_bench as j_scaling
from se3_icp_tpu.bench import synthetic_bench as j_synth
from se3_icp_tpu.datasets import synthetic as j_synthetic

from se3_icp_tpu_torch.bench import (common, extreme_noise_bench,
                                     scaling_bench, synthetic_bench)
from se3_icp_tpu_torch.datasets import fixtures, synthetic
from se3_icp_tpu_torch.utils import metrics_host

torch.set_num_threads(2)

SMALL_BUNNY = 25_000
REL_TOL = 1e-6
PORT = dict(dtype=np.float64, device="cpu", exact_knn=True)


TIME_KEYS = ("avg_time_ms", "median_time_ms")


@pytest.fixture(scope="module")
def bunny(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("bunny") / "bunny.ply")
    fixtures.write_bunny_standin(path, n_points=SMALL_BUNNY)
    return path


@pytest.fixture
def both_read(bunny, monkeypatch):
    monkeypatch.setenv(synthetic.BUNNY_ENV, bunny)
    monkeypatch.setattr(j_synthetic, "BUNNY_PATH", bunny)
    return bunny


def hold_outcomes(mine: dict, theirs: dict, gts):
    """Per pair: the same success, equal iteration counts, the errors
    to REL_TOL relative (transforms to 1e-9 deg)."""
    assert sorted(mine) == sorted(theirs) and mine
    for i, T_gt in enumerate(gts):
        a, b = mine[i], theirs[i]
        assert a.num_iterations == b.num_iterations, (i, a, b)
        assert a.num_pure_se3_iterations == b.num_pure_se3_iterations
        Ta, Tb = np.asarray(a.T_est), np.asarray(b.T_est)
        assert metrics_host.success(T_gt, Ta) == metrics_host.success(
            T_gt, Tb)
        assert metrics_host.angular_error_so3(Ta[:3, :3], Tb[:3, :3]) < 1e-9
        for err in (lambda T: metrics_host.angular_error_so3(
                        T[:3, :3], T_gt[:3, :3]),
                    lambda T: metrics_host.translation_error(
                        T[:3, 3], T_gt[:3, 3])):
            np.testing.assert_allclose(err(Ta), err(Tb), rtol=REL_TOL,
                                       atol=1e-12)


def hold_report(mine: dict, theirs: dict):
    assert set(mine) == set(theirs)
    for k, v in theirs.items():
        if k not in TIME_KEYS:
            assert mine[k] == v, k


def _same_folders(a: str, b: str):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and names
    for n in names:
        pa, pb = os.path.join(a, n), os.path.join(b, n)
        if os.path.isdir(pa):
            _same_folders(pa, pb)
            continue
        with open(pa, "rb") as f, open(pb, "rb") as g:
            assert f.read() == g.read(), pa


def test_bench_synthetic_generates_and_registers_as_jax(both_read, tmp_path,
                                                         capsys):
    from se3_icp_tpu import cli as j_cli
    from se3_icp_tpu_torch import cli
    mine, theirs = str(tmp_path / "mine"), str(tmp_path / "theirs")
    args = ["--generate", "--num-cases", "4", "--difficulty", "easy"]
    cli.main(["bench-synthetic", "se3_pt2pl", mine] + args)
    j_cli.main(["bench-synthetic", "se3_pt2pl", theirs] + args)
    _same_folders(mine, theirs)
    ck_m, ck_t = str(tmp_path / "port.jsonl"), str(tmp_path / "jax.jsonl")
    rep = synthetic_bench.benchmark_on_saved_data(
        "se3_pt2pl", mine, checkpoint=ck_m, **PORT)
    jrep = j_synth.benchmark_on_saved_data(
        "se3_pt2pl", mine, checkpoint=ck_t, dtype=np.float64)
    hold_report(rep, jrep)
    gts = [p.T_gt for p in synthetic.load_problem_folder(mine)]
    hold_outcomes(common.Checkpoint(ck_m).done,
                  j_common.Checkpoint(ck_t).done, gts)
    assert rep["num_problems"] == 4 and rep["success_rate"] == 1.0
    assert "success rate" in capsys.readouterr().out


def test_extreme_noise_level_registers_as_jax(both_read, tmp_path):
    """One noise level's folder, the protocol's 30 runs of ~500 points
    against the shared gt_transform: per run as the JAX package, and the
    level's 1000 x FilterReg error to 1e-6 relative."""
    folder = str(tmp_path / "noise")
    extreme_noise_bench.generate_dataset(folder)
    j_folder = str(tmp_path / "j_noise")
    j_noise.generate_dataset(j_folder)
    _same_folders(folder, j_folder)
    assert extreme_noise_bench.LEVEL_FOLDERS == j_noise.LEVEL_FOLDERS
    level = os.path.join(folder, "noise_0_02")
    ck = str(tmp_path / "port.jsonl")
    pairs_, T_gt, mine = extreme_noise_bench.level_outcomes(
        "se3_pt2pl", level, checkpoint=ck, **PORT)
    assert len(pairs_) == extreme_noise_bench.RUNS == 30
    assert 450 < len(pairs_[0][0]) < 550
    theirs = j_common.run_pairs(pairs_, "se3_pt2pl", j_noise.EXTREME_NOISE,
                                dtype=np.float64, verbose=False)
    hold_outcomes(mine, theirs, [T_gt] * 30)
    err = extreme_noise_bench.benchmark_level_folder(
        "se3_pt2pl", level, **PORT)
    np.testing.assert_allclose(
        err, j_noise.benchmark_level_folder("se3_pt2pl", level,
                                            dtype=np.float64),
        rtol=REL_TOL)


def test_bench_scaling_mechanics_as_jax(both_read):
    """One card's ladder is [1]; each repetition takes fresh arrays, the
    JAX package's, and registers them as the JAX package does."""
    from se3_icp_tpu.parallel import pairs as j_pairs
    from se3_icp_tpu.utils.config import GOLDEN as J_GOLDEN
    from se3_icp_tpu_torch.parallel import pairs
    from se3_icp_tpu_torch.utils.config import GOLDEN
    assert scaling_bench.device_ladder(1) == [1]
    assert scaling_bench.device_ladder(6) == j_scaling.device_ladder(6)
    prob = synthetic.synthetic_problem("easy", 0.002, seed=1)
    mine = scaling_bench._jittered_lists(prob, 2, 1,
                                         np.random.default_rng(0))
    theirs = j_scaling._jittered_lists(prob, 2, 1, np.random.default_rng(0))
    for a, b in zip(mine, theirs):
        for (sa, ta), (sb, tb) in zip(a, b):
            np.testing.assert_array_equal(sa, sb)
            assert ta is prob.target and tb is prob.target
    assert mine[0][0][0] is not mine[1][0][0]
    got = pairs.register_pairs(mine[0], "se3_pt2pl", GOLDEN, **PORT)
    ref = j_pairs.register_pairs(theirs[0], "se3_pt2pl", J_GOLDEN,
                                 dtype=np.float64)
    hold_outcomes({i: common.PairOutcome(i, r.transformation,
                                         r.num_iterations,
                                         r.num_pure_se3_iterations, 0.0)
                   for i, r in enumerate(got)},
                  {i: j_common.PairOutcome(i, r.transformation,
                                           r.num_iterations,
                                           r.num_pure_se3_iterations, 0.0)
                   for i, r in enumerate(ref)}, [prob.T_gt] * 2)
    rep = scaling_bench.run_scaling(per_device=2, reps=2, cloud="easy",
                                    verbose=False, **PORT)
    assert rep["device_counts"] == [1] and rep["efficiency"] == [1.0]
    assert rep["platform"] == "cpu" and rep["devices_present"] == 1
    assert rep["pairs_per_s"][0] > 0
    assert {"metric", "algorithm", "cloud", "per_device_batch",
            "note"} <= set(rep)


def _jax_demo():
    """The demo problem as the JAX package's ``cmd_example`` builds it."""
    rng = np.random.default_rng(1)
    b1 = j_synthetic.load_bunny(scale=1.0)
    src = j_synthetic.random_downsample(b1, 0.02, rng)
    T_gt = np.eye(4)
    T_gt[:3, :3] = j_synthetic._rot_3d(np.pi / 5, np.pi / 4, np.pi / 6)
    T_gt[:3, 3] = (2.5, 3.5, 1.2)
    tgt = j_synthetic.random_downsample(
        b1 @ T_gt[:3, :3].T + T_gt[:3, 3], 0.02, rng)
    return src, tgt, T_gt


def test_examples_run_the_jax_packages_demo_problem(both_read, tmp_path,
                                                    capsys):
    import jax.numpy as jnp

    from se3_icp_tpu.models import registration as j_reg
    from se3_icp_tpu.utils.config import GOLDEN as J_GOLDEN
    from se3_icp_tpu_torch import cli
    from se3_icp_tpu_torch.models import registration as reg
    from se3_icp_tpu_torch.utils.config import GOLDEN
    src, tgt, T_gt = cli._bunny_demo()
    for a, b in zip((src, tgt, T_gt), _jax_demo()):
        np.testing.assert_array_equal(a, b)
    # the demo's registration, on the exact route in float64, as the
    # JAX package's
    mine = reg.register_pair(src, tgt, "se3_pt2pl", GOLDEN,
                             dtype=torch.float64, device="cpu",
                             exact_knn=True)
    theirs = j_reg.register_pair(src, tgt, "se3_pt2pl", J_GOLDEN,
                                 dtype=jnp.float64)
    assert mine.num_iterations == theirs.num_iterations
    assert metrics_host.angular_error_so3(
        mine.transformation[:3, :3], theirs.transformation[:3, :3]) < 1e-9
    # the commands: their JSON line, and example-fgr's three PLY files
    cli.main(["example", "--device", "cpu", "--json"])
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    np.testing.assert_array_equal(rep["T_gt"], T_gt)
    assert np.isfinite(rep["T"]).all() and rep["num_iterations"] > 0
    out = str(tmp_path / "aligned")
    cli.main(["example-fgr", "--device", "cpu", "--json",
              "--save-aligned", out])
    lines = capsys.readouterr().out.strip().splitlines()
    rep = json.loads(lines[-2])
    assert np.isfinite(rep["T"]).all() and np.isfinite(rep["so3_error_deg"])
    assert sorted(os.listdir(out)) == ["source.ply", "source_aligned.ply",
                                       "target.ply"]


def _survey_rows(outcomes, gts, pts=None):
    """{pair: {iterations, rot_deg, trans, gate[, error_x1000]}}."""
    rows = {}
    for i, T_gt in enumerate(gts):
        T = outcomes[i].T_est
        row = dict(iterations=int(outcomes[i].num_iterations),
                   rot_deg=round(metrics_host.angular_error_so3(
                       T[:3, :3], T_gt[:3, :3]), 6),
                   trans=round(metrics_host.translation_error(
                       T[:3, 3], T_gt[:3, 3]), 6),
                   gate=bool(metrics_host.success(T_gt, T)))
        if pts is not None:
            row["error_x1000"] = round(1000.0 * metrics_host.error_filterreg(
                pts[i], T_gt, T), 6)
        rows[str(i)] = row
    return rows


def bunny_survey(tmp: str, route: str = "exact") -> dict:
    """The JAX package's protocols on the full-size stand-in, on its CPU
    route in float32 (``route="exact"``: exact sorted kNN) or on its
    threshold route with every Pallas kernel in interpret mode
    (``route="thr"``, the route of its accelerator and of the port on
    the card): ``bench-synthetic`` (30 cases each of easy, moderate and
    difficult, ``se3_pt2pl``), the extreme-noise levels 0.0, 0.05 and
    0.1 (30 runs each, ``se3_pt2pl``), ``example``, ``example-fgr``, and
    on the exact route ``se3_pt2pl`` with SHOT frames on the easy set
    (SHOT takes the exact route on both).  Returns the surveys, every
    pair's outcome."""
    import time

    from se3_icp_tpu.models import fgr as j_fgr
    from se3_icp_tpu.models import registration as j_reg
    from se3_icp_tpu.ops import knn as j_knn
    from se3_icp_tpu.utils import ply as j_ply
    from se3_icp_tpu.utils.config import EXTREME_NOISE, GOLDEN
    if route == "thr":
        os.environ["SE3_ICP_TPU_FORCE_PALLAS"] = "1"
        os.environ["SE3_ICP_TPU_PALLAS_INTERPRET"] = "1"
    assert j_knn.use_thr_knn() == (route == "thr")
    bunny = os.path.join(tmp, "bunny.ply")
    fixtures.write_bunny_standin(bunny)
    j_synthetic.BUNNY_PATH = bunny
    surveys = []

    def run(name, pairs, gts, cfg, extra, pts=None):
        t0 = time.time()
        ck = os.path.join(tmp, f"{name}.jsonl")
        j_common.run_pairs(pairs, "se3_pt2pl", cfg, checkpoint=ck,
                           verbose=False)
        out = j_common.Checkpoint(ck).done
        surveys.append(dict(protocol=name, route=route,
                            algorithm="se3_pt2pl", **extra,
                            minutes=round((time.time() - t0) / 60, 2),
                            pairs=_survey_rows(out, gts, pts)))
        print(name, sum(r["gate"] for r in surveys[-1]["pairs"].values()),
              "of", len(gts), surveys[-1]["minutes"], "min", flush=True)

    for difficulty in ("easy", "moderate", "difficult"):
        folder = os.path.join(tmp, difficulty)
        j_synth.generate_dataset(folder, 30, difficulty)
        probs = j_synthetic.load_problem_folder(folder)
        run(f"synthetic_{difficulty}", [(p.source, p.target) for p in probs],
            [p.T_gt for p in probs], GOLDEN.replace(alpha_rot=3.0),
            dict(difficulty=difficulty, cases=30, noise=0.005,
                 config="GOLDEN"))
        if difficulty == "easy" and route == "exact":
            run("synthetic_easy_shot",
                [(p.source, p.target) for p in probs],
                [p.T_gt for p in probs],
                GOLDEN.replace(lrf_method="shot"),
                dict(difficulty=difficulty, cases=30, noise=0.005,
                     config="GOLDEN, lrf_method='shot' (shot_exact, "
                     "lrf_radius 0.8)"))
    noise = os.path.join(tmp, "noise")
    j_noise.generate_dataset(noise)
    for sub, level in zip(j_noise.LEVEL_FOLDERS, j_noise.LEVELS):
        if level not in (0.0, 0.05, 0.1):
            continue
        path = os.path.join(noise, sub)
        T_gt = j_noise._read_gt(path)
        pairs = [(j_ply.read_ply(os.path.join(path, f"source{i}.ply")).points,
                  j_ply.read_ply(os.path.join(path, f"target{i}.ply")).points)
                 for i in range(30)]
        run(f"extreme_noise_{sub}", pairs, [T_gt] * 30, EXTREME_NOISE,
            dict(level=level, runs=30, config="EXTREME_NOISE"),
            pts=[p[0] for p in pairs])
    surveys += examples_survey(route)
    return surveys


def examples_survey(route: str) -> list:
    """``example`` and ``example-fgr`` on the CLI's demo problem (the
    bunny at scale 1), float32; ``route="exact-x64"`` runs them with
    JAX's 64-bit mode on, as the JAX package's tests do (the inputs and
    the registration stay float32)."""
    import time

    import jax

    from se3_icp_tpu.models import fgr as j_fgr
    from se3_icp_tpu.models import registration as j_reg
    from se3_icp_tpu.utils.config import GOLDEN
    jax.config.update("jax_enable_x64", route == "exact-x64")
    src, tgt, T_gt = _jax_demo()
    surveys = []
    for name, fn in (("example", lambda: j_reg.register_pair(
            src, tgt, "se3_pt2pl", GOLDEN)),
            ("example-fgr", lambda: j_fgr.fgr_register(src, tgt))):
        if name == "example-fgr" and route == "thr":
            continue        # FGR takes no setup route
        t0 = time.time()
        res = fn()
        out = {0: j_common.PairOutcome(0, res.transformation,
                                       res.num_iterations, 0, 0.0)}
        surveys.append(dict(protocol=name, route=route, minutes=round(
            (time.time() - t0) / 60, 2), pairs=_survey_rows(out, [T_gt])))
        print(name, surveys[-1]["pairs"]["0"], flush=True)
    return surveys


def golden_survey(tmp: str) -> list:
    """The JAX package on its CPU route in float32 on the main path's 64
    golden-shape pairs (``fixtures.golden_shape_problem``, seeds 1-64)
    with SHOT frames and with Anderson acceleration (``anderson_m`` 3
    and 5), and on their noisy resampled versions (``fixtures.NOISY``)
    with ``mse`` 1e-9, where the R3 phase is long and the accelerated
    step is taken (``anderson_m`` 0, 3, 5): the cases the card runs
    SHOT and Anderson on."""
    import time

    from se3_icp_tpu.utils.config import GOLDEN
    runs = [("golden_shot", GOLDEN.replace(lrf_method="shot"), {}),
            ("golden_anderson_3", GOLDEN.replace(anderson_m=3), {}),
            ("golden_anderson_5", GOLDEN.replace(anderson_m=5), {})]
    runs += [(f"noisy_anderson_{m}", GOLDEN.replace(anderson_m=m, mse=1e-9),
              fixtures.NOISY) for m in (0, 3, 5)]
    surveys = []
    for name, cfg, kw in runs:
        probs = [fixtures.golden_shape_problem(seed=s, **kw)
                 for s in range(1, 65)]
        pairs = [(p.source, p.target) for p in probs]
        t0 = time.time()
        ck = os.path.join(tmp, f"{name}.jsonl")
        j_common.run_pairs(pairs, "se3_pt2pl", cfg, checkpoint=ck,
                           verbose=False)
        surveys.append(dict(
            protocol=name, route="exact", algorithm="se3_pt2pl",
            config=f"GOLDEN + {name.split('_', 1)[1]}"
            + (", NOISY problems, mse 1e-9" if kw else ""), cases=64,
            minutes=round((time.time() - t0) / 60, 2),
            pairs=_survey_rows(j_common.Checkpoint(ck).done,
                               [p.T_gt for p in probs])))
        print(name, sum(r["gate"] for r in surveys[-1]["pairs"].values()),
              "of 64", surveys[-1]["minutes"], "min", flush=True)
    return surveys


if __name__ == "__main__":
    import argparse
    import tempfile

    import jax
    jax.config.update("jax_platforms", "cpu")
    ap = argparse.ArgumentParser()
    ap.add_argument("--route", choices=["exact", "thr", "golden",
                                        "exact-x64"],
                    default="exact",
                    help="golden: the 64 golden-shape pairs with SHOT "
                         "and with Anderson acceleration (and the noisy "
                         "ones with Anderson), exact route; "
                         "exact-x64: the two examples with JAX's 64-bit "
                         "mode on")
    ap.add_argument("--json", help="write the survey here; the surveys "
                    "of the other runs already in it are kept")
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        if args.route == "golden":
            surveys = golden_survey(tmp)
        elif args.route == "exact-x64":
            bunny = os.path.join(tmp, "bunny.ply")
            fixtures.write_bunny_standin(bunny)
            j_synthetic.BUNNY_PATH = bunny
            surveys = examples_survey(args.route)
        else:
            surveys = bunny_survey(tmp, args.route)
    if args.json:
        kept = []
        if os.path.exists(args.json):
            new = {(s["protocol"], s["route"]) for s in surveys}
            with open(args.json) as f:
                kept = [s for s in json.load(f)["surveys"]
                        if (s["protocol"], s["route"]) not in new]
        with open(args.json, "w") as f:
            json.dump(dict(
                about="The JAX package's bunny protocols on the seed-made "
                      "bunny stand-in (fixtures.write_bunny_standin: "
                      "208,353 points, seed 11), pair by pair, in float32: "
                      "iterations, rotation error (deg), translation "
                      "error, the 2 deg / 0.25 gate, and for the "
                      "extreme-noise levels 1000 x the FilterReg error.  "
                      "route 'exact': its CPU route (exact sorted kNN); "
                      "'thr': its threshold route, every Pallas kernel in "
                      "interpret mode; 'exact-x64': the exact route with "
                      "JAX's 64-bit mode on (float32 data), as the JAX "
                      "package's tests run.",
                command="PYTHONPATH=. python "
                        "tests/test_torch_bunny_protocols.py "
                        "--route {exact,thr,golden,exact-x64} --json OUT",
                bunny_points=fixtures.BUNNY_POINTS, dtype="float32",
                surveys=kept + surveys), f, indent=1)
