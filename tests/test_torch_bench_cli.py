"""The bench protocols' checkpoint and the port's CLI sub-commands
``bench-lounge``, ``bench-kitti``, ``test-se3-pure``, ``eval-traj`` and
``lrf-quality``, on the CPU (``--device cpu``; the plain versions run).

  * A checkpointed run whose file lost half of its last line resumes
    (through ``bench-lounge --checkpoint``) with that pair alone, in a
    batch of the full run's size (the batch sizes ``register_pairs``
    receives are recorded), and gives the outcomes of the full run.
  * ``bench-kitti --generate`` writes the stand-in dataset; the run's
    ``--json`` line is the direct call's report (times aside); its
    ``--save-traj`` file read by ``eval-traj`` gives the JAX package's
    ``eval-traj`` numbers on the same two files.
  * ``lrf-quality`` gives the JAX ``lrf-quality``'s correspondences and
    per-correspondence errors (to float32 noise); ``test-se3-pure`` runs
    its alpha grid.
  * Every sub-command refuses to run without a card unless ``--device
    cpu`` is given, before any work.
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

from se3_icp_tpu import cli as j_cli

from se3_icp_tpu_torch import cli
from se3_icp_tpu_torch.bench import common, kitti_bench, lounge_bench
from se3_icp_tpu_torch.datasets import fixtures
from se3_icp_tpu_torch.utils import ply

torch.set_num_threads(2)

TIME_KEYS = ("avg_total_time_ms", "avg_time_ms", "median_time_ms")


@pytest.fixture(scope="module")
def lounge_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("lounge_fix"))
    fixtures.make_lounge_fixture(d, n_frames=11, n_points=900)
    return d


def run_cli(main, argv):
    """``main(argv)`` in this process: (stdout lines, the JSON of the
    last line when there is one)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    lines = buf.getvalue().strip().splitlines()
    try:
        return lines, json.loads(lines[-1])
    except ValueError:
        return lines, None


def without_times(rep):
    return {k: v for k, v in rep.items() if k not in TIME_KEYS}


def test_checkpoint_resumes_only_the_truncated_pair(lounge_dir, tmp_path,
                                                    monkeypatch):
    sizes = []
    real = common.par.register_pairs

    def recorded(batch, *a, **kw):
        sizes.append(len(batch))
        return real(batch, *a, **kw)

    monkeypatch.setattr(common.par, "register_pairs", recorded)
    ck = tmp_path / "lounge.jsonl"
    kw = dict(checkpoint=str(ck), device="cpu")
    full = lounge_bench.benchmark_lounge("se3_pt2pl", lounge_dir, **kw)
    assert sizes == [2]
    first = common.Checkpoint(str(ck)).done
    lines = ck.read_text().splitlines(keepends=True)
    assert len(lines) == 2
    ck.write_text(lines[0] + lines[1][:len(lines[1]) // 2])
    assert sorted(common.Checkpoint(str(ck)).done) == [0]
    sizes.clear()
    # the resume through the CLI: ``bench-lounge --checkpoint``
    _, again = run_cli(cli.main, ["bench-lounge", "se3_pt2pl", lounge_dir,
                                  "--device", "cpu", "--json",
                                  "--checkpoint", str(ck)])
    # pair 1 alone, padded to the full run's chunk of 2 (not a new
    # batch shape of 1)
    assert sizes == [2]
    done = common.Checkpoint(str(ck)).done
    assert sorted(done) == [0, 1]
    for i in (0, 1):
        assert done[i].num_iterations == first[i].num_iterations
        np.testing.assert_array_equal(done[i].T_est, first[i].T_est)
    assert without_times(again) == without_times(full)
    # a finished run registers nothing
    sizes.clear()
    lounge_bench.benchmark_lounge("se3_pt2pl", lounge_dir, **kw)
    assert sizes == []


def test_cli_bench_kitti_and_eval_traj(tmp_path):
    d = str(tmp_path / "kitti")
    lines, _ = run_cli(cli.main, ["bench-kitti", "se3_pt2pl", d,
                                  "--generate", "--max-index", "4"])
    assert lines[-1].startswith("synthetic KITTI-layout fixture written")
    est = str(tmp_path / "est.txt")
    _, rep = run_cli(cli.main, ["bench-kitti", "se3_pt2pl", d,
                                "--max-index", "4", "--device", "cpu",
                                "--json", "--save-traj", est])
    direct = kitti_bench.benchmark_kitti("se3_pt2pl", d, max_index=4,
                                         device="cpu")
    assert rep["num_pairs"] == 2 and rep["success_rate"] == 1.0
    assert without_times(rep) == without_times(direct)
    # the kept frames' ground truth beside the estimated trajectory
    gt = str(tmp_path / "gt.txt")
    poses = ply.read_trajectory_12col(os.path.join(d, "Sequence_07",
                                                   "07.txt"))[::2][:3]
    ply.write_trajectory_12col(gt, poses)
    assert ply.read_trajectory_12col(est).shape == (3, 4, 4)
    _, mine = run_cli(cli.main, ["eval-traj", gt, est, "--device", "cpu",
                                 "--json"])
    _, theirs = run_cli(j_cli.main, ["eval-traj", gt, est, "--json"])
    assert set(mine) == set(theirs)
    for k in theirs:
        np.testing.assert_allclose(mine[k], theirs[k], rtol=0, atol=1e-9)
    assert mine["success_rate"] == 1.0


def test_cli_lrf_quality_matches_jax_and_test_se3_pure_runs(
        lounge_dir, tmp_path, monkeypatch):
    """``lrf-quality`` against the JAX ``lrf-quality`` on the same
    files: the same correspondences, each one's error within 0.05 deg
    (the port's frames are float32, the JAX package's float64 under x64;
    trace-acos alone carries ~1e-2 deg of float32 noise near 0).  The
    TOLDI frame is not translation-invariant (the reference's centroid
    divisor), so a moved copy of a cloud has frame errors of its own.
    ``test-se3-pure`` prints one line an alpha."""
    p = fixtures.golden_shape_problem(seed=2, n=300)
    src, tgt, gt = (str(tmp_path / f) for f in ("s.ply", "t.ply", "gt.txt"))
    ply.write_ply(src, p.source)
    ply.write_ply(tgt, p.target)
    np.savetxt(gt, p.T_gt)
    dumps = [str(tmp_path / f) for f in ("port.txt", "jax.txt")]
    _, rep = run_cli(cli.main, ["lrf-quality", src, tgt, gt, "--device",
                                "cpu", "--json", "--dump", dumps[0]])
    _, jrep = run_cli(j_cli.main, ["lrf-quality", src, tgt, gt, "--json",
                                   "--dump", dumps[1]])
    assert rep["num_corrs"] == jrep["num_corrs"] == 300
    mine, theirs = (np.loadtxt(f) for f in dumps)
    assert mine.shape == theirs.shape == (300,)
    assert np.abs(mine - theirs).max() < 0.05
    assert abs(rep["mean_lrf_so3_error"] - jrep["mean_lrf_so3_error"]) < 0.05
    monkeypatch.setattr(common, "hybrid_alpha_grid", lambda: [0.1, 3.0])
    lines, _ = run_cli(cli.main, ["test-se3-pure", "se3_pure_pt2pl",
                                  lounge_dir, "--device", "cpu"])
    assert [ln.split(" | ")[1] for ln in lines] == ["rot_alpha = 0.1",
                                                   "rot_alpha = 3.0"]
    eul = [float(ln.rsplit("= ", 1)[1]) for ln in lines]
    assert all(np.isfinite(e) and e < 2.0 for e in eul), lines


@pytest.mark.parametrize("argv", [
    ["bench-lounge", "se3_pt2pl", "DIR"],
    ["bench-kitti", "se3_pt2pl", "DIR", "--online"],
    ["test-se3-pure", "se3_pure_pt2pl", "DIR"],
    ["eval-traj", "DIR/gt.txt", "DIR/est.txt"],
    ["lrf-quality", "DIR/s.ply", "DIR/t.ply", "DIR/gt.txt"],
], ids=lambda a: a[0])
def test_cli_without_a_card_says_so_before_any_work(argv, monkeypatch):
    """No card and no ``--device cpu``: the command raises before it
    reads a file (the paths here do not exist)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="none is available"):
        cli.main([a.replace("DIR", "/nonexistent") for a in argv])
