"""The port's restart fleet (``models/multistart.py``) against the JAX
package's, on the CPU.

The start grid is numpy on both sides and must be the same bits.  The
fleet runs the whole engine once per flat (pair, start) registration and
scores every candidate with one batched 1-NN (K6's plain version here):
it is held against the JAX package on each setup route -- the threshold
route against the JAX package's through the callback-free interpret gate
(``SE3_ICP_TPU_FORCE_PALLAS=1 SE3_ICP_TPU_PALLAS_INTERPRET=1``), the
exact route (``exact_knn=True``) against the same gate plus
``SE3_ICP_TPU_NO_THR_KNN=1`` -- on seed-made golden-shape clouds of
400-460 points under ``fixtures.FLIPPED_POSE``, the pose a single start
cannot reach.  Several starts may land in the right basin with nearly
equal scores, and on the threshold route iteration counts move by up to
2 against the JAX package's (``test_torch_registration_thr.py``), so
the kept INDEX may differ: the tests hold the kept transform (within
0.05 deg and 1e-3), the kept score, and, where the indices differ, the
port's own score of the JAX package's pick against its kept score.
Scores agree to 1e-5 relative, except near zero: a point that lies on
its target has a float32 squared distance of a few ulps of |p|^2 (the
shifted form |q|^2 - 2 q.t + |t|^2 cancels, on both sides, in different
orders), whose square root is ~1e-3; so a score at the right pose is
float32 noise below 1e-3, and scores are held to 1e-3 absolute.

Run as a script, this file is the survey behind ``FLIPPED_POSE``:

    JAX_PLATFORMS=cpu python tests/test_torch_multistart.py

registers eight golden-shape pairs (4167 points) under candidate poses
through the JAX package (plain CPU route, float32, ``se3_pt2pl``,
``GOLDEN``), from one start and from the 8-start fleet, and prints the
misses of the 2 deg / 0.25 gate.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from se3_icp_tpu.models import multistart as j_ms  # noqa: E402
from se3_icp_tpu.utils.config import RegistrationConfig as JaxConfig  # noqa: E402

from se3_icp_tpu_torch import cli  # noqa: E402
from se3_icp_tpu_torch.datasets import fixtures  # noqa: E402
from se3_icp_tpu_torch.models import multistart as ms  # noqa: E402
from se3_icp_tpu_torch.utils import convert, metrics_host, ply  # noqa: E402

# the suite runs several worker processes side by side: keep each
# one's torch thread pool small
torch.set_num_threads(1)

BASE = dict(number_of_nn_for_lrf=90, max_num_se3_iterations=10,
            mse_switch_error=5e-5)
N_STARTS = 4    # the greedy prefix holds FLIPPED_POSE's basin (start 3)
SCORE_ATOL = 1e-3   # float32 noise of a score at the right pose


def _problems():
    return [fixtures.golden_shape_problem(seed=s, n=n,
                                          **fixtures.FLIPPED_POSE)
            for s, n in ((1, 460), (2, 400))]


def _configs(cap):
    """A unique iteration cap gives the JAX side a fresh trace (its jit
    cache keys on the static config, not on the route-selecting env)."""
    jcfg = JaxConfig(max_num_iterations=cap, **BASE)
    return jcfg, convert.config_from_dict(dataclasses.asdict(jcfg))


@pytest.mark.parametrize("n", [1, 8, 24, 30, 40])
def test_so3_grid_is_the_jax_grid(n):
    np.testing.assert_array_equal(ms.so3_grid(n, seed=3),
                                  j_ms.so3_grid(n, seed=3))
    np.testing.assert_array_equal(ms.super_fibonacci(n),
                                  j_ms.super_fibonacci(n))


def test_score_transforms_matches_jax():
    """The trimmed NN score of candidate transforms, batched over the
    candidates (one K6 call) against the JAX package's vmapped one."""
    p = _problems()[0]
    rng = np.random.default_rng(5)
    T = np.stack([p.T_gt] * 4)
    for k in range(1, 4):
        T[k, :3, :3] = T[k, :3, :3] @ fixtures.rot_3d(*rng.normal(size=3)
                                                      * 0.3)
    n = len(p.source)
    src = np.zeros((512, 3), np.float32)
    src[:n] = p.source
    tgt = np.zeros((512, 3), np.float32)
    tgt[:n] = p.target
    for overlap in (1.0, 0.8):
        want = np.asarray(j_ms._score_transforms(
            np.float32(T), src, np.int32(n), tgt, np.int32(n), overlap))
        t = lambda a: torch.as_tensor(a)
        got = ms.score_transforms(
            t(np.float32(T)), t(src).expand(4, -1, -1),
            torch.full((4,), n, dtype=torch.int32), t(tgt).expand(4, -1, -1),
            torch.full((4,), n, dtype=torch.int32), overlap)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=SCORE_ATOL)
    assert want[0] < SCORE_ATOL < 0.1 < want[1:].min()


def _hold(probs, j_res, t_res):
    for p, a, b in zip(probs, j_res, t_res):
        assert metrics_host.success(p.T_gt, a.best.transformation)
        assert metrics_host.success(p.T_gt, b.best.transformation)
        Ta, Tb = a.best.transformation, b.best.transformation
        assert metrics_host.angular_error_so3(Ta[:3, :3], Tb[:3, :3]) < 0.05
        assert np.linalg.norm(Ta[:3, 3] - Tb[:3, 3]) < 1e-3
        assert abs(a.scores[a.start_index]
                   - b.scores[b.start_index]) < SCORE_ATOL
        # several starts may share the basin: the JAX package's pick
        # scores as well as the port's own pick
        assert abs(b.scores[a.start_index]
                   - b.scores[b.start_index]) < SCORE_ATOL
        np.testing.assert_array_equal(a.rotations, b.rotations)


def _jax_fleet(pair_list, jcfg, monkeypatch, exact):
    monkeypatch.setenv("SE3_ICP_TPU_FORCE_PALLAS", "1")
    monkeypatch.setenv("SE3_ICP_TPU_PALLAS_INTERPRET", "1")
    if exact:
        monkeypatch.setenv("SE3_ICP_TPU_NO_THR_KNN", "1")
    else:
        monkeypatch.delenv("SE3_ICP_TPU_NO_THR_KNN", raising=False)
    monkeypatch.delenv("SE3_ICP_TPU_EXACT_KNN", raising=False)
    return j_ms.register_pairs_multistart(pair_list, "se3_pt2pl", jcfg,
                                          n_starts=N_STARTS, mesh=False)


@pytest.mark.parametrize("exact", [False, True], ids=["threshold", "exact"])
def test_fleet_matches_jax_on_each_setup_route(exact, monkeypatch):
    probs = _problems()
    pair_list = [(p.source, p.target) for p in probs]
    jcfg, cfg = _configs(31 if exact else 33)
    j_res = _jax_fleet(pair_list, jcfg, monkeypatch, exact)
    t_res = ms.register_pairs_multistart(pair_list, "se3_pt2pl", cfg,
                                         n_starts=N_STARTS, device="cpu",
                                         exact_knn=exact)
    _hold(probs, j_res, t_res)
    if exact:
        # the same neighbourhoods on both sides: the kept start's
        # iteration count is the JAX package's
        for a, b in zip(j_res, t_res):
            if a.start_index == b.start_index:
                assert a.best.num_iterations == b.best.num_iterations


def test_single_start_misses_and_the_fleet_keeps_the_right_start():
    """The fixture's point: from the identity the engine lands in the
    wrong basin; the fleet's kept start passes, and its score is the
    lowest by a wide margin.  One pair through the single-pair entry
    point, which is the fleet of one pair."""
    from se3_icp_tpu_torch.models import registration as reg
    p = _problems()[0]
    _, cfg = _configs(35)
    one = reg.register_pair(p.source, p.target, "se3_pt2pl", cfg,
                            device="cpu")
    assert not metrics_host.success(p.T_gt, one.transformation)
    res = ms.register_pair_multistart(p.source, p.target, "se3_pt2pl", cfg,
                                      n_starts=N_STARTS, device="cpu")
    assert metrics_host.success(p.T_gt, res.best.transformation)
    s = np.sort(res.scores)
    assert s[0] < SCORE_ATOL < 0.1 < s[1]
    assert res.scores.shape == (N_STARTS,) and res.rotations.shape == (
        N_STARTS, 3, 3)


def test_chunks_and_tail_padding_keep_each_pair_its_result():
    """Three pairs in chunks of two (the tail chunk repeats its last
    pair) give each pair the result of one chunk holding all three."""
    probs = _problems() + [fixtures.golden_shape_problem(
        seed=3, n=430, **fixtures.FLIPPED_POSE)]
    pair_list = [(p.source, p.target) for p in probs]
    _, cfg = _configs(37)
    stats = {}
    a = ms.register_pairs_multistart(pair_list, "se3_pt2pl", cfg,
                                     n_starts=N_STARTS, pair_chunk=2,
                                     device="cpu", stats=stats)
    b = ms.register_pairs_multistart(pair_list, "se3_pt2pl", cfg,
                                     n_starts=N_STARTS, device="cpu")
    assert stats["loop_steps"] > 0
    for p, x, y in zip(probs, a, b):
        assert metrics_host.success(p.T_gt, x.best.transformation)
        assert x.start_index == y.start_index
        np.testing.assert_allclose(x.best.transformation,
                                   y.best.transformation, atol=1e-5)


def test_cli_multi_start_and_its_refusals(tmp_path, capsys):
    p = fixtures.golden_shape_problem(seed=4, n=420, **fixtures.FLIPPED_POSE)
    src, tgt = tmp_path / "s.ply", tmp_path / "t.ply"
    ply.write_ply(src, p.source)
    ply.write_ply(tgt, p.target)
    cli.main(["run", "se3_pt2pl", str(src), str(tgt), "--multi-start", "4",
              "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[2].startswith("multi-start: kept start ")
    at = lines.index("Estimated transformation = ")
    T = np.asarray([[float(v) for v in ln.split()]
                    for ln in lines[at + 1:at + 5]])
    assert metrics_host.success(p.T_gt, T)
    with pytest.raises(SystemExit, match="not supported with fgr"):
        cli.main(["run", "fgr", str(src), str(tgt), "--multi-start", "4",
                  "--device", "cpu"])
    np.savetxt(tmp_path / "T0.txt", np.eye(4))
    with pytest.raises(SystemExit, match="mutually exclusive"):
        cli.main(["run", "se3_pt2pl", str(src), str(tgt), "--multi-start",
                  "4", "--initial-transform", str(tmp_path / "T0.txt"),
                  "--device", "cpu"])


# ---------------------------------------------------------------- survey

SURVEY_POSES = {
    "FLIPPED_POSE (golden yaw + pi)": fixtures.FLIPPED_POSE["rpy"],
    "rpy (2.0, -1.0, 2.5)": (2.0, -1.0, 2.5),
}


def main():
    import jax
    jax.config.update("jax_platforms", "cpu")
    from se3_icp_tpu.parallel import pairs as j_pairs
    from se3_icp_tpu.utils import config as j_config
    seeds = list(range(1, 9))
    for name, rpy in SURVEY_POSES.items():
        probs = [fixtures.golden_shape_problem(seed=s, rpy=rpy)
                 for s in seeds]
        pl = [(p.source, p.target) for p in probs]
        one = j_pairs.register_pairs(pl, "se3_pt2pl", j_config.GOLDEN,
                                     mesh=None)
        fleet = j_ms.register_pairs_multistart(
            pl, "se3_pt2pl", j_config.GOLDEN, n_starts=8, mesh=False,
            pair_chunk=1)
        err = lambda p, T: round(metrics_host.angular_error_so3(
            p.T_gt[:3, :3], T[:3, :3]), 3)
        miss1 = [s for s, p, r in zip(seeds, probs, one)
                 if not metrics_host.success(p.T_gt, r.transformation)]
        missk = [s for s, p, r in zip(seeds, probs, fleet)
                 if not metrics_host.success(p.T_gt, r.best.transformation)]
        print(f"{name}: single start misses {len(miss1)}/8 (deg off: "
              f"{[err(p, r.transformation) for p, r in zip(probs, one)]}); "
              f"8-start fleet misses {len(missk)}/8, kept starts "
              f"{[r.start_index for r in fleet]} (deg off: "
              f"{[err(p, r.best.transformation) for p, r in zip(probs, fleet)]})",
              flush=True)


if __name__ == "__main__":
    main()
