"""The gate fixture itself: ``golden_shape_problem`` must be a problem
the JAX package solves, so that a missed 2 deg / 0.25 gate in the port's
on-card run can only be a fault of the port.  (The full-size hold of
both packages on it is in ``test_torch_registration.py``.)

Run as a script, this file is the survey behind the choice of surface:

    JAX_PLATFORMS=cpu python tests/test_torch_fixture_gate.py

registers many seeds of the "bumpy" and the "room" surface through the
JAX package (plain CPU route, float32) and prints, per algorithm and
surface, the seeds that miss the gate and the mean iteration count.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from se3_icp_tpu.parallel import pairs as j_pairs  # noqa: E402
from se3_icp_tpu.utils import config as j_config  # noqa: E402

from se3_icp_tpu_torch.datasets import fixtures  # noqa: E402
from se3_icp_tpu_torch.utils import metrics_host  # noqa: E402

from torch_port_cases import NOISY, SMALL_POSE  # noqa: E402


def test_golden_shape_problem_is_seed_made_and_well_formed():
    """Same seed, same clouds; the target is the source under the golden
    ground truth; no duplicate points (exact ties would be averaged by
    the match); the noisy variant shares no point between the clouds."""
    p = fixtures.golden_shape_problem(seed=7)
    q = fixtures.golden_shape_problem(seed=7)
    assert p.source.shape == p.target.shape == (fixtures.GOLDEN_POINTS, 3)
    np.testing.assert_array_equal(p.source, q.source)
    np.testing.assert_array_equal(p.target, q.target)
    R = fixtures.rot_3d(*fixtures.GOLDEN_RPY)
    np.testing.assert_allclose(p.T_gt[:3, :3], R, atol=0)
    np.testing.assert_allclose(p.T_gt[:3, 3], fixtures.GOLDEN_T, atol=0)
    np.testing.assert_allclose(p.target, p.source @ R.T + fixtures.GOLDEN_T,
                               atol=1e-12)
    for kind in ("bumpy", "room"):
        c = fixtures.golden_shape_problem(seed=3, n=500, kind=kind).source
        assert len(np.unique(c, axis=0)) == len(c)
    n = fixtures.golden_shape_problem(seed=7, n=500, noise_std=0.01,
                                      resample=True)
    back = (n.target - n.T_gt[:3, 3]) @ n.T_gt[:3, :3]
    d = np.linalg.norm(back[:, None] - n.source[None], axis=-1).min(1)
    assert d.min() > 0 and np.median(d) < 0.5


def survey(algorithm, cfg, seeds, batch=16, **problem_kw):
    """Register ``seeds`` through the JAX package; returns (misses as
    (seed, rotation error in deg), mean iterations, max iterations)."""
    misses, iters = [], []
    for s0 in range(0, len(seeds), batch):
        chunk = seeds[s0:s0 + batch]
        probs = [fixtures.golden_shape_problem(seed=s, **problem_kw)
                 for s in chunk]
        res = j_pairs.register_pairs([(p.source, p.target) for p in probs],
                                     algorithm, cfg, mesh=None)
        for s, p, r in zip(chunk, probs, res):
            iters.append(r.num_iterations)
            if not metrics_host.success(p.T_gt, r.transformation):
                misses.append((s, round(metrics_host.angular_error_so3(
                    p.T_gt[:3, :3], r.transformation[:3, :3]), 2)))
    return misses, float(np.mean(iters)), max(iters)


def main():
    import jax
    jax.config.update("jax_platforms", "cpu")
    s64, s16 = list(range(1, 65)), list(range(1, 17))
    rows = [
        ("se3_pt2pl", "GOLDEN", s64, {}),
        ("se3_gicp", "GOLDEN", s16, {}),
        ("se3_pt2pt", "GOLDEN", s16, {}),
        ("se3_pt2pl", "LOUNGE", s16, NOISY),
        ("se3_gicp", "LOUNGE", s16, NOISY),
        ("se3_gicp_with_cf", "LOUNGE", s16, NOISY),
        ("pt2pl", "GOLDEN", s16, {}),
        ("pt2pl", "GOLDEN", s16, SMALL_POSE),
    ]
    for kind in ("bumpy", "room"):
        for alg, cfg_name, seeds, kw in rows:
            misses, mean_it, max_it = survey(
                alg, getattr(j_config, cfg_name), seeds, kind=kind, **kw)
            print(f"{kind:5s} {alg:17s} {cfg_name:6s} {kw or ''} "
                  f"seeds 1..{len(seeds)}: {len(misses)} miss the gate "
                  f"{misses}, mean {mean_it:.2f} / max {max_it} iterations",
                  flush=True)


if __name__ == "__main__":
    main()
