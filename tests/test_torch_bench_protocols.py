"""The lounge and KITTI bench protocols of the port (``bench/``) against
the JAX package's, on the CPU, on the seed-made fixtures of the JAX
package's own tests (``tests/test_bench_protocols.py``).

The port runs with ``device="cpu"`` and ``exact_knn=True`` in float64:
the JAX package's CPU route (exact sorted kNN, x64 on through
``tests/conftest.py``).  Both sides see the same neighbourhoods and the
same nearest targets, so per pair (read from each package's JSONL
checkpoint) the iteration counts are EQUAL and the transforms agree to
rounding, 1e-9 deg and 1e-10 (as ``test_torch_registration_f64.py``);
every error key of the reports agrees to 1e-9 (the time keys are left
out).

The analyses search in float32 on the port's side (K9's type), where
the JAX package searches the lounge pairs in float64 under x64 and the
KITTI pairs in float32 by another formula; a float32 search of the
shifted distance |q|^2 - 2 q.t + |t|^2 moves the reports' means by up
to ~5e-4 relative on these fixtures.  Held: (1) each query's float32
squared distance against the float64 one, within 1e-6 of
|q|^2 + max |t|^2 (a few float32 ulps of the terms the shifted form
cancels; ~1.2e-7 measured); (2) the reports with the port's own search
against the JAX package's, to 1e-3 relative; (3) the rest of the
analysis -- loaders, pairing, padding, the GT convention, the means --
to 1e-9 relative, with one exact float64 search put in both packages;
(4) the JAX tests' relations between the reported distances.
"""

import json
import os

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from se3_icp_tpu.bench import common as j_common
from se3_icp_tpu.bench import kitti_bench as j_kitti
from se3_icp_tpu.bench import lounge_bench as j_lounge
from se3_icp_tpu.ops import knn as j_knn
from se3_icp_tpu.utils.config import KITTI_VANILLA as J_KITTI_VANILLA

from se3_icp_tpu_torch.bench import common, kitti_bench, lounge_bench
from se3_icp_tpu_torch.datasets import fixtures
from se3_icp_tpu_torch.utils import metrics_host
from se3_icp_tpu_torch.utils.config import KITTI_VANILLA

torch.set_num_threads(2)

ANG_TOL, TRA_TOL = 1e-9, 1e-10
REPORT_TOL = 1e-9
TIME_KEYS = ("avg_total_time_ms", "avg_time_ms", "median_time_ms")
PORT = dict(dtype=np.float64, device="cpu", exact_knn=True)


@pytest.fixture(scope="module")
def lounge_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("lounge_fix"))
    fixtures.make_lounge_fixture(d, n_frames=11, n_points=900)
    return d


@pytest.fixture(scope="module")
def kitti_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("kitti_fix"))
    fixtures.make_kitti_fixture(d, max_index=6, n_points=900)
    return d


@pytest.fixture(scope="module")
def kitti_hard_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("kitti_hard_fix"))
    fixtures.make_kitti_fixture(d, max_index=6, n_points=1200, hard=True)
    return d


def hold_outcomes(mine: dict, theirs: dict):
    """Per pair: equal iteration counts, transforms to rounding."""
    assert sorted(mine) == sorted(theirs) and mine
    for i in mine:
        a, b = mine[i], theirs[i]
        assert a.num_iterations == b.num_iterations, (i, a, b)
        assert a.num_pure_se3_iterations == b.num_pure_se3_iterations
        Ta, Tb = np.asarray(a.T_est), np.asarray(b.T_est)
        assert metrics_host.angular_error_so3(Ta[:3, :3],
                                              Tb[:3, :3]) < ANG_TOL, i
        np.testing.assert_allclose(Ta[:3, 3], Tb[:3, 3], rtol=0,
                                   atol=TRA_TOL)


def hold_report(mine: dict, theirs: dict, tol=REPORT_TOL, rel=False):
    """Every key but the times: strings and counts equal, errors to
    ``tol`` (absolute, or relative with ``rel``)."""
    assert set(mine) == set(theirs)
    for k, v in theirs.items():
        if k in TIME_KEYS:
            continue
        if isinstance(v, float):
            np.testing.assert_allclose(mine[k], v, rtol=tol if rel else 0,
                                       atol=0 if rel else tol, err_msg=k)
        else:
            assert mine[k] == v, k


def run_both(protocol, folder, tmp_path, **kw):
    """The protocol through both packages, each with its own
    checkpoint: (port report, JAX report, port outcomes, JAX ones)."""
    fn = {"lounge": (lounge_bench.benchmark_lounge,
                     j_lounge.benchmark_lounge),
          "kitti": (kitti_bench.benchmark_kitti,
                    j_kitti.benchmark_kitti)}[protocol]
    mine, theirs = (str(tmp_path / f) for f in ("port.jsonl", "jax.jsonl"))
    rep = fn[0](folder=folder, checkpoint=mine, **PORT, **kw)
    jrep = fn[1](folder=folder, checkpoint=theirs, dtype=np.float64, **kw)
    return (rep, jrep, common.Checkpoint(mine).done,
            j_common.Checkpoint(theirs).done)


def test_lounge_protocol_matches_jax(lounge_dir, tmp_path):
    rep, jrep, mine, theirs = run_both(
        "lounge", lounge_dir, tmp_path, algorithm="se3_gicp_with_cf")
    assert rep["num_pairs"] == 2        # frames 1..11 -> (1,6), (6,11)
    hold_outcomes(mine, theirs)
    hold_report(rep, jrep)
    assert rep["avg_angular_SO3_error"] < 2.0
    assert rep["avg_tra_error"] < 0.25


def test_hard_kitti_protocol_matches_jax(kitti_hard_dir, tmp_path):
    rep, jrep, mine, theirs = run_both(
        "kitti", kitti_hard_dir, tmp_path, algorithm="se3_pt2pl",
        max_index=6)
    assert rep["num_pairs"] == 3 and not rep["online"]
    hold_outcomes(mine, theirs)
    hold_report(rep, jrep)
    assert rep["success_rate"] == 1.0, rep
    assert rep["mean_rel_rot"] < 2.0 and rep["mean_rel_tra"] < 0.25


def test_online_odometry_matches_jax(kitti_dir):
    """Serial pt2pl, each pair warm-started from the previous pair's
    transform: per pair as the JAX package's ``_run_pairs_online``; the
    online report as the JAX one, with no more iterations than the
    batched run (the JAX test's hold)."""
    clouds, _ = kitti_bench.load_kitti(kitti_dir, max_index=6)
    pair_list = [(clouds[i + 1], clouds[i]) for i in range(len(clouds) - 1)]
    mine = kitti_bench._run_pairs_online(pair_list, "pt2pl", KITTI_VANILLA,
                                         **PORT)
    theirs = j_kitti._run_pairs_online(pair_list, "pt2pl", J_KITTI_VANILLA,
                                       dtype=np.float64)
    hold_outcomes(mine, theirs)
    online = kitti_bench.benchmark_kitti("pt2pl", kitti_dir, max_index=6,
                                         online=True, **PORT)
    hold_report(online, j_kitti.benchmark_kitti(
        "pt2pl", kitti_dir, dtype=np.float64, max_index=6, online=True))
    batched = kitti_bench.benchmark_kitti("pt2pl", kitti_dir, max_index=6,
                                          **PORT)
    assert online["online"] and not batched["online"]
    assert online["mean_rel_rot"] < 2.0 and online["mean_rel_tra"] < 0.25
    assert online["mean_iterations"] <= batched["mean_iterations"]


def _exact_nn_d2(q, t, tgt_valid=None):
    """Squared 1-NN distances in float64 (a k-d tree)."""
    t = np.asarray(t, np.float64)
    if tgt_valid is not None:
        t = t[np.asarray(tgt_valid)]
    return cKDTree(t).query(np.asarray(q, np.float64))[0] ** 2


def _exact_nn_d(device):
    return lambda q, t, tgt_valid=None: np.sqrt(np.maximum(
        _exact_nn_d2(q, t, tgt_valid), 0.0))


NN_D2_REL = 1e-6
ANALYSIS_REL = 1e-3


@pytest.mark.parametrize("protocol", ["lounge", "kitti"])
def test_analyses_match_jax(protocol, lounge_dir, kitti_dir, monkeypatch):
    if protocol == "lounge":
        mine = lambda: lounge_bench.analyze_lounge(lounge_dir, device="cpu")
        theirs = lambda: j_lounge.analyze_lounge(lounge_dir)
        pair_list, gts = lounge_bench.load_lounge_pairs(lounge_dir)
    else:
        mine = lambda: kitti_bench.analyze_kitti(kitti_dir, max_index=6,
                                                 device="cpu")
        theirs = lambda: j_kitti.analyze_kitti(kitti_dir, max_index=6)
        clouds, poses = kitti_bench.load_kitti(kitti_dir, max_index=6)
        pair_list = [(clouds[i + 1], clouds[i])
                     for i in range(len(clouds) - 1)]
        gts = [np.linalg.inv(poses[i]) @ poses[i + 1]
               for i in range(len(clouds) - 1)]
    rep = mine()
    # (2) the port's own float32 search against the JAX package's
    hold_report(rep, theirs(), tol=ANALYSIS_REL, rel=True)
    assert rep["num_pairs"] == len(pair_list) == (
        2 if protocol == "lounge" else 3)
    if protocol == "kitti":
        assert (rep["avg_point_cloud_distance"]
                < 0.5 * rep["avg_starting_distance"])
    assert (rep["avg_point_cloud_distance_top70"]
            < rep["avg_point_cloud_distance"])
    assert rep["avg_chamfer_distance"] > 0.0
    # (1) the float32 search, query by query, on every GT-aligned pair
    nn_d = common.nn_distance_fn("cpu")
    for (src, tgt), gt in zip(pair_list, gts):
        moved = (src @ gt[:3, :3].T + gt[:3, 3]).astype(np.float32)
        tgt32 = tgt.astype(np.float32)
        scale = ((moved.astype(np.float64) ** 2).sum(-1)
                 + (tgt32.astype(np.float64) ** 2).sum(-1).max())
        err = np.abs(nn_d(moved, tgt32) ** 2 - _exact_nn_d2(moved, tgt32))
        assert (err <= NN_D2_REL * scale).all(), float((err / scale).max())
    # (3) one exact search in both packages: the rest of the analysis
    monkeypatch.setattr(common, "nn_distance_fn", _exact_nn_d)
    monkeypatch.setattr(j_knn, "nn_distances", _exact_nn_d2)
    hold_report(mine(), theirs(), rel=True)


def test_two_alpha_sweeps_match_jax(kitti_dir, lounge_dir, monkeypatch):
    """The rot-scale sweeps on a grid of two alphas (the JAX test's
    short grid), report by report."""
    for mod in (common, j_common):
        monkeypatch.setattr(mod, "hybrid_alpha_grid", lambda: [3.0, 100.0])
    reps = kitti_bench.kitti_alpha_sweep("se3_pt2pl", kitti_dir,
                                         max_index=6, **PORT)
    jreps = j_kitti.kitti_alpha_sweep("se3_pt2pl", kitti_dir, max_index=6,
                                      dtype=np.float64)
    assert len(reps) == len(jreps) == 2
    for a, b in zip(reps, jreps):
        hold_report(a, b)
        assert a["success_rate"] == 1.0
    reps = lounge_bench.lounge_alpha_sweep("se3_pt2pl", lounge_dir, **PORT)
    jreps = j_lounge.lounge_alpha_sweep("se3_pt2pl", lounge_dir,
                                        dtype=np.float64)
    assert [r["rot_alpha"] for r in reps] == [3.0, 100.0]
    for a, b in zip(reps, jreps):
        hold_report(a, b)
        assert a["avg_angular_SO3_error"] < 2.0


def _pair_row(route, i, r, gt, shuffle=False):
    """One surveyed pair: (table row, printed line)."""
    T = np.asarray(getattr(r, "T_est", getattr(r, "transformation", None)))
    rot = metrics_host.angular_error_so3(T[:3, :3], gt[:3, :3])
    tra = metrics_host.translation_error(T[:3, 3], gt[:3, 3])
    ok = bool(rot < 2 and tra < 0.25)
    row = dict(iterations=int(r.num_iterations), rot_deg=float(rot),
               trans=float(tra), gate=ok)
    return row, (f"{route}{' shuffled' if shuffle else ''} pair {i}: "
                 f"{r.num_iterations} iterations, {rot:.4f} deg, "
                 f"{tra:.4f}, gate {'pass' if ok else 'MISS'}")


def kitti_route_survey(route, pair_idx=None, shuffle=False, max_index=80,
                       n_points=6000, hard=True):
    """Pairs of the KITTI fixture (by default the hard one at
    ``chip_smoke.py``'s size) through one route in float32, on the CPU:
    ``jax-thr`` (the JAX package's threshold route, its accelerator
    route, every Pallas kernel in interpret mode), ``jax-exact`` (its
    CPU default), or the port's ``port-thr`` / ``port-exact``.  With
    ``pair_idx`` the chosen pairs go through ``register_pairs`` as one
    batch (``shuffle`` puts each scan's points in a seeded random order
    first); without it every pair goes through the package's own
    ``benchmark_kitti`` (batches of 32, as on the card).  Returns
    (one line a pair, {pair: iterations, errors, gate})."""
    import tempfile
    from se3_icp_tpu.parallel import pairs as j_pairs
    from se3_icp_tpu.utils.config import KITTI_SE3 as J_KITTI_SE3
    from se3_icp_tpu_torch.parallel import pairs
    from se3_icp_tpu_torch.utils.config import KITTI_SE3
    if route == "jax-thr":
        os.environ["SE3_ICP_TPU_FORCE_PALLAS"] = "1"
        os.environ["SE3_ICP_TPU_PALLAS_INTERPRET"] = "1"
    port = dict(device="cpu", exact_knn=route == "port-exact")
    res = None
    with tempfile.TemporaryDirectory() as d:
        fixtures.make_kitti_fixture(d, max_index=max_index,
                                    n_points=n_points, hard=hard)
        clouds, poses = kitti_bench.load_kitti(d, max_index=max_index)
        if pair_idx is None:
            ck = os.path.join(d, "survey.jsonl")
            if route.startswith("jax"):
                j_kitti.benchmark_kitti("se3_pt2pl", d, checkpoint=ck,
                                        max_index=max_index)
                done = j_common.Checkpoint(ck).done
            else:
                kitti_bench.benchmark_kitti("se3_pt2pl", d, checkpoint=ck,
                                            max_index=max_index, **port)
                done = common.Checkpoint(ck).done
            pair_idx = sorted(done)
            res = [done[i] for i in pair_idx]
    if shuffle:
        rng = np.random.default_rng(0)
        clouds = [c[rng.permutation(len(c))] for c in clouds]
    if res is None:
        chosen = [(clouds[i + 1], clouds[i]) for i in pair_idx]
        if route.startswith("jax"):
            res = j_pairs.register_pairs(chosen, "se3_pt2pl", J_KITTI_SE3,
                                         mesh=None)
        else:
            res = pairs.register_pairs(chosen, "se3_pt2pl", KITTI_SE3,
                                       **port)
    lines, table = [], {}
    for i, r in zip(pair_idx, res):
        gt = np.linalg.inv(poses[i]) @ poses[i + 1]
        table[i], line = _pair_row(route, i, r, gt, shuffle)
        lines.append(line)
    return lines, table


if __name__ == "__main__":
    # the route surveys behind ROADMAP section 3's KITTI findings and
    # the per-pair tables of tests/data/kitti_survey.json:
    #   PYTHONPATH=. python tests/test_torch_bench_protocols.py ROUTE
    #       [PAIR...] [--shuffle] [--max-index 80] [--n-points 6000]
    #       [--friendly] [--json OUT]
    import argparse
    import jax
    jax.config.update("jax_platforms", "cpu")
    ap = argparse.ArgumentParser()
    ap.add_argument("route", choices=["jax-thr", "jax-exact", "port-thr",
                                      "port-exact"])
    ap.add_argument("pairs", type=int, nargs="*",
                    help="pairs to run as one batch (default: the whole "
                    "protocol)")
    ap.add_argument("--shuffle", action="store_true")
    ap.add_argument("--max-index", type=int, default=80)
    ap.add_argument("--n-points", type=int, default=6000)
    ap.add_argument("--friendly", action="store_true",
                    help="the resampled road fixture (hard=False)")
    ap.add_argument("--json", help="write {pair: row} here")
    args = ap.parse_args()
    lines, table = kitti_route_survey(
        args.route, args.pairs or None, args.shuffle, args.max_index,
        args.n_points, not args.friendly)
    print("\n".join(lines), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(dict(route=args.route, max_index=args.max_index,
                           n_points=args.n_points, hard=not args.friendly,
                           dtype="float32", pairs=table), f, indent=1)
