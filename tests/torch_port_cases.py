"""Shared cases and helpers of the port's tests against the JAX
package: for the engine (``test_torch_registration*.py``) the
algorithm/config cases, the seed-made problems, the JAX config with its
counterpart carried across, the JAX threshold route and the hold of one
result list against the other; for the setup kernels
(``test_torch_thresholds.py``, ``test_torch_moments.py``) seed-made
clouds and exact distances."""

import dataclasses

import numpy as np
import pytest

from se3_icp_tpu.utils.config import RegistrationConfig as JaxConfig

from se3_icp_tpu_torch.datasets import fixtures
from se3_icp_tpu_torch.utils import convert, metrics_host

SMALL_POSE, NOISY = fixtures.SMALL_POSE, fixtures.NOISY
BASE = dict(number_of_nn_for_lrf=90, max_num_se3_iterations=10,
            mse_switch_error=5e-5)

# (id, algorithm, config overrides, surface, problem kwargs)
CASES = [
    ("se3_pt2pl", "se3_pt2pl", {}, "bumpy", {}),
    ("se3_gicp", "se3_gicp", {}, "bumpy", {}),
    ("se3_pt2pt", "se3_pt2pt", {}, "bumpy", {}),
    ("se3_pt2pl_trim075", "se3_pt2pl", {"estimated_overlap": 0.75},
     "bumpy", NOISY),
    ("se3_gicp_with_cf_trim075", "se3_gicp_with_cf",
     {"estimated_overlap": 0.75}, "bumpy", NOISY),
    ("icp_pt2pl", "pt2pl", {}, "room", SMALL_POSE),
    ("icp_gicp_trim08", "gicp", {"estimated_overlap": 0.8}, "room",
     SMALL_POSE),
    ("icp_pt2pt", "pt2pt", {}, "room", SMALL_POSE),
    ("se3_pure_pt2pl", "se3_pure_pt2pl",
     {"alpha_rot": 0.1, "max_num_se3_iterations": 30}, "bumpy", {}),
]
F32_CASES = ("se3_pt2pl", "se3_gicp", "se3_pt2pt", "se3_pt2pl_trim075",
             "icp_pt2pl")


def problems(kind, pkw):
    return [fixtures.golden_shape_problem(seed=s, n=n, kind=kind, **pkw)
            for s, n in ((1, 480), (2, 420))]


def configs(ckw, cap):
    """The JAX config and its counterpart carried across as a dict.  A
    unique iteration cap gives the JAX side a fresh trace: its jit cache
    keys on the static config, not on the route-selecting env."""
    jcfg = JaxConfig(max_num_iterations=cap, **{**BASE, **ckw})
    return jcfg, convert.config_from_dict(dataclasses.asdict(jcfg))


def hold(probs, j_res, t_res, ang_tol, tra_tol):
    for p, a, b in zip(probs, j_res, t_res):
        assert metrics_host.success(p.T_gt, a.transformation)
        assert metrics_host.success(p.T_gt, b.transformation)
        assert b.num_iterations == a.num_iterations
        assert b.num_pure_se3_iterations == a.num_pure_se3_iterations
        assert metrics_host.angular_error_so3(
            a.transformation[:3, :3], b.transformation[:3, :3]) < ang_tol
        assert np.linalg.norm(a.transformation[:3, 3]
                              - b.transformation[:3, 3]) < tra_tol


# --- the setup kernels' tests (test_torch_thresholds.py,
#     test_torch_moments.py): seed-made clouds, exact distances

def normal_clouds(seed, n, n_valid):
    """[B,n,3] float32 gaussian clouds, rows >= n_valid[b] zero (as the
    engine pads), and their valid counts."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(len(n_valid), n, 3)).astype(np.float32)
    for b, nv in enumerate(n_valid):
        pts[b, nv:] = 0.0
    return pts, np.asarray(n_valid, np.int32)


def exact_d2(pts, n_valid):
    """Float64 squared distances among one cloud's valid rows."""
    p = pts[:n_valid].astype(np.float64)
    return ((p[:, None, :] - p[None, :, :]) ** 2).sum(-1)


def midpoint_thresholds(pts, n_valid, counts):
    """[B,T,N] float32 thresholds halfway between the c-th and (c+1)-th
    smallest float64 squared distance (self included): no member lies
    within rounding of a boundary.  Padded rows get 0."""
    out = np.zeros((len(n_valid), len(counts), pts.shape[1]), np.float32)
    for b, nv in enumerate(n_valid):
        d2 = np.sort(exact_d2(pts[b], nv), axis=1)
        for t, c in enumerate(counts):
            out[b, t, :nv] = 0.5 * (d2[:, c - 1] + d2[:, c])
    return out


def jax_threshold_route(pair_list, alg, jcfg):
    """The JAX package's threshold route off the TPU: every Pallas
    kernel (K1-K5) through the callback-free interpret gate."""
    from se3_icp_tpu.ops import knn as j_knn
    from se3_icp_tpu.parallel import pairs as j_pairs
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SE3_ICP_TPU_FORCE_PALLAS", "1")
        mp.setenv("SE3_ICP_TPU_PALLAS_INTERPRET", "1")
        mp.delenv("SE3_ICP_TPU_NO_THR_KNN", raising=False)
        mp.delenv("SE3_ICP_TPU_EXACT_KNN", raising=False)
        assert j_knn.use_fused_match() and j_knn.use_thr_knn()
        return j_pairs.register_pairs(pair_list, alg, jcfg, mesh=None)
