"""Shared cases and helpers of the port's engine tests
(``test_torch_registration*.py``): the algorithm/config cases, the
seed-made problems, the JAX config with its counterpart carried across,
and the hold of one result list against the other."""

import dataclasses

import numpy as np

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
