"""Synthetic registration problems of the bunny protocols (numpy only).

Port of the JAX package's ``datasets/synthetic.py``, the reference's
generators:

  * ``golden_like_problem`` (create_and_save_reg_problem.cpp:14-62):
    bunny x50, seeded 2% random downsample, fixed GT;
  * ``synthetic_problem`` (benchmark_synthetic.cpp:91-182): a random
    rigid GT per case from the easy / moderate / difficult ranges, an
    independent target downsample, isotropic gaussian noise;
  * ``extreme_noise_problem`` (benchmark_extreme_noise_bunny.cpp:
    372-401): noise std as a fraction of the cloud's diameter.

They draw from numpy in the JAX package's order, so the same seed gives
the same bytes.  The bunny is read from the PLY file that the
``SE3_ICP_TPU_BUNNY`` environment variable names, at call time;
``datasets/fixtures.write_bunny_standin`` writes a seed-made stand-in.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from se3_icp_tpu_torch.utils import ply
from se3_icp_tpu_torch.utils.ply import voxel_downsample  # noqa: F401

BUNNY_ENV = "SE3_ICP_TPU_BUNNY"
# the reference checkout's scanned model, relative to the working
# directory, when the variable is not set
DEFAULT_BUNNY = os.path.join("reference", "stanford_bunny.ply")

# perturbation ranges (benchmark_synthetic.cpp:106-116)
DIFFICULTY = {
    "easy": (5.0, np.pi / 4),
    "moderate": (10.0, np.pi / 2),
    "difficult": (15.0, np.pi),
}


@dataclass
class RegistrationProblem:
    source: np.ndarray
    target: np.ndarray
    T_gt: np.ndarray


def bunny_path() -> str:
    return os.environ.get(BUNNY_ENV, DEFAULT_BUNNY)


def _rot_3d(roll, pitch, yaw):
    from scipy.spatial.transform import Rotation
    return Rotation.from_euler("xyz", [roll, pitch, yaw]).as_matrix()


def load_bunny(scale: float = 50.0) -> np.ndarray:
    """The bunny's points times ``scale``; a missing file raises by its
    path and the variable that names it."""
    path = bunny_path()
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"bunny PLY not found at {path!r}: set {BUNNY_ENV} to the "
            "Stanford bunny, or to a stand-in written by "
            "se3_icp_tpu_torch.datasets.fixtures.write_bunny_standin")
    return ply.read_ply(path).points * scale


def random_downsample(points: np.ndarray, ratio: float,
                      rng: np.random.Generator) -> np.ndarray:
    """Open3D RandomDownSample analog: floor(ratio*N) points drawn
    without replacement."""
    n = int(len(points) * ratio)
    idx = rng.permutation(len(points))[:n]
    return points[idx]


def add_noise(points: np.ndarray, diag_cov: float,
              rng: np.random.Generator) -> np.ndarray:
    """Isotropic gaussian noise N(0, diag_cov * I)
    (benchmark_synthetic.cpp:13-56)."""
    return points + rng.normal(scale=np.sqrt(diag_cov), size=points.shape)


def golden_like_problem(seed: int = 1) -> RegistrationProblem:
    """The create_and_save_reg_problem protocol: one downsample for both
    clouds, GT = (rot_3d(pi/9, pi/8, -pi/7), t = (1, 2, 3))."""
    rng = np.random.default_rng(seed)
    src = random_downsample(load_bunny(), 0.02, rng)
    T = np.eye(4)
    T[:3, :3] = _rot_3d(np.pi / 9, np.pi / 8, -np.pi / 7)
    T[:3, 3] = (1.0, 2.0, 3.0)
    tgt = src @ T[:3, :3].T + T[:3, 3]
    return RegistrationProblem(src, tgt, T)


def synthetic_problem(difficulty: str = "moderate",
                      diag_cov_noise: float = 0.005,
                      seed: int = 1) -> RegistrationProblem:
    """One case of the noisy synthetic protocol
    (benchmark_synthetic.cpp:139-158): source = seeded 2% downsample of
    bunny x50; target = an independent downsample of the GT-moved bunny;
    both noised."""
    rng = np.random.default_rng(seed)
    bunny = load_bunny()
    t_range, r_range = DIFFICULTY[difficulty]
    t = rng.uniform(-t_range, t_range, 3)
    R = _rot_3d(*rng.uniform(-r_range, r_range, 3))
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = R, t
    src = random_downsample(bunny, 0.02, rng)
    tgt = random_downsample(bunny @ R.T + t, 0.02, rng)
    src = add_noise(src, diag_cov_noise, rng)
    tgt = add_noise(tgt, diag_cov_noise, rng)
    return RegistrationProblem(src, tgt, T)


def extreme_noise_problem(noise_level: float, rot_deg: float = 50.0,
                          seed: int = 1) -> RegistrationProblem:
    """The extreme-noise protocol (benchmark_extreme_noise_bunny.cpp:
    372-382): a z rotation of ``rot_deg``, noise std = noise_level x the
    cloud's diameter."""
    rng = np.random.default_rng(seed)
    src = random_downsample(load_bunny(), 0.02, rng)
    diameter = np.linalg.norm(src.max(0) - src.min(0))
    T = np.eye(4)
    T[:3, :3] = _rot_3d(0.0, 0.0, np.radians(rot_deg))
    tgt = src @ T[:3, :3].T
    std = noise_level * diameter
    if std > 0:
        src = src + rng.normal(scale=std, size=src.shape)
        tgt = tgt + rng.normal(scale=std, size=tgt.shape)
    return RegistrationProblem(src, tgt, T)


def save_problem_folder(folder: str, problems: list[RegistrationProblem]):
    """Write source{i}.ply / target{i}.ply / gt_data, the reference's
    saved-data layout (benchmark_synthetic.cpp:162-182, 300-339)."""
    os.makedirs(folder, exist_ok=True)
    with open(os.path.join(folder, "gt_data"), "w") as f:
        for i, p in enumerate(problems):
            ply.write_ply(os.path.join(folder, f"source{i}.ply"), p.source)
            ply.write_ply(os.path.join(folder, f"target{i}.ply"), p.target)
            f.write(" ".join(f"{v:.8f}" for v in p.T_gt[:3, :4].ravel())
                    + "\n")


def load_problem_folder(folder: str) -> list[RegistrationProblem]:
    """Read the reference's saved-data layout."""
    gt = ply.read_trajectory_12col(os.path.join(folder, "gt_data"))
    out = []
    i = 0
    while True:
        sp = os.path.join(folder, f"source{i}.ply")
        tp = os.path.join(folder, f"target{i}.ply")
        if not (os.path.exists(sp) and os.path.exists(tp) and i < len(gt)):
            break
        out.append(RegistrationProblem(
            ply.read_ply(sp).points, ply.read_ply(tp).points, gt[i]))
        i += 1
    return out
