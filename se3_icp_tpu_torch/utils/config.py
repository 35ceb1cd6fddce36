"""Registration configuration.

The reference exposes hyperparameters as public mutable fields on the
``IterativeSE3Registration`` object (ref:hpp:80-95) with ctor defaults at
ref:cpp:334-348.  Here they are a frozen dataclass (hashable and immutable, so one
config object can be shared by every pair of a batch).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


VARIANTS = ("pt2pt", "pt2pl", "gicp")
MODES = ("icp", "se3", "se3_cf", "se3_pure")

# Algorithm-name surface of the reference CLI
# (examples/run_registration_method.cpp:19-24, benchmark_lounge.cpp:531-543,
#  test_se3_pure.cpp:195-199).
ALGORITHMS = (
    "pt2pt", "pt2pl", "gicp",
    "se3_pt2pt", "se3_pt2pl", "se3_gicp",
    "se3_gicp_with_cf",
    "se3_pure_pt2pt", "se3_pure_pt2pl", "se3_pure_gicp",
)


def parse_algorithm(name: str) -> tuple[str, str]:
    """Algorithm name -> (mode, variant)."""
    if name not in ALGORITHMS:
        raise ValueError(
            f"Not a valid algorithm name: {name!r}. "
            f"Available names are: {', '.join(ALGORITHMS)}")
    if name == "se3_gicp_with_cf":
        return "se3_cf", "gicp"
    if name.startswith("se3_pure_"):
        return "se3_pure", name[len("se3_pure_"):]
    if name.startswith("se3_"):
        return "se3", name[len("se3_"):]
    return "icp", name


@dataclass(frozen=True)
class RegistrationConfig:
    """Hyperparameters; defaults = reference ctor (ref:cpp:334-348)."""

    # iteration caps / convergence
    max_num_iterations: int = 150
    max_num_se3_iterations: int = 20
    mse: float = 1e-5                    # ``mse_``
    mse_switch_error: float = 1e-3       # switch-to-R3 threshold
    # LRF
    number_of_nn_for_lrf: int = 30       # TOLDI kNN (benchmarks use 90)
    lrf_radius: float = 0.8              # SHOT LRF only (dormant in ref)
    # SHOT neighborhoods: exact radius semantics via the dense
    # masked-matmul path (lrf.shot_frames_dense) by default.  With
    # shot_exact=False the radius search is emulated with a top-k cap
    # (shot_max_k); neighborhoods denser than the cap are truncated and
    # register_pair warns host-side (see lrf.shot_truncated_count).
    shot_exact: bool = True
    shot_max_k: int = 128
    lrf_method: str = "toldi"            # "toldi" | "shot" (ref has SHOT
    #                                      implemented but commented out,
    #                                      ref:cpp:593-594)
    # correspondence rejection
    estimated_overlap: float = 1.0
    # SE(3) metric weights + preprocessing scale
    alpha_rot: float = 3.0
    beta_transl: float = 1.0
    scale_preprocessing: float = 3.0
    # GICP covariance epsilon (ref:cpp:498-499 passes 1e-3)
    gicp_epsilon: float = 1e-3
    # normals kNN: Open3D EstimateNormals default KNN(30); GICP init uses 20
    normals_knn: int = 30
    gicp_normals_knn: int = 20
    # Anderson acceleration window (AA-ICP, Pavlov et al. 2017,
    # arxiv 1709.05479): 0 = off (reference-parity iteration dynamics);
    # 3-5 typically halves the iteration count.  Extension beyond the
    # reference, opt-in.
    anderson_m: int = 0

    def replace(self, **kw) -> "RegistrationConfig":
        return dataclasses.replace(self, **kw)


# Per-benchmark configs used by the reference binaries.
GOLDEN = RegistrationConfig(
    estimated_overlap=1.0, max_num_se3_iterations=10, mse=1e-5,
    mse_switch_error=5e-5, number_of_nn_for_lrf=90,
)  # examples/run_registration_method.cpp:38-42

LOUNGE = RegistrationConfig(
    estimated_overlap=0.75, number_of_nn_for_lrf=90,
    mse_switch_error=5e-5, max_num_se3_iterations=10,
)  # examples/benchmark_lounge.cpp:183-186

KITTI_VANILLA = RegistrationConfig(
    estimated_overlap=0.8, number_of_nn_for_lrf=90,
    max_num_se3_iterations=10,
)  # examples/benchmark_kitti.cpp:133-143

KITTI_SE3 = RegistrationConfig(
    estimated_overlap=0.7, mse=1e-7, mse_switch_error=5e-7,
    number_of_nn_for_lrf=90, max_num_se3_iterations=10,
)  # examples/benchmark_kitti.cpp:145-148

EXTREME_NOISE = RegistrationConfig(
    estimated_overlap=1.0, max_num_iterations=100, mse=1e-9,
    number_of_nn_for_lrf=90, mse_switch_error=5e-5,
    max_num_se3_iterations=10,
)  # examples/benchmark_extreme_noise_bunny.cpp:289-296
