"""Stanford lounge RGB-D odometry benchmark (examples/benchmark_lounge.cpp).

Port of the JAX package's ``bench/lounge_bench.py``.  Protocol: frame
pairs (i, i+5) for i = 1, 6, ..., 391 (79 pairs, :154-160); GT relative
transform T12 = T2^-1 T1 from the redwood-format
``lounge_trajectory.log`` (:171-173); config overlap=0.75, LRF k=90,
switch=5e-5, max_se3=10 (:183-186); metrics: avg time / iterations /
translation / rotation-Frobenius / SO(3) / YZX-euler errors (:245-251).
Supports ``se3_gicp_with_cf`` (:206) and the alpha sweep (:396-401).

Every entry point runs on the card unless the caller passes
``device='cpu'``; ``exact_knn`` takes the exact sorted-kNN setup, as in
``parallel.pairs.register_pairs``."""

from __future__ import annotations

import json
import os

import numpy as np

from se3_icp_tpu_torch.bench import common
from se3_icp_tpu_torch.utils import metrics_host, ply
from se3_icp_tpu_torch.utils.config import LOUNGE


def _cloud_name(folder: str, i: int) -> str:
    return os.path.join(folder, "lounge_data", f"{i:06d}.ply")


def load_lounge_pairs(folder: str, start=1, stop=395, step=5):
    """Returns (pairs [(src,tgt)], gts [T12]).  Stops early when frame
    files run out, so reduced/synthetic fixtures load with the same
    protocol (the reference hard-codes 79 pairs for the full dataset,
    benchmark_lounge.cpp:154-160)."""
    traj_path = os.path.join(folder, "lounge_data", "lounge_trajectory.log")
    _, mats = ply.read_redwood_log(traj_path)
    pairs, gts = [], []
    for i in range(start, stop, step):
        if (not os.path.exists(_cloud_name(folder, i))
                or not os.path.exists(_cloud_name(folder, i + 5))
                or i - 1 + 5 >= len(mats)):
            break
        src = ply.read_ply(_cloud_name(folder, i)).points
        tgt = ply.read_ply(_cloud_name(folder, i + 5)).points
        T1 = mats[i - 1]
        T2 = mats[i - 1 + 5]
        T12 = np.linalg.inv(T2) @ T1
        pairs.append((src, tgt))
        gts.append(T12)
    return pairs, gts


def benchmark_lounge(algorithm: str, folder: str, rot_alpha=3.0,
                     checkpoint=None, dtype=np.float32, device="cuda",
                     exact_knn: bool = False):
    pairs, gts = load_lounge_pairs(folder)
    cfg = LOUNGE.replace(alpha_rot=rot_alpha)
    outcomes = common.run_pairs(pairs, algorithm, cfg,
                                checkpoint=checkpoint, dtype=dtype,
                                device=device, exact_knn=exact_knn)
    agg = dict(time=[], iters=[], tra=[], frob=[], so3=[], eul=[])
    for i, T_gt in enumerate(gts):
        o = outcomes[i]
        R_est, t_est = o.T_est[:3, :3], o.T_est[:3, 3]
        agg["time"].append(o.wall_ms)
        agg["iters"].append(o.num_iterations)
        agg["tra"].append(metrics_host.translation_error(T_gt[:3, 3], t_est))
        agg["frob"].append(
            metrics_host.rotation_frobenius_error(T_gt[:3, :3], R_est))
        agg["so3"].append(
            metrics_host.angular_error_so3(R_est, T_gt[:3, :3]))
        agg["eul"].append(metrics_host.avg_euler_error(R_est, T_gt[:3, :3]))
    report = {
        "algorithm": algorithm,
        "rot_alpha": rot_alpha,
        "num_pairs": len(pairs),
        "avg_total_time_ms": float(np.mean(agg["time"])),
        "avg_iterations": float(np.mean(agg["iters"])),
        "avg_tra_error": float(np.mean(agg["tra"])),
        "avg_rot_frob_error": float(np.mean(agg["frob"])),
        "avg_angular_SO3_error": float(np.mean(agg["so3"])),
        "avg_eul_angle_error": float(np.mean(agg["eul"])),
    }
    print(f"=== Final results of algorithm: {algorithm} ===")
    for k in ("avg_total_time_ms", "avg_iterations", "avg_tra_error",
              "avg_rot_frob_error", "avg_angular_SO3_error",
              "avg_eul_angle_error"):
        print(f"{k} = {report[k]}")
    return report


def analyze_lounge(folder: str, device="cuda"):
    """The reference's dormant dataset analyses
    (benchmark_lounge.cpp:404-515):

      * registration difficulty: mean nearest-neighbor distance of the
        GT-aligned source against the target, plus a top-70% trimmed
        mean to suppress non-overlap outliers;
      * Chamfer distance (Fan et al. CVPR 2017 squared form) of the
        GT-aligned pairs.

    NN distances run on the device through the 1-NN kernel K9
    (``ops.knn.nn_distances``).
    """
    nn_d = common.nn_distance_fn(device)
    pairs, gts = load_lounge_pairs(folder)
    avg_d, avg_d70, avg_ch = [], [], []
    for (src, tgt), T12 in zip(pairs, gts):
        _, after, top70, ch = common.alignment_difficulty(src, tgt, T12,
                                                          nn_d)
        avg_d.append(after)
        avg_d70.append(top70)
        avg_ch.append(ch)
        print(f"after_transform_distance mean =  {avg_d[-1]}")
        print(f"after_transform_distance mean (top 70%) =  {avg_d70[-1]}")
    report = {
        "num_pairs": len(pairs),
        "avg_point_cloud_distance": float(np.mean(avg_d)),
        "avg_point_cloud_distance_top70": float(np.mean(avg_d70)),
        "avg_chamfer_distance": float(np.mean(avg_ch)),
    }
    print("=============================================")
    print(f"Overall average point cloud distance = "
          f"{report['avg_point_cloud_distance']}")
    print(f"Overall average point cloud distance (top 70%) = "
          f"{report['avg_point_cloud_distance_top70']}")
    print(f"Overall average chamfer distance (lounge) = "
          f"{report['avg_chamfer_distance']}")
    return report


def lounge_alpha_sweep(algorithm: str, folder: str, out_file=None,
                       dtype=np.float32, device="cuda",
                       exact_knn: bool = False):
    """benchmark_different_rot_scales (benchmark_lounge.cpp:396-402,
    commented out in its main :552): the full hybrid alpha grid over
    the lounge protocol.  Alpha is an input of the captured program
    (``registration._TRACED_FIELDS``), so one program serves every
    alpha."""
    reports = []
    for alpha in common.hybrid_alpha_grid():
        rep = benchmark_lounge(algorithm, folder, rot_alpha=alpha,
                               dtype=dtype, device=device,
                               exact_knn=exact_knn)
        reports.append(rep)
        if out_file:
            with open(out_file, "w") as f:
                json.dump(reports, f, indent=1)
    return reports
