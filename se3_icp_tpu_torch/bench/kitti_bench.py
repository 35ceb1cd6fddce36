"""KITTI sequence 07 scan-to-scan benchmark (examples/benchmark_kitti.cpp).

Port of the JAX package's ``bench/kitti_bench.py``.  Protocol: clouds
``Sequence_07/Downsampled/%06d.ply`` for i = 0..1100 step 2 (551 clouds
-> 550 pairs, :101-107,120); GT poses from ``07.txt`` reading EVERY
OTHER line to match the step-2 clouds (:79-98); source = cloud[i+1],
target = cloud[i] (:130-131); per-method configs (:133-148): vanilla
overlap 0.8; se3 overlap 0.7, mse 1e-7, switch 5e-7, max_se3 10, LRF
k=90.  Metrics (:199-206): mean/max relative + absolute rotation (SO3
deg) and translation errors, last-frame drift, avg time.

Every entry point runs on the card unless the caller passes
``device='cpu'``; ``exact_knn`` takes the exact sorted-kNN setup, as in
``parallel.pairs.register_pairs``."""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from se3_icp_tpu_torch.bench import common
from se3_icp_tpu_torch.utils import metrics_host, ply
from se3_icp_tpu_torch.utils.config import KITTI_SE3, KITTI_VANILLA


def _find_velodyne(folder: str):
    """Locate a raw-odometry layout: returns (velodyne_dir, poses_path)
    or None.  Accepts the official bundle rooted at the sequence dir
    (``<folder>/velodyne`` + ``<folder>/07.txt``), the odometry tree
    (``<folder>/sequences/07/velodyne`` + ``<folder>/poses/07.txt``),
    and the reference bundle's naming (``<folder>/Sequence_07/velodyne``
    + ``<folder>/Sequence_07/07.txt``)."""
    candidates = [
        (os.path.join(folder, "velodyne"),
         os.path.join(folder, "07.txt")),
        (os.path.join(folder, "sequences", "07", "velodyne"),
         os.path.join(folder, "poses", "07.txt")),
        (os.path.join(folder, "Sequence_07", "velodyne"),
         os.path.join(folder, "Sequence_07", "07.txt")),
    ]
    for vdir, pfile in candidates:
        if (os.path.isdir(vdir)
                and os.path.isfile(os.path.join(vdir, "000000.bin"))
                and os.path.isfile(pfile)):
            return vdir, pfile
    return None


def load_kitti(folder: str, max_index=1100, step=2, voxel=0.0):
    """Load the KITTI seq-07 protocol clouds + poses.

    Two on-disk layouts:
      * the reference's bundle (``Sequence_07/Downsampled/%06d.ply`` at
        step-2 indices): poses from ``07.txt`` reading EVERY OTHER line
        to match (benchmark_kitti.cpp:79-98); ``step`` indexes the
        step-2 files (default 2 = the 550-pair protocol);
      * a RAW odometry bundle (``velodyne/%06d.bin`` float32 x,y,z,r +
        full-rate ``07.txt``; see ``_find_velodyne`` for accepted
        roots): poses are read at FULL RATE -- every i-th line pairs
        with scan i -- and ``step`` strides scans directly (step=2
        reproduces the reference protocol's every-other-scan pairing);
        ``voxel`` > 0 applies Open3D-style voxel-centroid downsampling
        per scan (the reference bundle ships pre-downsampled clouds;
        ~0.3 m reproduces its ~15k density).  Example:

          python -m se3_icp_tpu_torch bench-kitti se3_pt2pl \\
              ~/kitti/sequences/07_root --voxel 0.3
    """
    raw = _find_velodyne(folder)
    if raw is not None:
        vdir, pfile = raw
        poses_full = ply.read_trajectory_12col(pfile)
        clouds, poses = [], []
        for i in range(0, max_index + 1, step):
            path = os.path.join(vdir, f"{i:06d}.bin")
            if not os.path.isfile(path) or i >= len(poses_full):
                break
            pts = ply.read_velodyne_bin(path)
            if voxel > 0:
                pts = ply.voxel_downsample(pts, voxel)
            clouds.append(pts)
            poses.append(poses_full[i])
        return clouds, np.asarray(poses)
    poses = ply.read_trajectory_12col(
        os.path.join(folder, "Sequence_07", "07.txt"))
    poses = poses[::2]  # every other line (benchmark_kitti.cpp:79-98)
    clouds = []
    for i in range(0, max_index + 1, step):
        path = os.path.join(folder, "Sequence_07", "Downsampled",
                            f"{i:06d}.ply")
        clouds.append(ply.read_ply(path).points)
    return clouds, poses


def analyze_kitti(folder: str, max_index=1100, device="cuda"):
    """The reference's dormant KITTI dataset analyses
    (benchmark_kitti.cpp:395-585, commented out in main :615-617):

      * registration difficulty: mean NN distance of each pair BEFORE
        and AFTER the GT transform, plus a top-70% trimmed mean to
        suppress non-overlap outliers
        (evaluate_kitti_registration_difficulty);
      * Chamfer distance (Fan et al. squared form) of the GT-aligned
        pairs (evaluate_lounge_avg_chamfer_distance -- the reference
        reuses the lounge analysis on the KITTI folder).

    NN distances run on the device through the 1-NN kernel K9; clouds
    pad to one shared bucket, so every search has one shape."""
    from se3_icp_tpu_torch.models import registration as reg

    clouds, poses = load_kitti(folder, max_index)
    nb = reg._bucket(max(len(c) for c in clouds))
    search = common.nn_distance_fn(device)

    def nn_d(q, t):
        qp = np.zeros((nb, 3), np.float32)
        qp[:len(q)] = q
        tp = np.zeros((nb, 3), np.float32)
        tp[:len(t)] = t
        tv = np.arange(nb) < len(t)
        return search(qp, tp, tv)[:len(q)]

    start_d, avg_d, avg_d70, avg_ch = [], [], [], []
    for i in range(len(clouds) - 1):
        src, tgt = clouds[i + 1], clouds[i]
        gt = np.linalg.inv(poses[i]) @ poses[i + 1]
        start, after, top70, ch = common.alignment_difficulty(
            src, tgt, gt, nn_d)
        start_d.append(start)
        avg_d.append(after)
        avg_d70.append(top70)
        avg_ch.append(ch)
        print(f"starting_distance mean =  {start_d[-1]}")
        print(f"after_transform_distance mean =  {avg_d[-1]}")
        print(f"after_transform_distance mean (top 70%) =  {avg_d70[-1]}")
        print("---------------------------------------------")
    report = {
        "num_pairs": len(clouds) - 1,
        "avg_starting_distance": float(np.mean(start_d)),
        "avg_point_cloud_distance": float(np.mean(avg_d)),
        "avg_point_cloud_distance_top70": float(np.mean(avg_d70)),
        "avg_chamfer_distance": float(np.mean(avg_ch)),
    }
    print("=============================================")
    print(f"Overall average point cloud distance = "
          f"{report['avg_point_cloud_distance']}")
    print(f"Overall average point cloud distance (top 70%) = "
          f"{report['avg_point_cloud_distance_top70']}")
    print(f"Overall average chamfer distance = "
          f"{report['avg_chamfer_distance']}")
    return report


def kitti_alpha_sweep(algorithm: str, folder: str, out_file=None,
                      max_index=1100, dtype=np.float32, device="cuda",
                      exact_knn: bool = False):
    """benchmark_different_rot_scales (benchmark_kitti.cpp:387-393):
    the full hybrid alpha grid over the KITTI protocol, one captured
    program for every alpha."""
    reports = []
    for alpha in common.hybrid_alpha_grid():
        rep = benchmark_kitti(algorithm, folder, rot_alpha=alpha,
                              max_index=max_index, dtype=dtype,
                              device=device, exact_knn=exact_knn)
        reports.append(rep)
        if out_file:
            with open(out_file, "w") as f:
                json.dump(reports, f, indent=1)
    return reports


def _run_pairs_online(pairs, algorithm, cfg, dtype=np.float32,
                      verbose=True, device="cuda", exact_knn=False):
    """Serial online odometry: frames arrive one at a time and each
    registration warm-starts from the PREVIOUS pair's relative transform
    (constant-velocity assumption -- scan-to-scan motion is smooth at
    sensor rate).  This is the single-pair LATENCY path; the batched
    ``common.run_pairs`` is the THROUGHPUT path.  The first pair runs
    cold.  On the card the warm start is an input buffer of the captured
    program (``models/program.py``).  Returns the same
    {index: PairOutcome} surface as run_pairs."""
    from se3_icp_tpu_torch.models import registration as reg

    tdt = torch.float64 if np.dtype(dtype) == np.float64 else torch.float32
    out = {}
    T_prev = None
    for i, (s, t) in enumerate(pairs):
        t0 = time.perf_counter()
        r = reg.register_pair(s, t, algorithm, cfg, dtype=tdt,
                              initial_T=T_prev, device=device,
                              exact_knn=exact_knn)
        wall = (time.perf_counter() - t0) * 1e3
        T_prev = r.transformation
        out[i] = common.PairOutcome(i, r.transformation,
                                    r.num_iterations,
                                    r.num_pure_se3_iterations, wall)
        if verbose and (i < 3 or (i + 1) % 50 == 0):
            print(f"  online frame {i}: {wall:.1f} ms, "
                  f"{r.num_iterations} iters")
    return out


def benchmark_kitti(algorithm: str, folder: str, rot_alpha=3.0,
                    checkpoint=None, dtype=np.float32, max_index=1100,
                    save_traj=None, online=False, voxel=0.0,
                    device="cuda", exact_knn: bool = False):
    """``save_traj``: optional path; writes the estimated ABSOLUTE
    trajectory (accumulated scan-to-scan transforms, one 12-number row
    per kept frame, same format as 07.txt) for ``eval-traj``.

    ``online``: serial frame-at-a-time processing with a constant-
    velocity warm start from the previous pair (see
    ``_run_pairs_online``); reports latency instead of batched
    throughput.

    ``voxel``: per-scan voxel downsampling for RAW velodyne bundles
    (see ``load_kitti``); ignored for the pre-downsampled PLY layout."""
    clouds, poses = load_kitti(folder, max_index, voxel=voxel)
    # source = cloud[i+1], target = cloud[i] (:130-131)
    pairs = [(clouds[i + 1], clouds[i]) for i in range(len(clouds) - 1)]
    cfg = (KITTI_VANILLA if algorithm in ("pt2pt", "pt2pl", "gicp")
           else KITTI_SE3).replace(alpha_rot=rot_alpha)
    if online:
        if algorithm == "fgr":
            raise ValueError("--online warm starts do not apply to fgr "
                             "(a global method)")
        if checkpoint:
            print("warning: --checkpoint is not supported with --online "
                  "(serial warm-started runs are not resumable); "
                  "running without a checkpoint")
        outcomes = _run_pairs_online(pairs, algorithm, cfg, dtype=dtype,
                                     device=device, exact_knn=exact_knn)
    else:
        outcomes = common.run_pairs(pairs, algorithm, cfg,
                                    checkpoint=checkpoint, dtype=dtype,
                                    device=device, exact_knn=exact_knn)

    rel_rot, rel_tra, abs_rot, abs_tra, times = [], [], [], [], []
    traj = [np.eye(4)]
    T_acc = np.eye(4)
    for i in range(len(pairs)):
        o = outcomes[i]
        gt = np.linalg.inv(poses[i]) @ poses[i + 1]
        rel_rot.append(metrics_host.angular_error_so3(
            o.T_est[:3, :3], gt[:3, :3]))
        rel_tra.append(metrics_host.translation_error(
            o.T_est[:3, 3], gt[:3, 3]))
        T_acc = T_acc @ o.T_est
        traj.append(T_acc)
        abs_rot.append(metrics_host.angular_error_so3(
            T_acc[:3, :3], poses[i + 1][:3, :3]))
        abs_tra.append(metrics_host.translation_error(
            T_acc[:3, 3], poses[i + 1][:3, 3]))
        times.append(o.wall_ms)
    if save_traj:
        ply.write_trajectory_12col(save_traj, np.asarray(traj))
    report = {
        "algorithm": algorithm,
        "num_pairs": len(pairs),
        "mean_rel_rot": float(np.mean(rel_rot)),
        "max_rel_rot": float(np.max(rel_rot)),
        "mean_rel_tra": float(np.mean(rel_tra)),
        "max_rel_tra": float(np.max(rel_tra)),
        "mean_abs_rot": float(np.mean(abs_rot)),
        "max_abs_rot": float(np.max(abs_rot)),
        "mean_abs_tra": float(np.mean(abs_tra)),
        "max_abs_tra": float(np.max(abs_tra)),
        "last_frame_rot_error": float(abs_rot[-1]),
        "last_frame_tra_error": float(abs_tra[-1]),
        # per-pair success under the trajectory-quality rule
        # (cc::evaluate_trajectory_quality, 2 deg / 0.25)
        "success_rate": float(np.mean(
            (np.asarray(rel_rot) < 2.0) & (np.asarray(rel_tra) < 0.25))),
        "avg_time_ms": float(np.mean(times)),
        # steady-state per-pair time: the mean carries the captures of
        # new program keys (the first batch; in the online loop each new
        # pair of bucket widths), the median does not
        "median_time_ms": float(np.median(times)),
        "mean_iterations": float(np.mean(
            [outcomes[i].num_iterations for i in range(len(pairs))])),
        "online": bool(online),
    }
    print(f"===== Kitti sequence 07 results of algorithm: "
          f"{algorithm} =====")
    print(f"Mean(max) REL rot error = {report['mean_rel_rot']} "
          f"({report['max_rel_rot']})")
    print(f"Mean(max) REL tra error = {report['mean_rel_tra']} "
          f"({report['max_rel_tra']})")
    print(f"Mean(max) ABS rot error = {report['mean_abs_rot']} "
          f"({report['max_abs_rot']})")
    print(f"Mean(max) ABS tra error = {report['mean_abs_tra']} "
          f"({report['max_abs_tra']})")
    print(f"Last frame rot error    = {report['last_frame_rot_error']}")
    print(f"Last frame tra error    = {report['last_frame_tra_error']}")
    print(f"Avg time = {report['avg_time_ms']:.2f} ms "
          f"(median {report['median_time_ms']:.2f} ms)")
    return report
