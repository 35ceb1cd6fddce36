"""Seed-made registration problems (numpy only, no data files).

``golden_shape_problem`` is the golden fixture's stand-in: a cloud of
4167 points (which pads to the 4608 bucket) under the ground truth of
the reference's ``create_and_save_reg_problem``
(R = rot_3d(pi/9, pi/8, -pi/7), t = (1, 2, 3)), so tests and the on-card
smoke run share one problem that needs no file.

Two procedural surfaces:

  * ``"bumpy"`` (default): a closed, asymmetric, curved surface.  Every
    local reference frame on it is well defined, as on the scanned model
    of the golden fixture; the JAX package passes the 2 deg / 0.25 gate
    on it for every seed tried (64 for ``se3_pt2pl``).
  * ``"room"``: ``_scene`` -- walls, floor and a blob, the world the
    synthetic lounge stand-in is built from.  Planar walls give
    ambiguous TOLDI x-axes: under the 30-degree golden pose the JAX
    package itself misses the gate on a few seeds there (1 of 64 for
    ``se3_pt2pl``, 2 of 16 for ``se3_gicp``; the survey is
    ``tests/test_torch_fixture_gate.py`` run as a script), so it is no
    gate fixture.  It serves kernel and setup tests, and small poses.

``make_lounge_fixture`` and ``make_kitti_fixture`` write stand-ins for
the reference's lounge and KITTI benchmark inputs (the real bundles are
a download) in their EXACT on-disk layouts, so the bench protocols
(``bench/``) -- loaders, ground-truth conventions, pair construction,
metrics -- run end to end.  They draw from numpy in the JAX package's
order, so the same seed writes the same bytes:

  lounge:  <folder>/lounge_data/%06d.ply         (frames 1..n, 1-based)
           <folder>/lounge_data/lounge_trajectory.log  (redwood format)
  kitti:   <folder>/Sequence_07/Downsampled/%06d.ply   (i = 0,2,4,...)
           <folder>/Sequence_07/07.txt  (12-number rows, EVERY raw
           frame; the loader reads every other row, matching
           examples/benchmark_kitti.cpp:79-98)

``write_bunny_standin`` writes a stand-in for the Stanford bunny that
the bunny protocols read (``datasets/synthetic.py``, the file named by
``SE3_ICP_TPU_BUNNY``): the "bumpy" surface at 1/50 of its size in a
binary-float PLY, so the protocols' x50 and 2% downsample give clouds
of the golden fixture's width and size.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from se3_icp_tpu_torch.utils import ply

GOLDEN_POINTS = 4167
GOLDEN_RPY = (np.pi / 9, np.pi / 8, -np.pi / 7)
GOLDEN_T = (1.0, 2.0, 3.0)
# ``golden_shape_problem`` keywords of the two other protocols: a pose
# within plain ICP's basin, and noisy independently resampled clouds
SMALL_POSE = dict(rpy=(0.03, 0.05, -0.04), t=(0.05, 0.02, 0.03))
NOISY = dict(noise_std=0.01, resample=True)
# the golden pose turned a half-turn further about z: out of reach of a
# single start, within reach of the 8-start fleet (multistart's fixture;
# the survey is ``tests/test_torch_multistart.py`` run as a script)
FLIPPED_POSE = dict(rpy=(GOLDEN_RPY[0], GOLDEN_RPY[1],
                         GOLDEN_RPY[2] + np.pi))


@dataclass
class RegistrationProblem:
    source: np.ndarray      # [N,3] float64
    target: np.ndarray      # [M,3] float64
    T_gt: np.ndarray        # [4,4] float64, source -> target


def _scene(rng: np.random.Generator, n: int, kind: str) -> np.ndarray:
    """A static 'world' cloud with structure (walls/floor-ish planes +
    blobs) so normals, LRFs, and GICP covariances are informative."""
    if kind == "room":  # indoor, meters, in front of the camera
        wall = np.column_stack([
            rng.uniform(-2, 2, n // 3), rng.uniform(-1.5, 1.5, n // 3),
            np.full(n // 3, 3.0)])
        floor = np.column_stack([
            rng.uniform(-2, 2, n // 3), np.full(n // 3, -1.5),
            rng.uniform(0.8, 3.0, n // 3)])
        m = n - 2 * (n // 3)
        blob = rng.normal((0.5, 0.0, 2.0), 0.35, (m, 3))
        pts = np.concatenate([wall, floor, blob])
    else:  # "road": outdoor LiDAR-ish, tens of meters
        ground = np.column_stack([
            rng.uniform(-30, 30, n // 2), rng.uniform(-10, 10, n // 2),
            rng.normal(-1.6, 0.05, n // 2)])
        m = n - n // 2
        n_centers = max(-(-m // 25), 1)  # ceil: repeat covers all m rows
        posts = rng.normal(0, 1, (m, 3)) * (1.5, 1.5, 2.0) + np.repeat(
            rng.uniform((-25, -8, 0), (25, 8, 1), (n_centers, 3)),
            25, axis=0)[:m]
        pts = np.concatenate([ground, posts])
    # surface jitter so clouds are not perfectly planar
    return pts + rng.normal(scale=0.01, size=pts.shape)


def _bumpy_surface(rng: np.random.Generator, n: int) -> np.ndarray:
    """A closed, asymmetric, curved surface (a sphere with seed-made
    low-frequency bumps and two lobes), a few units across: curvature
    everywhere, so every local reference frame is well defined -- the
    procedural stand-in for the scanned model the golden fixture uses."""
    u = rng.normal(size=(n, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    freq = rng.uniform(1.5, 3.5, (6, 3)) * rng.choice([-1.0, 1.0], (6, 3))
    phase = rng.uniform(0, 2 * np.pi, 6)
    amp = rng.uniform(0.08, 0.2, 6)
    r = 1.0 + np.sum(amp * np.sin(u @ freq.T + phase), axis=1)
    # two lobes of different size break any residual symmetry
    for axis, gain, sharp in (((0.2, 0.5, 0.84), 0.9, 6.0),
                              ((-0.7, 0.6, 0.39), 0.5, 10.0)):
        a = np.asarray(axis) / np.linalg.norm(axis)
        r = r + gain * np.exp(sharp * (u @ a - 1.0))
    return 3.0 * (u * r[:, None]) * (1.0, 0.8, 0.65)


def rot_3d(roll: float, pitch: float, yaw: float) -> np.ndarray:
    """R = Rz(yaw) @ Ry(pitch) @ Rx(roll), float64 (``cc::rot_3d``)."""
    cr, sr = np.cos(roll), np.sin(roll)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cy, sy = np.cos(yaw), np.sin(yaw)
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1.0]])
    return Rz @ Ry @ Rx


def make_T(R: np.ndarray, t) -> np.ndarray:
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


def _cloud(rng, n, kind):
    return _bumpy_surface(rng, n) if kind == "bumpy" else _scene(rng, n, kind)


def golden_shape_problem(seed: int = 1, n: int = GOLDEN_POINTS,
                         rpy=GOLDEN_RPY, t=GOLDEN_T,
                         noise_std: float = 0.0,
                         resample: bool = False,
                         kind: str = "bumpy") -> RegistrationProblem:
    """A ``kind`` cloud of ``n`` points under the golden ground truth.

    Default: the target is the transformed source, point for point (the
    ``create_and_save_reg_problem`` protocol).  ``resample=True`` draws
    source and target as independent ``n``-point subsets of a surface
    sampled twice as densely, and ``noise_std`` adds isotropic gaussian noise to
    both -- the noisy synthetic protocol, where no point has an exact
    partner."""
    rng = np.random.default_rng(seed)
    T = make_T(rot_3d(*rpy), t)
    if resample:
        world = _cloud(rng, 2 * n, kind)
        src = world[rng.permutation(len(world))[:n]]
        tgt = world[rng.permutation(len(world))[:n]]
    else:
        src = _cloud(rng, n, kind)
        tgt = src
    tgt = tgt @ T[:3, :3].T + T[:3, 3]
    if noise_std > 0:
        src = src + rng.normal(scale=noise_std, size=src.shape)
        tgt = tgt + rng.normal(scale=noise_std, size=tgt.shape)
    return RegistrationProblem(src, tgt, T)


# ------------------------------------------------------------------
# The sequence benchmarks' stand-in datasets


def _pose(R_axis, ang, t):
    c, s = np.cos(ang), np.sin(ang)
    if R_axis == "y":
        R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    else:
        R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


def _frame_cloud(scene, pose, rng, keep=0.85):
    """World scene viewed from ``pose`` (cam->world): world->cam points,
    independently subsampled per frame (acts like sensor resampling)."""
    Rw, tw = pose[:3, :3], pose[:3, 3]
    cam = (scene - tw) @ Rw  # R^T (p - t)
    sel = rng.random(len(cam)) < keep
    return cam[sel] + rng.normal(scale=0.004, size=(sel.sum(), 3))


_GROUND_Z = -1.6


def _road_world(rng, n_objects=48, extent=140.0):
    """Analytic LiDAR world: vertical cylinders (posts/trunks/poles) on
    both sides of a ground plane at z = _GROUND_Z.  Columns: x, y,
    radius, height."""
    return np.column_stack([
        rng.uniform(-0.2 * extent, extent, n_objects),
        rng.uniform(-14.0, 14.0, n_objects),
        rng.uniform(0.15, 0.8, n_objects),
        rng.uniform(1.5, 6.0, n_objects)])


def _lidar_scan(world_cyl, pose, rng, n_rings=24, fov=(-24.8, 2.0),
                n_az=180, max_range=35.0, min_range=2.0,
                noise_floor=0.008, noise_range=0.0015,
                n_outlier_clusters=4, dynamic=None, t_frame=0.0):
    """Adversarial ray-cast LiDAR scan from ``pose`` (cam->world), the
    regime the real KITTI protocol stresses
    (examples/benchmark_kitti.cpp:102-148):

      * ring structure: ``n_rings`` discrete elevations x ``n_az``
        azimuths ray-cast against continuous geometry (ground plane +
        cylinders, with true occlusion) -- banded scan lines whose
        samples do NOT repeat between frames;
      * range gate [min_range, max_range] + ego-motion: genuine partial
        overlap between consecutive scans;
      * range-dependent noise: radial sigma = floor + slope * range;
      * outlier clusters: dense blobs of spurious returns at random
        positions, inconsistent between frames;
      * ``dynamic``: (center2d, radius, height, velocity2d) of a
        cylinder that MOVES between frames (violates the rigid model;
        the trimmed rejection must shed it).

    Returns points in the SENSOR frame (same convention as
    ``_frame_cloud``: world -> cam via R^T (p - t)).
    """
    Rw, tw = pose[:3, :3], pose[:3, 3]
    elev = np.radians(np.linspace(fov[0], fov[1], n_rings))
    az = np.linspace(0.0, 2 * np.pi, n_az, endpoint=False)
    ce, se = np.cos(elev), np.sin(elev)
    dirs = np.stack([
        np.outer(ce, np.cos(az)), np.outer(ce, np.sin(az)),
        np.broadcast_to(se[:, None], (n_rings, n_az))],
        axis=-1).reshape(-1, 3)
    d = dirs @ Rw.T                                    # world-frame rays
    k = len(d)
    s_best = np.full(k, np.inf)

    # ground plane
    down = d[:, 2] < -1e-6
    s_g = np.where(down, (_GROUND_Z - tw[2]) / np.where(down, d[:, 2], -1.0),
                   np.inf)
    s_best = np.minimum(s_best, np.where(s_g > 0, s_g, np.inf))

    cyls = [tuple(c) for c in world_cyl]
    if dynamic is not None:
        (cx, cy), rad, h, vel = dynamic
        cyls.append((cx + vel[0] * t_frame, cy + vel[1] * t_frame,
                     rad, h))
    for cx, cy, rad, h in cyls:
        oc = tw[:2] - (cx, cy)
        a = d[:, 0] ** 2 + d[:, 1] ** 2
        b = 2.0 * (oc[0] * d[:, 0] + oc[1] * d[:, 1])
        c = oc @ oc - rad * rad
        disc = b * b - 4.0 * a * c
        ok = (disc > 0) & (a > 1e-12)
        s = np.where(ok, (-b - np.sqrt(np.maximum(disc, 0.0)))
                     / np.where(ok, 2.0 * a, 1.0), np.inf)
        z_hit = tw[2] + s * d[:, 2]
        ok = ok & (s > 0) & (z_hit > _GROUND_Z) & (z_hit < _GROUND_Z + h)
        s_best = np.minimum(s_best, np.where(ok, s, np.inf))

    hit = (s_best > min_range) & (s_best < max_range)
    s = s_best[hit]
    # range noise grows with range; plus a tiny angular jitter
    s = s + rng.normal(scale=noise_floor + noise_range * s)
    pts_w = tw + s[:, None] * d[hit]
    cam = (pts_w - tw) @ Rw
    cam = cam + rng.normal(scale=0.002, size=cam.shape)
    # spurious-return clusters (vegetation/multi-path), per-frame random
    blobs = []
    for _ in range(n_outlier_clusters):
        ctr = rng.uniform((-0.5 * max_range, -0.4 * max_range, -1.0),
                          (0.5 * max_range, 0.4 * max_range, 2.5))
        blobs.append(rng.normal(ctr, 0.3, (rng.integers(15, 40), 3)))
    return np.concatenate([cam] + blobs)


def make_lounge_fixture(folder: str, n_frames: int = 21,
                        n_points: int = 2000, seed: int = 7,
                        hard: bool = False) -> None:
    """Write a lounge-layout dataset: slowly rotating/translating RGB-D
    camera in a room; positive depths so the with_cf confidence model
    (ref:cpp:16-30) gets realistic z values.  ``hard=True`` adds the
    RGB-D stereo error model (noise ~ depth^2) and spurious blobs."""
    rng = np.random.default_rng(seed)
    scene = _scene(rng, n_points, "room")
    out = os.path.join(folder, "lounge_data")
    os.makedirs(out, exist_ok=True)
    mats = []
    for i in range(n_frames):
        ang = 0.012 * i
        t = np.array([0.02 * i, 0.002 * i, 0.01 * i])
        pose = _pose("y", ang, t)
        mats.append(pose)
        cloud = _frame_cloud(scene, pose, rng)
        if hard:
            # RGB-D stereo error model (noise ~ depth^2, the regime the
            # with_cf confidence model down-weights) + spurious blobs
            z = np.clip(cloud[:, 2], 0.4, None)
            cloud = cloud + rng.normal(
                size=cloud.shape) * (0.0015 * z * z)[:, None]
            blobs = [rng.normal(rng.uniform((-2, -1.5, 0.8), (2, 1.5, 3)),
                                0.15, (rng.integers(10, 25), 3))
                     for _ in range(3)]
            cloud = np.concatenate([cloud] + blobs)
        ply.write_ply(os.path.join(out, f"{i + 1:06d}.ply"), cloud)
    ids = np.arange(len(mats))
    ply.write_redwood_log(
        os.path.join(out, "lounge_trajectory.log"),
        np.stack([ids, ids, ids + 1], axis=1), np.asarray(mats))


def make_kitti_fixture(folder: str, max_index: int = 20,
                       n_points: int = 3000, seed: int = 8,
                       hard: bool = False) -> None:
    """Write a KITTI-seq-07-layout dataset: forward-driving LiDAR with a
    slow yaw.  07.txt gets one 12-number row per RAW frame index (the
    loader keeps every other row, matching the step-2 clouds).

    ``hard=True`` switches to the adversarial scan model
    (``_lidar_scan``): ring-pattern elevation sampling, range-gated
    partial overlap (~60-80% between consecutive kept frames at the
    faster ego-motion used here), range-dependent noise, per-frame
    outlier clusters, and a moving-object patch.  Its world
    (``_road_world``) ends at x = 140 m and the sensor moves 1.5 m a raw
    frame, so past raw frame ~90 a scan holds little but the ground
    plane and the outlier blobs."""
    rng = np.random.default_rng(seed)
    if hard:
        world = _road_world(rng)
        n_az = max(64, n_points // 8)
    else:
        scene = _scene(rng, n_points, "road")
    out = os.path.join(folder, "Sequence_07")
    os.makedirs(os.path.join(out, "Downsampled"), exist_ok=True)
    step_t = 1.5 if hard else 0.25
    poses_all = []
    for raw in range(max_index + 2):
        ang = (0.008 if hard else 0.004) * raw
        t = np.array([step_t * raw, 0.01 * raw, 0.0])
        poses_all.append(_pose("z", ang, t))
    dyn = ((12.0, 4.0), 0.9, 1.6, (2.0, 0.1))
    for i in range(0, max_index + 1, 2):
        if hard:
            cloud = _lidar_scan(world, poses_all[i], rng, n_az=n_az,
                                dynamic=dyn, t_frame=float(i))
        else:
            cloud = _frame_cloud(scene, poses_all[i], rng)
        ply.write_ply(
            os.path.join(out, "Downsampled", f"{i:06d}.ply"), cloud)
    ply.write_trajectory_12col(os.path.join(out, "07.txt"),
                               np.asarray(poses_all))


BUNNY_POINTS = 208_353      # the Stanford bunny's vertex count


def write_bunny_standin(path: str, n_points: int = BUNNY_POINTS,
                        seed: int = 11) -> None:
    """Write the bunny stand-in: ``n_points`` of the "bumpy" surface
    scaled by 1/50 (the protocols scale the bunny by 50), as a
    binary-float PLY like the scanned model's.  With the default count
    the protocols' 2% downsample keeps 4,167 points, the golden width."""
    rng = np.random.default_rng(seed)
    folder = os.path.dirname(path)
    if folder:
        os.makedirs(folder, exist_ok=True)
    ply.write_ply(path, _bumpy_surface(rng, n_points) / 50.0,
                  dtype="float")
