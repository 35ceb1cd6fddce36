"""The deployments' point clouds, made from seeds in memory.

Frozen copies of the generators the port's fixtures use
(``se3_icp_tpu_torch/datasets/fixtures.py``): the "bumpy" surface of the
golden problem, and the road world, poses and frame subsampling of the
KITTI stand-in.  They are copied, not imported, so that no change to
the program can change the benchmark's inputs.  They write no files.
"""

from __future__ import annotations

import numpy as np

GOLDEN_RPY = (np.pi / 9, np.pi / 8, -np.pi / 7)
GOLDEN_T = (1.0, 2.0, 3.0)


def rot_3d(roll: float, pitch: float, yaw: float) -> np.ndarray:
    """R = Rz(yaw) @ Ry(pitch) @ Rx(roll), float64."""
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


def bumpy_surface(rng: np.random.Generator, n: int) -> np.ndarray:
    """A closed, asymmetric, curved surface (a sphere with seed-made
    low-frequency bumps and two lobes), a few units across."""
    u = rng.normal(size=(n, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    freq = rng.uniform(1.5, 3.5, (6, 3)) * rng.choice([-1.0, 1.0], (6, 3))
    phase = rng.uniform(0, 2 * np.pi, 6)
    amp = rng.uniform(0.08, 0.2, 6)
    r = 1.0 + np.sum(amp * np.sin(u @ freq.T + phase), axis=1)
    for axis, gain, sharp in (((0.2, 0.5, 0.84), 0.9, 6.0),
                              ((-0.7, 0.6, 0.39), 0.5, 10.0)):
        a = np.asarray(axis) / np.linalg.norm(axis)
        r = r + gain * np.exp(sharp * (u @ a - 1.0))
    return 3.0 * (u * r[:, None]) * (1.0, 0.8, 0.65)


def golden_problem(seed: int, n: int, rpy=GOLDEN_RPY, t=GOLDEN_T):
    """(source [n,3], target [n,3], T_gt [4,4]): the bumpy surface of
    ``seed`` and its image under the golden pose, point for point (the
    reference's ``create_and_save_reg_problem`` protocol)."""
    rng = np.random.default_rng(seed)
    T = make_T(rot_3d(*rpy), t)
    src = bumpy_surface(rng, n)
    return src, src @ T[:3, :3].T + T[:3, 3], T


def road_scene(rng: np.random.Generator, n: int) -> np.ndarray:
    """The outdoor world of the KITTI stand-in: a ground plane of
    tens of metres and clusters of posts, with surface jitter."""
    ground = np.column_stack([
        rng.uniform(-30, 30, n // 2), rng.uniform(-10, 10, n // 2),
        rng.normal(-1.6, 0.05, n // 2)])
    m = n - n // 2
    n_centers = max(-(-m // 25), 1)
    posts = rng.normal(0, 1, (m, 3)) * (1.5, 1.5, 2.0) + np.repeat(
        rng.uniform((-25, -8, 0), (25, 8, 1), (n_centers, 3)),
        25, axis=0)[:m]
    pts = np.concatenate([ground, posts])
    return pts + rng.normal(scale=0.01, size=pts.shape)


def yaw_pose(ang: float, t) -> np.ndarray:
    c, s = np.cos(ang), np.sin(ang)
    return make_T(np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]]), t)


def road_poses(n_raw: int, step_t: float, yaw_step: float) -> list:
    """Camera-to-world poses of raw frames 0..n_raw-1: forward driving
    with a slow yaw."""
    return [yaw_pose(yaw_step * raw, (step_t * raw, 0.01 * raw, 0.0))
            for raw in range(n_raw)]


def frame_clouds(scene, poses, rng, keep: float, jitter) -> list:
    """The world seen from each of ``poses`` (world -> camera), each
    point kept with probability ``keep`` and jittered by rows of
    ``jitter`` [M,3] from a random offset: one new array a pose."""
    R = np.stack([p[:3, :3] for p in poses])
    t = np.stack([p[:3, 3] for p in poses])
    cam = _bmm(scene, R, -np.einsum("fj,fji->fi", t, R))
    sel = rng.random(cam.shape[:2]) < keep
    n = int(sel.sum())
    off = int(rng.integers(0, len(jitter) - n + 1))
    out = cam[sel] + jitter[off:off + n]
    return np.split(out, np.cumsum(sel.sum(1))[:-1])


def small_motions(rng, n: int, max_deg: float, max_t: float) -> np.ndarray:
    """[n,4,4] rigid motions, each of a uniform angle up to ``max_deg``
    about a uniform axis and a translation uniform in the ball of
    ``max_t``."""
    axis = rng.normal(size=(n, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    ang = np.radians(max_deg) * rng.random(n)
    K = np.zeros((n, 3, 3))
    K[:, 0, 1], K[:, 0, 2], K[:, 1, 2] = -axis[:, 2], axis[:, 1], -axis[:, 0]
    K -= K.transpose(0, 2, 1)
    T = np.repeat(np.eye(4)[None], n, 0)
    T[:, :3, :3] += (np.sin(ang)[:, None, None] * K
                     + (1 - np.cos(ang))[:, None, None] * (K @ K))
    d = rng.normal(size=(n, 3))
    T[:, :3, 3] = (d / np.linalg.norm(d, axis=1, keepdims=True) * max_t
                   * rng.random((n, 1)) ** (1 / 3))
    return T


def moved(points: np.ndarray, T: np.ndarray) -> np.ndarray:
    """[n,N,3] points each under its own [n,4,4] motion: one new array."""
    return _bmm(points, T[:, :3, :3].transpose(0, 2, 1), T[:, :3, 3])


def _bmm(points, M, t) -> np.ndarray:
    """points [n,N,3] (or one [N,3] for all) @ M [n,3,3] + t [n,3],
    float64, as one new array (torch's batched product on the host's
    cores: the traffic's clouds are made in a small share of a unit's
    time)."""
    import torch
    p = torch.from_numpy(np.ascontiguousarray(points))
    if p.dim() == 2:
        p = p.expand(len(M), *p.shape)
    return torch.baddbmm(torch.from_numpy(np.asarray(t, np.float64))[:, None],
                         p, torch.from_numpy(np.ascontiguousarray(M))).numpy()
