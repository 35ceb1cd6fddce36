"""Host-side (numpy/scipy, float64) metric implementations.

Reporting and the 2 deg / 0.25 success gate run here so error numbers
keep full double precision regardless of the device dtype.
Definitions identical to ``cc``/the benchmark binaries of the
reference."""

from __future__ import annotations

import numpy as np
from scipy.spatial.transform import Rotation


def angular_error_so3(R1, R2) -> float:
    """deg, ||log(R1^T R2)|| (ref:cc:32-37)."""
    M = np.asarray(R1).T @ np.asarray(R2)
    # project to nearest rotation for safety (f32 inputs)
    return float(np.degrees(Rotation.from_matrix(M).magnitude()))


def translation_error(t1, t2) -> float:
    return float(np.linalg.norm(np.asarray(t1) - np.asarray(t2)))


def rotation_frobenius_error(R1, R2) -> float:
    return float(np.linalg.norm(np.asarray(R1) - np.asarray(R2)))


def rot2euler_yzx(R) -> np.ndarray:
    """Y-Z-X Tait-Bryan with singularity branches
    (benchmark_lounge.cpp:14-52)."""
    R = np.asarray(R)
    m10 = R[1, 0]
    if m10 > 0.998:
        return np.array([0.0, np.pi / 2, np.arctan2(R[0, 2], R[2, 2])])
    if m10 < -0.998:
        return np.array([0.0, -np.pi / 2, np.arctan2(R[0, 2], R[2, 2])])
    return np.array([np.arctan2(-R[1, 2], R[1, 1]),
                     np.arcsin(np.clip(m10, -1, 1)),
                     np.arctan2(-R[2, 0], R[0, 0])])


def avg_euler_error(R1, R2) -> float:
    """(benchmark_lounge.cpp:55-81)."""
    e1 = np.degrees(rot2euler_yzx(R1))
    e2 = np.degrees(rot2euler_yzx(R2))
    e1 = np.fmod(e1, 360.0)
    e2 = np.fmod(e2, 360.0)
    diff = np.fmod(e1 - e2, 360.0)
    diff = np.where(diff > 180.0, 360.0 - diff, diff)
    return float(np.mean(np.abs(diff)))


def error_filterreg(points, T_gt, T_est) -> float:
    pts = np.asarray(points)
    a = pts @ np.asarray(T_gt)[:3, :3].T + np.asarray(T_gt)[:3, 3]
    b = pts @ np.asarray(T_est)[:3, :3].T + np.asarray(T_est)[:3, 3]
    return float(np.mean(np.linalg.norm(a - b, axis=1)))


def success(T_gt, T_est, rot_thresh=2.0, tra_thresh=0.25) -> bool:
    so3 = angular_error_so3(np.asarray(T_est)[:3, :3],
                            np.asarray(T_gt)[:3, :3])
    tra = translation_error(np.asarray(T_gt)[:3, 3],
                            np.asarray(T_est)[:3, 3])
    return (so3 <= rot_thresh) and (tra <= tra_thresh)
