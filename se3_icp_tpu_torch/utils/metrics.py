"""Evaluation metrics mirroring the reference's ``cc`` library and the
benchmark binaries, on torch tensors.

Port of the JAX package's ``utils/metrics.py``.  Definitions preserved:

  * SO(3) geodesic error in degrees: ``cc::angularErrorSO3`` and the
    trace-acos variant ``angularErrorSO3_alt``;
  * FilterReg point error;
  * rotation Frobenius / translation L2 errors;
  * Y-Z-X Tait-Bryan average euler-angle error;
  * squared chamfer distance (Fan et al.);
  * success: fail iff SO(3) error > 2 deg or translation error > 0.25.

Every function runs on ``device`` -- the card unless the caller passes
``device='cpu'`` -- and takes numpy arrays or tensors.  The 1-NN metrics
(``chamfer_distance_sq``, ``compute_corrs_with_gt``,
``compute_nearest_neighbor_correspondences``) search one cloud at a time
through ``knn.nn_argmin`` -- the kernel K9 on the card -- in float32,
the kernel's type.  Double-precision host reporting stays in
``metrics_host.py``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from se3_icp_tpu_torch.ops import knn
from se3_icp_tpu_torch.utils import se3

_DEG = 180.0 / math.pi


def _dev(device) -> torch.device:
    from se3_icp_tpu_torch.models.registration import resolve_device
    return resolve_device(device)


def _t(x, dev, dtype=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=dtype, device=dev)


def angular_error_so3(R1, R2, device="cuda") -> torch.Tensor:
    """deg geodesic error ||vee(log(R1^T R2))|| * 180/pi
    (``cc::angularErrorSO3``)."""
    dev = _dev(device)
    R1, R2 = _t(R1, dev), _t(R2, dev)
    return torch.linalg.norm(se3.so3_log_vee(R1.mT @ R2), dim=-1) * _DEG


def angular_error_so3_alt(R1, R2, device="cuda") -> torch.Tensor:
    """deg trace-acos error with clamped acos
    (``cc::angularErrorSO3_alt``)."""
    dev = _dev(device)
    M = _t(R1, dev).mT @ _t(R2, dev)
    tr = M[..., 0, 0] + M[..., 1, 1] + M[..., 2, 2]
    arg = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
    return torch.abs(torch.arccos(arg)) * _DEG


def translation_error(t1, t2, device="cuda") -> torch.Tensor:
    dev = _dev(device)
    return torch.linalg.norm(_t(t1, dev) - _t(t2, dev), dim=-1)


def rotation_frobenius_error(R1, R2, device="cuda") -> torch.Tensor:
    dev = _dev(device)
    return torch.linalg.norm(_t(R1, dev) - _t(R2, dev), dim=(-2, -1))


def error_filterreg(points, T_gt, T_est, device="cuda") -> torch.Tensor:
    """mean ||T_gt p - T_est p|| over the cloud (``cc`` FilterReg
    error)."""
    dev = _dev(device)
    pts = _t(points, dev)
    p_gt = se3.transform_points(_t(T_gt, dev), pts)
    p_est = se3.transform_points(_t(T_est, dev), pts)
    return torch.mean(torch.linalg.norm(p_gt - p_est, dim=-1), dim=-1)


def success(T_gt, T_est, rot_thresh_deg: float = 2.0,
            trans_thresh: float = 0.25, device="cuda") -> torch.Tensor:
    """The reference's convergence criterion (SO(3) error <= 2 deg and
    translation error <= 0.25)."""
    dev = _dev(device)
    T_gt, T_est = _t(T_gt, dev), _t(T_est, dev)
    so3 = angular_error_so3(T_est[..., :3, :3], T_gt[..., :3, :3], dev)
    tra = translation_error(T_gt[..., :3, 3], T_est[..., :3, 3], dev)
    return (so3 <= rot_thresh_deg) & (tra <= trans_thresh)


def rot2euler_yzx(R, device="cuda") -> torch.Tensor:
    """Rotation -> Y-Z-X Tait-Bryan (bank, attitude, heading) in
    radians, including the +-0.998 gimbal-singularity branches
    (``rot2euler`` of benchmark_lounge)."""
    R = _t(R, _dev(device))
    m00, m02 = R[..., 0, 0], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m22 = R[..., 2, 0], R[..., 2, 2]
    north = m10 > 0.998
    south = m10 < -0.998
    sing = north | south
    zero = torch.zeros_like(m10)
    half_pi = torch.full_like(m10, math.pi / 2)
    bank = torch.where(sing, zero, torch.atan2(-m12, m11))
    attitude = torch.where(north, half_pi, torch.where(
        south, -half_pi, torch.arcsin(torch.clamp(m10, -1.0, 1.0))))
    heading = torch.where(sing, torch.atan2(m02, m22),
                          torch.atan2(-m20, m00))
    return torch.stack([bank, attitude, heading], -1)


def _c_fmod(x: torch.Tensor, m: float) -> torch.Tensor:
    """C-style fmod (the result has the sign of x)."""
    return x - torch.trunc(x / m) * m


def avg_euler_error(R1, R2, device="cuda") -> torch.Tensor:
    """Mean absolute YZX euler-angle difference in degrees
    (benchmark_lounge)."""
    e1 = _c_fmod(rot2euler_yzx(R1, device) * _DEG, 360.0)
    e2 = _c_fmod(rot2euler_yzx(R2, device) * _DEG, 360.0)
    diff = _c_fmod(e1 - e2, 360.0)
    diff = torch.where(diff > 180.0, 360.0 - diff, diff)
    return torch.mean(torch.abs(diff), dim=-1)


def _valid_count(valid, dev):
    return None if valid is None else _t(valid, dev).to(torch.int32).sum()


def chamfer_distance_sq(src, tgt, src_valid=None, tgt_valid=None,
                        device="cuda") -> torch.Tensor:
    """Fan et al. squared chamfer (benchmark_lounge):
    mean_i min_j ||s_i - t_j||^2 + mean_j min_i ||t_j - s_i||^2 over one
    pair of [N,3] clouds; ``*_valid`` masks mark the valid prefix of a
    padded cloud.  Two K9 launches on the card."""
    dev = _dev(device)
    src = _t(src, dev, torch.float32)
    tgt = _t(tgt, dev, torch.float32)
    d_st = knn.nn_distances(src, tgt, tgt_valid)
    d_ts = knn.nn_distances(tgt, src, src_valid)

    def mean(d2, valid):
        if valid is None:
            return torch.mean(d2)
        valid = _t(valid, dev).to(torch.bool)
        return torch.sum(torch.where(valid, d2, 0.0)) / torch.sum(valid)

    return mean(d_st, src_valid) + mean(d_ts, tgt_valid)


def evaluate_lrf_quality(source_frames, target_frames, T_gt, corr_pairs,
                         device="cuda") -> torch.Tensor:
    """Mean SO(3) trace-acos error between GT-transformed source LRFs
    and matched target LRFs (``cc::evaluate_LRF_quality``).
    ``corr_pairs``: [M,2] integer (source, target) indices."""
    dev = _dev(device)
    sf, tf = _t(source_frames, dev), _t(target_frames, dev)
    T_gt = _t(T_gt, dev, sf.dtype)
    corr = _t(corr_pairs, dev).to(torch.int64)
    src_R = T_gt[:3, :3] @ sf[corr[:, 0], :3, :3]
    tgt_R = tf[corr[:, 1], :3, :3]
    return torch.mean(angular_error_so3_alt(src_R, tgt_R, dev))


def compute_corrs_with_gt(src, tgt, T_gt, tgt_valid=None,
                          device="cuda") -> torch.Tensor:
    """GT-transform the source, 1-NN into the target -> "true"
    correspondence pairs [N,2] int32 (``cc::compute_corrs_with_gt``).
    One K9 launch on the card."""
    dev = _dev(device)
    src_t = se3.transform_points(_t(T_gt, dev, torch.float32),
                                 _t(src, dev, torch.float32))
    idx, _ = knn.nn_argmin(src_t, _t(tgt, dev, torch.float32),
                           _valid_count(tgt_valid, dev))
    ar = torch.arange(src_t.shape[0], dtype=torch.int32, device=dev)
    return torch.stack([ar, idx], 1)


def compute_nearest_neighbor_correspondences(src, tgt, tgt_valid=None,
                                             device="cuda") -> torch.Tensor:
    """Plain 1-NN correspondence pairs [N,2] int32
    (``cc::compute_nearest_neighbor_correspondences``).  One K9 launch
    on the card."""
    dev = _dev(device)
    src = _t(src, dev, torch.float32)
    idx, _ = knn.nn_argmin(src, _t(tgt, dev, torch.float32),
                           _valid_count(tgt_valid, dev))
    ar = torch.arange(src.shape[0], dtype=torch.int32, device=dev)
    return torch.stack([ar, idx], 1)


def evaluate_trajectory_quality(gt_traj, est_traj, device="cuda") -> dict:
    """Average rotation / translation error and success rate over paired
    4x4 transforms (``cc::evaluate_trajectory_quality``)."""
    dev = _dev(device)
    gt = _t(np.asarray(gt_traj), dev)
    est = _t(np.asarray(est_traj), dev, gt.dtype)
    rot = angular_error_so3(gt[:, :3, :3], est[:, :3, :3], dev)
    tra = translation_error(gt[:, :3, 3], est[:, :3, 3], dev)
    fails = (rot > 2.0) | (tra > 0.25)
    return {
        "avg_translation_error": float(tra.mean()),
        "avg_rotation_error": float(rot.mean()),
        "success_rate": float(1.0 - fails.to(rot.dtype).mean()),
    }
