"""SO(3)/SE(3) utilities on torch tensors (batched, dtype-preserving).

The pieces the estimators and the iteration loop use: roll/pitch/yaw
rotations, skew matrices, Open3D's Euler-ZYX retraction
``TransformVector6dToMatrix4d`` (used by every Gauss-Newton estimator),
and homogeneous transform assembly/application/inversion.  The twist
maps (``se3_exp``/``se3_log``) arrive with Anderson acceleration.
"""

from __future__ import annotations

import torch


def _axis_rot(angle: torch.Tensor, axis: int) -> torch.Tensor:
    c, s = torch.cos(angle), torch.sin(angle)
    one, zero = torch.ones_like(c), torch.zeros_like(c)
    if axis == 0:
        rows = [[one, zero, zero], [zero, c, -s], [zero, s, c]]
    elif axis == 1:
        rows = [[c, zero, s], [zero, one, zero], [-s, zero, c]]
    else:
        rows = [[c, -s, zero], [s, c, zero], [zero, zero, one]]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def rot_3d(roll, pitch, yaw, dtype=torch.float64, device="cpu"):
    """Rotation from roll/pitch/yaw: R = Rz(yaw) @ Ry(pitch) @ Rx(roll)
    (``cc::rot_3d`` of the reference)."""
    a = [torch.as_tensor(v, dtype=dtype, device=device)
         for v in (roll, pitch, yaw)]
    return _axis_rot(a[2], 2) @ _axis_rot(a[1], 1) @ _axis_rot(a[0], 0)


def skew(v: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 3, 3] cross-product matrix."""
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([z, -v[..., 2], v[..., 1]], -1),
        torch.stack([v[..., 2], z, -v[..., 0]], -1),
        torch.stack([-v[..., 1], v[..., 0], z], -1),
    ], -2)


def rt_to_T(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """[...,3,3] + [...,3] -> [...,4,4] homogeneous."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    T = torch.zeros(batch + (4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def euler_zyx_retract(xi: torch.Tensor) -> torch.Tensor:
    """6-vector (rx, ry, rz, tx, ty, tz) -> 4x4 transform, Open3D
    ``TransformVector6dToMatrix4d``: R = Rz(rz) Ry(ry) Rx(rx) -- an
    Euler-angle retraction, NOT the exp map."""
    R = (_axis_rot(xi[..., 2], 2) @ _axis_rot(xi[..., 1], 1)
         @ _axis_rot(xi[..., 0], 0))
    return rt_to_T(R, xi[..., 3:6])


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply [...,4,4] transforms to [...,N,3] points."""
    return pts @ T[..., :3, :3].mT + T[..., None, :3, 3]


def T_inverse(T: torch.Tensor) -> torch.Tensor:
    """Rigid inverse of [...,4,4]."""
    Rt = T[..., :3, :3].mT
    return rt_to_T(Rt, -(Rt @ T[..., :3, 3:4])[..., 0])
