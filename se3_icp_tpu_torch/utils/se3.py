"""SO(3)/SE(3) utilities on torch tensors (batched, dtype-preserving).

The pieces the estimators, the iteration loop and the metrics use:
roll/pitch/yaw rotations, skew matrices, Open3D's Euler-ZYX retraction
``TransformVector6dToMatrix4d`` (used by every Gauss-Newton estimator),
the rotation vector of a rotation (``so3_log_vee``), homogeneous
transform assembly/application/inversion, and the exponential and log
maps (``so3_exp``, ``se3_exp``, ``se3_log``) that Anderson acceleration
steps in.  The maps take their small-angle branches by ``torch.where``,
never by a Python branch on a value, so a graph capture holds them.
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


def so3_log_vee(R: torch.Tensor) -> torch.Tensor:
    """[...,3,3] rotation -> [...,3] rotation vector (vee of the matrix
    log), the JAX package's closed form: theta from the clamped trace,
    axis from the antisymmetric part, with a symmetric-part fallback
    near theta = pi.  Matches Eigen's ``.log()`` + the vee convention of
    ``cc::angularErrorSO3``."""
    dtype = R.dtype
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_t)
    # antisymmetric part -> axis * sin(theta)
    a = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                     R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], -1) * 0.5
    sin_t = torch.sin(theta)
    eps = 1e-7 if dtype == torch.float32 else 1e-12
    small = torch.abs(sin_t) < eps
    one = torch.ones_like(sin_t)
    factor = torch.where(small, one, theta / torch.where(small, one, sin_t))
    w_generic = factor[..., None] * a
    # near pi: axis magnitudes from the diagonal, signs from the
    # off-diagonal sums, overall sign from the antisymmetric part
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], -1)
    nn = torch.clamp((diag - cos_t[..., None]) / torch.clamp_min(
        1.0 - cos_t[..., None], eps), 0.0, 1.0)
    n = torch.sqrt(nn)
    s01 = R[..., 0, 1] + R[..., 1, 0]
    s02 = R[..., 0, 2] + R[..., 2, 0]
    s12 = R[..., 1, 2] + R[..., 2, 1]
    i_max = torch.argmax(n, dim=-1)
    ones = torch.ones_like(s01)
    off = torch.stack([torch.stack([ones, s01, s02], -1),
                       torch.stack([s01, ones, s12], -1),
                       torch.stack([s02, s12, ones], -1)], -2)
    row = torch.take_along_dim(
        off, i_max[..., None, None].expand(i_max.shape + (1, 3)),
        dim=-2)[..., 0, :]
    axis = n * torch.where(row < 0, -torch.ones_like(n), torch.ones_like(n))
    s_tot = torch.where(torch.sum(axis * a, -1, keepdim=True) < 0.0,
                        -1.0, 1.0)
    w_pi = theta[..., None] * axis * s_tot
    near_pi = (torch.pi - theta) < 1e-3
    return torch.where(near_pi[..., None], w_pi, w_generic)


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply [...,4,4] transforms to [...,N,3] points."""
    return pts @ T[..., :3, :3].mT + T[..., None, :3, 3]


def T_inverse(T: torch.Tensor) -> torch.Tensor:
    """Rigid inverse of [...,4,4]."""
    Rt = T[..., :3, :3].mT
    return rt_to_T(Rt, -(Rt @ T[..., :3, 3:4])[..., 0])


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: [...,3] axis-angle -> [...,3,3] rotation (first order
    below theta = 1e-8)."""
    theta = torch.linalg.norm(w, dim=-1, keepdim=True)[..., None]
    small = theta < 1e-8
    safe = torch.where(small, torch.ones_like(theta), theta)
    K = skew(w / safe[..., 0])
    s, c = torch.sin(safe), torch.cos(safe)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    R = eye + s * K + (1.0 - c) * (K @ K)
    return torch.where(small, eye + skew(w), R)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """[...,6] twist (w, v) -> [...,4,4] rigid transform: t = V(w) v with
    the left Jacobian V, V -> I + skew(w)/2 below theta = 1e-6."""
    w, v = xi[..., :3], xi[..., 3:]
    R = so3_exp(w)
    theta = torch.linalg.norm(w, dim=-1, keepdim=True)[..., None]
    small = theta < 1e-6
    safe = torch.where(small, torch.ones_like(theta), theta)
    K = skew(w / safe[..., 0])
    A = (1.0 - torch.cos(safe)) / (safe * safe) * safe   # (1-cos)/theta
    B = (safe - torch.sin(safe)) / (safe * safe)         # (th-sin)/th^2
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    V = eye + A * K + B * safe * (K @ K)
    V = torch.where(small, eye + 0.5 * skew(w), V)
    return rt_to_T(R, (V @ v[..., None])[..., 0])


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """[...,4,4] rigid transform -> [...,6] twist (w, v), the inverse of
    ``se3_exp``: v = V(w)^-1 t."""
    w = so3_log_vee(T[..., :3, :3])
    t = T[..., :3, 3]
    theta = torch.linalg.norm(w, dim=-1, keepdim=True)[..., None]
    small = theta < 1e-6
    safe = torch.where(small, torch.ones_like(theta), theta)
    K = skew(w / safe[..., 0])
    half = 0.5 * safe
    # V^-1 = I - th/2 K + (1 - th/2 cot(th/2)) K^2
    cot = torch.cos(half) / torch.sin(
        torch.where(small, torch.ones_like(half), half))
    coef = 1.0 - half * cot
    eye = torch.eye(3, dtype=T.dtype, device=T.device)
    Vinv = eye - half * K + coef * (K @ K)
    Vinv = torch.where(small, eye - 0.5 * skew(w), Vinv)
    return torch.cat([w, (Vinv @ t[..., None])[..., 0]], dim=-1)
