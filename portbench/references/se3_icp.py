"""The plain reference of ``se3_pt2pl``: SE(3)-ICP (run_se3_icp of
kenahm/se3-icp, ``src/se3_icp.cpp``) with point-to-plane steps, one pair
at a time, in plain PyTorch.

It shares nothing with the program under test: it imports neither the
port nor the JAX package, and works out every set-up product again from
the clouds (centring and scaling, the TOLDI frames over the exact
k-nearest neighbours, the target normals).  Where the program's
threshold route takes approximate neighbourhood balls, this takes the
exact sorted kNN that those balls approximate.

Steps, as in the C++ reference:

  * preprocess: centre each cloud at its centroid, scale both by
    ``scale_preprocessing / r``, r the largest distance of a point
    from its cloud's centroid;
  * TOLDI frames (k = ``number_of_nn_for_lrf`` neighbours, self
    included): z the smallest-eigenvalue direction of the covariance of
    ranks 1..k//3 about the sum of ranks 1..k//3-1 divided by k//3 (the
    reference's quirk), pointed along the sum of the neighbour vectors;
    x the projection on z's plane of the sum of (r - |v|)^2 (z.v)^2 v
    over ranks 1..k-1, r the k-th distance; y = z x x;
  * normals: the smallest-eigenvalue direction of the covariance of the
    ``normals_knn`` nearest neighbours, self included;
  * the loop: in the SE(3) phase the nearest neighbour in 12-D
    (alpha-weighted frame columns, beta-weighted points), trimmed and
    measured by the beta-weighted translation distance; after the switch
    (``max_num_se3_iterations`` steps, or a pose change under
    ``mse_switch_error``) the 3-D nearest neighbour; each step keeps the
    ``floor(estimated_overlap * n)`` closest correspondences (all of
    them at overlap 1), solves the 6x6 point-to-plane normal equations,
    retracts with Euler ZYX and composes on the left; it stops, once
    switched, when the mean kept distance changes by less than
    ``mse * scaling`` or after ``max_num_iterations`` steps.

``precision``: "float64" (the reference), "tf32" (float32 tensors,
every matrix product as TF32 tensor cores compute it) or "bf16" (every stored
intermediate rounded to bfloat16, sums and products accumulated in
float64, as bfloat16 hardware accumulates in a wider type): the last
two are the controls that a check of the program must fail.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_BIG = 1e7          # the reference's initial mse trackers
_BLOCK_BYTES = 1 << 28


class _Num:
    """The working precision: the tensor type and the rounding applied
    to every stored intermediate."""

    def __init__(self, precision: str):
        if precision not in ("float64", "tf32", "bf16"):
            raise ValueError(f"unknown precision {precision!r}")
        self.name = precision
        self.dtype = torch.float32 if precision == "tf32" else torch.float64

    def r(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == "bf16":
            return x.to(torch.bfloat16).to(torch.float64)
        return x

    def matmul(self, a, b):
        """a @ b; for "tf32" as TF32 tensor cores take it: both operands
        rounded to TF32 (10 stored mantissa bits, to nearest even), the
        products exact and summed in float32."""
        if self.name != "tf32":
            return a @ b
        return _tf32(a) @ _tf32(b)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.float().contiguous().view(torch.int32)
    bias = ((bits >> 13) & 1) + 0xFFF
    return ((bits + bias) & ~0x1FFF).view(torch.float32)


def _d2_block(num: _Num, q, t, tn):
    """Squared distances [Cq, Nt] of the rows q to the rows t."""
    qn = (q * q).sum(-1, keepdim=True)
    return num.r((qn - 2.0 * num.matmul(q, t.T) + tn[None]).clamp_min(0.0))


def _rows_per_block(n_cols: int, item: int) -> int:
    return max(64, _BLOCK_BYTES // max(n_cols * item, 1))


def knn_self(num: _Num, pts: torch.Tensor, k: int) -> torch.Tensor:
    """Indices [N, k] of each row's k nearest rows, itself first, then
    by ascending distance."""
    n = pts.shape[0]
    tn = (pts * pts).sum(-1)
    step = _rows_per_block(n, pts.element_size())
    out = []
    for s in range(0, n, step):
        d2 = _d2_block(num, pts[s:s + step], pts, tn)
        rows = torch.arange(s, min(n, s + step), device=pts.device)
        d2[rows - s, rows] = -1.0          # self at rank 0
        out.append(torch.topk(d2, k, dim=1, largest=False, sorted=True)[1])
    return torch.cat(out)


def nearest(num: _Num, q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Index [Nq] of each query's nearest target row (lowest index on a
    tie)."""
    tn = (t * t).sum(-1)
    step = _rows_per_block(t.shape[0], q.element_size())
    return torch.cat([_d2_block(num, q[s:s + step], t, tn).argmin(1)
                      for s in range(0, q.shape[0], step)])


def _smallest_eigvec(num: _Num, cov: torch.Tensor) -> torch.Tensor:
    vecs = torch.linalg.eigh(cov.to(torch.float64))[1][..., 0]
    return num.r(vecs.to(cov.dtype))


def toldi_frames(num: _Num, pts: torch.Tensor, idx: torch.Tensor):
    """[N, 3, 3] frames, columns x, y, z, over the neighbours ``idx``
    [N, k] (self first)."""
    k = idx.shape[1]
    rz = k // 3
    nb = pts[idx]                                      # [N, k, 3]
    radius = num.r(torch.linalg.norm(nb[:, -1] - pts, dim=1))
    cen = num.r(nb[:, 1:rz].sum(1) / rz)
    diff = nb[:, 1:rz + 1] - cen[:, None]
    normal = _smallest_eigvec(num, num.r(num.matmul(diff.mT, diff)))
    vv = num.r(nb[:, 1:] - pts[:, None])
    arrow = num.r(vv.sum(1))
    w1 = num.r((radius[:, None] - torch.linalg.norm(vv, dim=2)) ** 2)
    w2 = num.r(torch.einsum("ni,nki->nk", normal, vv) ** 2)
    scaled = num.r(torch.einsum("nk,nki->ni", w1 * w2, vv))
    flip = (normal * arrow).sum(-1, keepdim=True) < 0
    z = torch.where(flip, -normal, normal)
    x = scaled - (scaled * z).sum(-1, keepdim=True) * z
    x = num.r(x / torch.linalg.norm(x, dim=1, keepdim=True).clamp_min(1e-30))
    y = num.r(torch.linalg.cross(z, x, dim=1))
    return torch.stack([x, y, z], dim=2)


def normals(num: _Num, pts: torch.Tensor, idx: torch.Tensor, k: int):
    nb = pts[idx[:, :k]]
    diff = nb - nb.mean(1, keepdim=True)
    return _smallest_eigvec(num, num.r(num.matmul(diff.mT, diff)))


def _euler_zyx(xi: np.ndarray) -> np.ndarray:
    cx, sx = math.cos(xi[0]), math.sin(xi[0])
    cy, sy = math.cos(xi[1]), math.sin(xi[1])
    cz, sz = math.cos(xi[2]), math.sin(xi[2])
    T = np.eye(4)
    T[:3, :3] = [[cz * cy, cz * sy * sx - sz * cx, cz * sy * cx + sz * sx],
                 [sz * cy, sz * sy * sx + cz * cx, sz * sy * cx - cz * sx],
                 [-sy, cy * sx, cy * cx]]
    T[:3, 3] = xi[3:6]
    return T


def _pt2pl_step(num: _Num, moving, tgt, nrm) -> np.ndarray:
    """The step's transform from kept correspondences: the 6x6 normal
    equations of J = [p x n, n], r = (p - q).n; the identity where they
    are singular or hold fewer than six rows."""
    if moving.shape[0] < 6:
        return np.eye(4)
    J = num.r(torch.cat([torch.linalg.cross(moving, nrm, dim=1), nrm], 1))
    r = num.r(((moving - tgt) * nrm).sum(1))
    A = num.r(num.matmul(J.mT, J).to(torch.float64))
    b = num.r(num.matmul(J.mT, r[:, None])[:, 0].to(torch.float64))
    xi, info = torch.linalg.solve_ex(A, -b[:, None])
    xi = num.r(xi[:, 0]).cpu().numpy()
    if int(info) != 0 or not np.isfinite(xi).all():
        return np.eye(4)
    return _euler_zyx(xi)


def register(src: np.ndarray, tgt: np.ndarray, cfg: dict, T0=None,
             precision: str = "float64", device="cuda"):
    """Register one pair: (T [4,4] float64 in original coordinates,
    iterations, iterations before the switch).  ``cfg``: the
    configuration's ``registration`` values; ``T0``: a warm start in
    original coordinates."""
    num = _Num(precision)
    dev = torch.device(device)
    S = num.r(torch.as_tensor(np.asarray(src, np.float64), device=dev))
    D = num.r(torch.as_tensor(np.asarray(tgt, np.float64), device=dev))
    cen_s, cen_t = num.r(S.mean(0)), num.r(D.mean(0))
    rad = max(float(torch.linalg.norm(S - cen_s, dim=1).max()),
              float(torch.linalg.norm(D - cen_t, dim=1).max()))
    scaling = float(num.r(torch.tensor(cfg["scale_preprocessing"] / rad)))
    src_c = num.r((S - cen_s) * scaling).to(num.dtype)
    tgt_c = num.r((D - cen_t) * scaling).to(num.dtype)

    k = cfg["number_of_nn_for_lrf"]
    kn = cfg["normals_knn"]
    idx_s = knn_self(num, src_c, k)
    idx_t = knn_self(num, tgt_c, max(k, kn))
    alpha, beta = cfg["alpha_rot"], cfg["beta_transl"]
    F_s = num.r(toldi_frames(num, src_c, idx_s[:, :k]) * alpha)
    F_t = num.r(toldi_frames(num, tgt_c, idx_t[:, :k]) * alpha)
    nrm_t = normals(num, tgt_c, idx_t, kn)
    tgt_b = num.r(tgt_c * beta)
    emb_t = torch.cat([F_t.mT.flatten(1), tgt_b], 1)

    n = src_c.shape[0]
    overlap = cfg["estimated_overlap"]
    n_keep = math.floor(overlap * n) if overlap < 1.0 else n
    T = np.eye(4)
    if T0 is not None:
        T0 = np.asarray(T0, np.float64)
        c_s, c_t = cen_s.cpu().numpy(), cen_t.cpu().numpy()
        T[:3, :3] = T0[:3, :3]
        T[:3, 3] = (T0[:3, 3] + T0[:3, :3] @ c_s - c_t) * scaling
    mse_cur = _BIG
    switched = False
    it = pure = 0
    stop_thresh = cfg["mse"] * scaling
    max_iters = cfg["max_num_iterations"]
    max_se3 = cfg["max_num_se3_iterations"]
    while True:
        it += 1
        R = num.r(torch.as_tensor(T[:3, :3], device=dev)).to(num.dtype)
        t = num.r(torch.as_tensor(T[:3, 3], device=dev)).to(num.dtype)
        moving = num.r(src_c @ R.T + t)
        if not switched:
            rot = num.r(R @ F_s)                         # [N, 3, 3]
            q_t = num.r(beta * (src_c @ R.T) + t)
            q = torch.cat([rot.mT.flatten(1), q_t], 1)
            m = nearest(num, q, emb_t)
            dist = num.r(torch.linalg.norm(q_t - tgt_b[m], dim=1))
        else:
            m = nearest(num, moving, tgt_c)
            dist = num.r(torch.linalg.norm(moving - tgt_c[m], dim=1))
        keep = torch.sort(dist, stable=True)[1][:n_keep]
        mse_new = float(num.r(dist[keep].to(torch.float64).mean()))
        Ti = _pt2pl_step(num, moving[keep], tgt_c[m[keep]], nrm_t[m[keep]])
        T_new = num.r(torch.as_tensor(Ti @ T)).numpy()
        change = float(np.linalg.norm(T - T_new))
        mse_rel = abs(mse_new - mse_cur)
        mse_cur = mse_new
        T = T_new
        if not switched:
            pure += 1
            if it >= max_se3 or change < cfg["mse_switch_error"]:
                switched = True
        elif it >= max_iters or mse_rel < stop_thresh:
            break
    out = T.copy()
    out[:3, 3] = (T[:3, 3] / scaling - T[:3, :3] @ cen_s.cpu().numpy()
                  + cen_t.cpu().numpy())
    return out, it, pure
