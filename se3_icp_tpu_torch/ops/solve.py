"""Per-iteration rigid-transform estimators, natively batched.

Masked/weighted re-designs of the Open3D estimators the reference
delegates to, plus the reference's own weighted GICP Gauss-Newton solve
(``optimize_generalizedICP_manual``):

  * pt2pt: Umeyama/Kabsch without scale.
  * pt2pl: linearized 6-DoF Gauss-Newton with J = [p x n ; n],
    r = (p - q) . n, solved via 6x6 normal equations and retracted with
    Open3D's Euler-ZYX ``TransformVector6dToMatrix4d`` convention.
  * gicp: per-correspondence whitening W = w * (Cs + Ct)^(-1/2)
    (closed-form 3x3 inverse sqrt), J = W [-skew(p) | I], r = W (p - q).
    ``w`` is the confidence weight of the with_cf variant; the reference
    applies it INSIDE W, so it enters the normal equations quadratically
    -- reproduced.

Every estimator takes a full-length 0/1 (or confidence) mask instead of
a compacted subset.  Operands are feature-major ``[B,3,N]`` / ``[B,6,N]``
like the loop's payload.  The ``solve_*_T`` functions do the whole step;
``solve_from_normal`` / ``solve_pt2pt_from_moments`` finish a step whose
reduction already ran in the fused loop epilogue.  The 6x6 solve and the
3x3 SVD are ``torch.linalg`` calls.  Failure (singular / non-finite /
under-determined) degrades to identity like Open3D's
``SolveJacobianSystemAndObtainExtrinsicMatrix``.
"""

from __future__ import annotations

import torch

from se3_icp_tpu_torch.ops import eigh3
from se3_icp_tpu_torch.utils import se3


def _safe_transform(T: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """T [B,4,4] where ok [B] and T finite, else identity."""
    eye = torch.eye(4, dtype=T.dtype, device=T.device)
    ok = ok & torch.isfinite(T).flatten(1).all(-1)
    return torch.where(ok[:, None, None], T, eye)


def solve_normal_equations(JTJ: torch.Tensor,
                           JTr: torch.Tensor) -> torch.Tensor:
    """Solve JTJ xi = -JTr per pair, retract via Euler-ZYX; identity on
    failure.  JTJ [B,6,6], JTr [B,6] -> [B,4,4]."""
    # solve_ex reports a singular matrix through `info` instead of
    # raising, so one degenerate pair cannot abort the batch
    xi, info = torch.linalg.solve_ex(JTJ, -JTr[..., None])
    xi = xi[..., 0]
    finite = torch.isfinite(xi)
    ok = finite.all(-1) & (info == 0)
    xi = torch.where(finite, xi, torch.zeros_like(xi))
    return _safe_transform(se3.euler_zyx_retract(xi), ok)


def solve_from_normal(JTJ, JTr, wsum):
    """Finish a pt2pl/gicp step from JtJ [B,6,6], Jtr [B,6] and the kept
    count wsum [B] (6 dof need 6 points)."""
    return _safe_transform(solve_normal_equations(JTJ, JTr), wsum > 5.5)


def solve_pt2pt_from_moments(H, mu_s, mu_t, wsum):
    """Finish a pt2pt (Umeyama) step from the weighted moments
    H = sum w (t - mu_t)(s - mu_s)^T [B,3,3] and the weighted means
    [B,3]; wsum [B]."""
    ok = (wsum > 2.5) & torch.isfinite(H).flatten(1).all(-1)
    # a non-finite H would make the SVD raise; such pairs are identity
    Hs = torch.where(ok[:, None, None], H, torch.zeros_like(H))
    U, _, Vt = torch.linalg.svd(Hs)
    d = torch.sign(torch.linalg.det(U) * torch.linalg.det(Vt))
    D = torch.diag_embed(torch.stack(
        [torch.ones_like(d), torch.ones_like(d), d], -1))
    R = U @ D @ Vt
    t = mu_t - (R @ mu_s[..., None])[..., 0]
    return _safe_transform(se3.rt_to_T(R, t), ok)


def _pt2pt_moments(srcT, tgtT, w):
    wsum = w.sum(-1)
    wsafe = wsum.clamp_min(1e-30)[:, None]
    mu_s = (srcT * w[:, None]).sum(-1) / wsafe
    mu_t = (tgtT * w[:, None]).sum(-1) / wsafe
    dtw = (tgtT - mu_t[..., None]) * w[:, None]
    ds = srcT - mu_s[..., None]
    return dtw @ ds.mT, mu_s, mu_t, wsum


def solve_pt2pt_T(srcT, tgtT, weights):
    """Weighted Umeyama (no scale): argmin_R,t sum w ||R s + t - q||^2.
    srcT/tgtT [B,3,N], weights [B,N]."""
    w = weights.to(srcT.dtype)
    return solve_pt2pt_from_moments(*_pt2pt_moments(srcT, tgtT, w))


def _pt2pl_normal(srcT, tgtT, nT, w):
    r = ((srcT - tgtT) * nT).sum(1)                            # [B,N]
    JT = torch.cat([torch.linalg.cross(srcT, nT, dim=1), nT], 1)
    JTw = JT * w[:, None]
    return JTw @ JT.mT, (JTw @ r[..., None])[..., 0]


def solve_pt2pl_T(srcT, tgtT, nT, weights):
    """Point-to-plane GN step: J_i = [s_i x n_i ; n_i],
    r_i = (s_i - q_i) . n_i.  srcT/tgtT/nT [B,3,N], weights [B,N]."""
    w = weights.to(srcT.dtype)
    JTJ, JTr = _pt2pl_normal(srcT, tgtT, nT, w)
    return solve_from_normal(JTJ, JTr, w.sum(-1))


def rotate_sym3_T(R, cov6):
    """(R C R^T) on component-major symmetric operands: R [B,3,3],
    cov6 [B,6,N] rows (xx, xy, xz, yy, yz, zz) -> same layout."""
    idx = ((0, 1, 2), (1, 3, 4), (2, 4, 5))
    out = []
    for i, j in eigh3._SYM_PAIRS:
        acc = None
        for k in range(3):
            for l in range(3):
                term = (R[:, i, k] * R[:, j, l])[:, None] * cov6[:, idx[k][l]]
                acc = term if acc is None else acc + term
        out.append(acc)
    return torch.stack(out, 1)


def _gicp_normal(srcT, tgtT, cov_src6, cov_tgt6, w, conf):
    M = (cov_src6 + cov_tgt6).unbind(1)
    W6 = eigh3.inv_sqrt_sym3_c(*M)
    if conf is not None:
        W6 = tuple(x * conf for x in W6)
    W = ((W6[0], W6[1], W6[2]), (W6[1], W6[3], W6[4]),
         (W6[2], W6[4], W6[5]))
    s = srcT.unbind(1)
    d = (srcT - tgtT).unbind(1)

    def wdot(row, v):
        return row[0] * v[0] + row[1] * v[1] + row[2] * v[2]

    # r = W (s - t); J = W @ [-skew(s) | I]; columns of -skew(s):
    # c0 = (0, -s2, s1), c1 = (s2, 0, -s0), c2 = (-s1, s0, 0)
    zero = torch.zeros_like(s[0])
    cols = ((zero, -s[2], s[1]), (s[2], zero, -s[0]), (-s[1], s[0], zero))
    J = torch.stack([torch.stack(
        [wdot(W[i], cols[a]) for a in range(3)] + list(W[i]), 1)
        for i in range(3)], 1)                                 # [B,3,6,N]
    r = torch.stack([wdot(W[i], d) for i in range(3)], 1)      # [B,3,N]
    Jw = J * w[:, None, None]
    JTJ = torch.einsum("bian,bicn->bac", Jw, J)
    JTr = torch.einsum("bian,bin->ba", Jw, r)
    return JTJ, JTr


def solve_gicp_T(srcT, tgtT, cov_src6, cov_tgt6, weights, conf=None):
    """(Weighted) generalized-ICP GN step on feature-major operands.
    srcT/tgtT [B,3,N]; cov_src6 (already rotated) / cov_tgt6 [B,6,N];
    weights [B,N] 0/1 trim mask; conf [B,N] optional confidence applied
    inside the whitening matrix."""
    w = weights.to(srcT.dtype)
    JTJ, JTr = _gicp_normal(srcT, tgtT, cov_src6, cov_tgt6, w, conf)
    return solve_from_normal(JTJ, JTr, w.sum(-1))
