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
reduction already ran in the fused loop epilogue (the Anderson route's
loop step takes them).  Their 6x6 solve
is ``torch.linalg.solve_ex`` (no check on the host).  The registration
loop's step (``ops/cuda_step.py``) takes the component-wise forms below
instead -- ``solve6_c`` (Gaussian elimination with partial pivoting),
``euler_zyx_c``, ``kabsch3_c`` --, which its kernel repeats bit for bit,
and so do FGR's Gauss-Newton steps (``models/fgr.py``).
The pt2pt rotation ``kabsch3`` is a fixed sequence of elementwise ops
in place of a 3x3 SVD, which on the card checks its input on the host.
Failure (singular / non-finite / under-determined) degrades to identity
like Open3D's ``SolveJacobianSystemAndObtainExtrinsicMatrix``.
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


# squarings of the shifted 4x4 matrix in ``kabsch3``: after k of them
# the runner-up eigenvalue's share is r^(2^k), r = |l_2 + s| / (l_1 + s),
# so the quaternion is exact to rounding wherever rounding leaves the
# answer defined (1 - r down to ~eps: 2^24 in float32; 2^32 keeps
# float64 at rounding for sigma2 / sigma1 down to ~1e-8)
_SQUARINGS = {torch.float32: 24, torch.float64: 32}
_RESCALE_EVERY = 4     # a PSD trace falls at most 2^30-fold in 4 squarings


# ---------------------------------------------------------------------
# Component-wise forms: every function below works on per-pair [B]
# tensors (lists of them for vectors and matrices) with one elementwise
# torch op per step, in a fixed order, and no ``torch.linalg`` call,
# matrix product or reduction: the arithmetic of the loop step that the
# CUDA kernel ``csrc/step_update.cu`` repeats operation for operation
# (``ops/cuda_step.py``).  Sums run left to right.

def solve6_c(A: torch.Tensor, rhs: list):
    """Solve A x = rhs for A [B,6,6] and rhs six [B] tensors by Gaussian
    elimination with partial pivoting (LAPACK's ``getrf`` choice: the
    first row of largest magnitude in the column), unrolled, the row
    swap made by ``torch.where``.  Returns (x, ok): x six [B] tensors
    with non-finite entries set to 0, ok [B] where every pivot is
    nonzero and finite and every entry of x finite."""
    a = [[A[:, r, c] for c in range(6)] + [rhs[r]] for r in range(6)]
    ok = torch.ones_like(rhs[0], dtype=torch.bool)
    for k in range(6):
        best = a[k][k].abs()
        idx = torch.full_like(rhs[0], k, dtype=torch.int32)
        for r in range(k + 1, 6):
            v = a[r][k].abs()
            take = v > best
            best = torch.where(take, v, best)
            idx = torch.where(take, torch.full_like(idx, r), idx)
        for r in range(k + 1, 6):
            sel = idx == r
            for c in range(k, 7):
                ak, ar = a[k][c], a[r][c]
                a[k][c] = torch.where(sel, ar, ak)
                a[r][c] = torch.where(sel, ak, ar)
        piv = a[k][k]
        ok = ok & (piv != 0) & torch.isfinite(piv)
        for r in range(k + 1, 6):
            f = a[r][k] / piv
            for c in range(k + 1, 7):
                a[r][c] = a[r][c] - f * a[k][c]
    x = [None] * 6
    for r in range(5, -1, -1):
        acc = a[r][6]
        for c in range(r + 1, 6):
            acc = acc - a[r][c] * x[c]
        x[r] = acc / a[r][r]
    for r in range(6):
        fin = torch.isfinite(x[r])
        ok = ok & fin
        x[r] = torch.where(fin, x[r], torch.zeros_like(x[r]))
    return x, ok


def euler_zyx_c(xi: list):
    """Open3D's ``TransformVector6dToMatrix4d`` on six [B] tensors
    (rx, ry, rz, tx, ty, tz): (R, t), R = Rz(rz) Ry(ry) Rx(rx) as nine
    [B] tensors R[i][j], t three."""
    cx, sx = torch.cos(xi[0]), torch.sin(xi[0])
    cy, sy = torch.cos(xi[1]), torch.sin(xi[1])
    cz, sz = torch.cos(xi[2]), torch.sin(xi[2])
    czsy, szsy = cz * sy, sz * sy
    R = [[cz * cy, czsy * sx - sz * cx, czsy * cx + sz * sx],
         [sz * cy, szsy * sx + cz * cx, szsy * cx - cz * sx],
         [-sy, cy * sx, cy * cx]]
    return R, list(xi[3:6])


def kabsch3_c(H: torch.Tensor):
    """``kabsch3`` on H [B,3,3], component-wise: R as nine [B] tensors
    R[i][j].  The 4x4 matrix is symmetric and stays so exactly (its
    square's (i, j) and (j, i) entries sum the same products), so ten
    entries are kept."""
    dtype = H.dtype
    tiny = torch.finfo(dtype).tiny
    h = [[H[:, i, j] for j in range(3)] for i in range(3)]
    # Sab = sum s_a t_b of H = sum t s^T
    (xx, yx, zx), (xy, yy, zy), (xz, yz, zz) = h
    a, b, c = yz - zy, zx - xz, xy - yx
    shift2 = h[0][0] * h[0][0]
    for i in range(3):
        for j in range(3):
            if i or j:
                shift2 = shift2 + h[i][j] * h[i][j]
    shift = torch.sqrt(shift2)
    # m[(i, j)], i <= j: the upper triangle of N + shift I
    m = {(0, 0): ((xx + yy) + zz) + shift, (0, 1): a, (0, 2): b,
         (0, 3): c, (1, 1): ((xx - yy) - zz) + shift, (1, 2): xy + yx,
         (1, 3): zx + xz, (2, 2): ((yy - xx) - zz) + shift,
         (2, 3): yz + zy, (3, 3): ((zz - xx) - yy) + shift}

    def at(i, j):
        return m[(i, j) if i <= j else (j, i)]
    for k in range(_SQUARINGS[dtype]):
        if k % _RESCALE_EVERY == 0:
            tr = ((m[(0, 0)] + m[(1, 1)]) + m[(2, 2)]) + m[(3, 3)]
            tr = torch.clamp_min(tr, tiny)
            m = {key: v / tr for key, v in m.items()}
        sq = {}
        for (i, j) in m:
            acc = at(i, 0) * at(0, j)
            for l in range(1, 4):
                acc = acc + at(i, l) * at(l, j)
            sq[(i, j)] = acc
        m = sq
    # the column of the largest diagonal entry (the first on a tie)
    best, col = m[(0, 0)], torch.zeros_like(m[(0, 0)], dtype=torch.int32)
    for i in range(1, 4):
        take = m[(i, i)] > best
        best = torch.where(take, m[(i, i)], best)
        col = torch.where(take, torch.full_like(col, i), col)
    q = []
    for r in range(4):
        v = at(r, 3)
        for j in (2, 1, 0):
            v = torch.where(col == j, at(r, j), v)
        q.append(v)
    nq = torch.sqrt(((q[0] * q[0] + q[1] * q[1]) + q[2] * q[2])
                    + q[3] * q[3])
    pos = nq > 0
    nqc = torch.clamp_min(nq, tiny)
    one, zero = torch.ones_like(nq), torch.zeros_like(nq)
    q = [torch.where(pos, q[r] / nqc, one if r == 0 else zero)
         for r in range(4)]
    # R = (2 w^2 - 1) I + 2 (v v^T + w [v]x), q = (w, v)
    w, v = q[0], q[1:]
    d = (w * 2.0) * w - 1.0
    return [[d + (v[0] * v[0]) * 2.0, (v[0] * v[1] - w * v[2]) * 2.0,
             (v[0] * v[2] + w * v[1]) * 2.0],
            [(v[1] * v[0] + w * v[2]) * 2.0, d + (v[1] * v[1]) * 2.0,
             (v[1] * v[2] - w * v[0]) * 2.0],
            [(v[2] * v[0] - w * v[1]) * 2.0,
             (v[2] * v[1] + w * v[0]) * 2.0, d + (v[2] * v[2]) * 2.0]]


def kabsch3(H: torch.Tensor) -> torch.Tensor:
    """The rotation R [B,3,3] maximising tr(R^T H) for H [B,3,3]: the
    Kabsch/Umeyama rotation U diag(1, 1, sign det(U V^T)) V^T of the SVD
    H = U S V^T, reflection fix included, without an SVD.

    Horn's quaternion form: tr(R^T H) = q^T N q for the unit quaternion
    q of R and the symmetric traceless 4x4 N built linearly from H, whose
    eigenvalues are the sums +-s1 +- s2 +- s3 of the singular values with
    an even number of minus signs (odd when det H < 0).  Its top
    eigenvector is the answer.  With s = |H|_F (>= s1 >= s3) the top
    eigenvalue of N + s I is the largest in magnitude, so its repeated
    square, rescaled by its trace (4 s before the first square),
    converges to the projector on that eigenvector; the projector's
    column of largest diagonal is q up to sign.  A fixed count of
    squarings (``_SQUARINGS``) written out entry by entry
    (``kabsch3_c``), and no ``torch.linalg`` call, so nothing is read
    back on the host.  Where R is unique (rank H >= 2 and the smallest
    singular value simple when det H < 0) it is LAPACK's R to rounding;
    rank 1 gives one of the optimal rotations; H = 0 gives the identity
    (LAPACK's U = V = I)."""
    R = kabsch3_c(H)
    return torch.stack([torch.stack(row, -1) for row in R], -2)


def solve_pt2pt_from_moments(H, mu_s, mu_t, wsum):
    """Finish a pt2pt (Umeyama) step from the weighted moments
    H = sum w (t - mu_t)(s - mu_s)^T [B,3,3] and the weighted means
    [B,3]; wsum [B]."""
    ok = (wsum > 2.5) & torch.isfinite(H).flatten(1).all(-1)
    R = kabsch3(H)
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
