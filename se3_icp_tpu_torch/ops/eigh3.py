"""Batched closed-form 3x3 symmetric eigendecomposition.

Replaces Eigen's ``SelfAdjointEigenSolver<Matrix3d>`` used per point by
the reference's LRF estimation and the matrix inverse-sqrt in the
weighted GICP solve.  A branch-free Cardano + cross-product /
2x2-reduction scheme (Eberly's robust 3x3 eigensolver shape), written on
per-component tensors so it is purely elementwise over any leading
shape.  Eigenvalues ascend, like Eigen; eigenvector signs are arbitrary,
which every consumer here tolerates.

Cardano's cosines use ``torch.acos``/``torch.cos`` directly.  The JAX
package also carries a polynomial form (``cardano_cos_kernel_safe``)
because its TPU kernel compiler lowers neither acos nor large-angle cos;
both torch and CUDA have them, so the port needs no such form (the CUDA
epilogue kernel calls ``acosf``/``cosf``).
"""

from __future__ import annotations

import math

import torch


def _cardano_cos(r):
    """Cardano's two cosines: (cos(acos(r)/3), cos(acos(r)/3 + 2pi/3))."""
    phi = torch.acos(r) / 3.0
    return torch.cos(phi), torch.cos(phi + 2.0 * math.pi / 3.0)


def _dot3(x, y):
    return x[0] * y[0] + x[1] * y[1] + x[2] * y[2]


def _cross3(x, y):
    return (x[1] * y[2] - x[2] * y[1],
            x[2] * y[0] - x[0] * y[2],
            x[0] * y[1] - x[1] * y[0])


def _where3(c, x, y):
    return tuple(torch.where(c, a, b) for a, b in zip(x, y))


def eigh3_c(a00, a01, a02, a11, a12, a22):
    """Eigendecomposition on COMPONENT-MAJOR operands.

    Each argument is one symmetric-matrix component of shape [...];
    returns ``(vals, vecs)``: ``vals`` a 3-tuple of eigenvalue tensors
    (ascending), ``vecs`` a 3-tuple of eigenvector component 3-tuples,
    ``vecs[k][i]`` = component i of the k-th eigenvector.
    """
    dtype = a00.dtype
    f32 = dtype == torch.float32
    eps = 1e-7 if f32 else 1e-14
    peps = 1e-7 if f32 else 1e-12

    scale = torch.stack([a00.abs(), a01.abs(), a02.abs(), a11.abs(),
                         a12.abs(), a22.abs()]).amax(0).clamp_min(1e-30)
    s00, s01, s02 = a00 / scale, a01 / scale, a02 / scale
    s11, s12, s22 = a11 / scale, a12 / scale, a22 / scale

    # --- Cardano eigenvalues
    q = (s00 + s11 + s22) / 3.0
    b00, b11, b22 = s00 - q, s11 - q, s22 - q
    p2 = (b00 * b00 + b11 * b11 + b22 * b22
          + 2.0 * (s01 * s01 + s02 * s02 + s12 * s12)) / 6.0
    p = torch.sqrt(p2.clamp_min(0.0))
    small = p < peps
    pinv = 1.0 / torch.where(small, torch.ones_like(p), p)
    d00, d11, d22 = b00 * pinv, b11 * pinv, b22 * pinv
    d01, d02, d12 = s01 * pinv, s02 * pinv, s12 * pinv
    det = (d00 * (d11 * d22 - d12 * d12)
           - d01 * (d01 * d22 - d12 * d02)
           + d02 * (d01 * d12 - d11 * d02))
    r = (det * 0.5).clamp(-1.0, 1.0)
    cos0, cos_plus = _cardano_cos(r)
    two_p = torch.where(small, torch.zeros_like(p), 2.0 * p)
    e2 = q + two_p * cos0
    e0 = q + two_p * cos_plus
    e1 = 3.0 * q - e0 - e2

    # --- better-isolated extreme eigenvalue first
    first_is_low = (e1 - e0) >= (e2 - e1)
    lam_first = torch.where(first_is_low, e0, e2)

    # null vector of (A - lam I): max-norm cross of row pairs
    r0 = (s00 - lam_first, s01, s02)
    r1 = (s01, s11 - lam_first, s12)
    r2 = (s02, s12, s22 - lam_first)
    c01, c02, c12 = _cross3(r0, r1), _cross3(r0, r2), _cross3(r1, r2)
    n01, n02, n12 = _dot3(c01, c01), _dot3(c02, c02), _dot3(c12, c12)
    v12 = _where3(n02 >= n12, c02, c12)     # ties: lower pair
    nb12 = torch.maximum(n02, n12)
    v = _where3(n01 >= nb12, c01, v12)
    nbest = torch.maximum(n01, nb12)
    one, zero = torch.ones_like(q), torch.zeros_like(q)
    v = _where3(nbest > eps * eps, v, (one, zero, zero))
    winv = 1.0 / torch.sqrt(_dot3(v, v)).clamp_min(eps)
    w = (v[0] * winv, v[1] * winv, v[2] * winv)

    # orthonormal complement (U, V) of w
    use_x = w[0].abs() > w[2].abs()
    inv1 = 1.0 / torch.sqrt(w[0] * w[0] + w[1] * w[1]).clamp_min(eps)
    inv2 = 1.0 / torch.sqrt(w[1] * w[1] + w[2] * w[2]).clamp_min(eps)
    U = _where3(use_x, (-w[1] * inv1, w[0] * inv1, zero),
                (zero, -w[2] * inv2, w[1] * inv2))
    V = _cross3(w, U)

    def _matvec(x):
        return (s00 * x[0] + s01 * x[1] + s02 * x[2],
                s01 * x[0] + s11 * x[1] + s12 * x[2],
                s02 * x[0] + s12 * x[1] + s22 * x[2])

    AU, AV = _matvec(U), _matvec(V)
    a, b, c = _dot3(U, AU), _dot3(U, AV), _dot3(V, AV)
    lam_other = torch.where(first_is_low, e2, e0)
    # (a - lam) x + b y = 0  -> direction (b, lam - a) or (lam - c, b)
    d1x, d1y = b, lam_other - a
    d2x, d2y = lam_other - c, b
    pick1 = (d1x * d1x + d1y * d1y) >= (d2x * d2x + d2y * d2y)
    dx = torch.where(pick1, d1x, d2x)
    dy = torch.where(pick1, d1y, d2y)
    nd = torch.sqrt(dx * dx + dy * dy)
    dinv = 1.0 / nd.clamp_min(eps)
    good = nd > eps                # degenerate 2x2: any direction works
    dx = torch.where(good, dx * dinv, one)
    dy = torch.where(good, dy * dinv, zero)
    v_other = (dx * U[0] + dy * V[0], dx * U[1] + dy * V[1],
               dx * U[2] + dy * V[2])
    v_mid = _cross3(w, v_other)

    v0 = _where3(first_is_low, w, v_other)
    v2 = _where3(first_is_low, v_other, w)
    return (e0 * scale, e1 * scale, e2 * scale), (v0, v_mid, v2)


def _components(A):
    return (A[..., 0, 0], A[..., 0, 1], A[..., 0, 2],
            A[..., 1, 1], A[..., 1, 2], A[..., 2, 2])


def _det3(M):
    return (M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2]
                            - M[..., 1, 2] * M[..., 2, 1])
            - M[..., 0, 1] * (M[..., 1, 0] * M[..., 2, 2]
                              - M[..., 1, 2] * M[..., 2, 0])
            + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1]
                              - M[..., 1, 1] * M[..., 2, 0]))


def eigvalsh3(A):
    """Eigenvalues of symmetric [...,3,3], ascending (Cardano)."""
    dtype = A.dtype
    scale = A.abs().amax(dim=(-2, -1)).clamp_min(1e-30)
    As = A / scale[..., None, None]
    q = (As[..., 0, 0] + As[..., 1, 1] + As[..., 2, 2]) / 3.0
    B = As - q[..., None, None] * torch.eye(3, dtype=dtype, device=A.device)
    p = torch.sqrt(torch.clamp_min(torch.sum(B * B, dim=(-2, -1)) / 6.0,
                                   0.0))
    eps = 1e-7 if dtype == torch.float32 else 1e-12
    small = p < eps
    p_safe = torch.where(small, torch.ones_like(p), p)
    r = torch.clamp(_det3(B / p_safe[..., None, None]) * 0.5, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    two_p = torch.where(small, torch.zeros_like(p), 2.0 * p)
    e2 = q + two_p * torch.cos(phi)
    e0 = q + two_p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e1 = 3.0 * q - e0 - e2
    return torch.stack([e0, e1, e2], -1) * scale[..., None]


def _null_vec(M, eps):
    """Unit vector in the (approximate) null space of symmetric M: the
    largest cross product of two rows, e1 when M ~ 0."""
    r0, r1, r2 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
    c01 = torch.linalg.cross(r0, r1, dim=-1)
    c02 = torch.linalg.cross(r0, r2, dim=-1)
    c12 = torch.linalg.cross(r1, r2, dim=-1)
    n01 = torch.sum(c01 * c01, -1)
    n02 = torch.sum(c02 * c02, -1)
    n12 = torch.sum(c12 * c12, -1)
    v12 = torch.where((n02 >= n12)[..., None], c02, c12)  # ties: lower pair
    nb12 = torch.maximum(n02, n12)
    v = torch.where((n01 >= nb12)[..., None], c01, v12)
    ok = torch.maximum(n01, nb12) > eps * eps
    e1 = torch.zeros_like(v)
    e1[..., 0] = 1.0
    v = torch.where(ok[..., None], v, e1)
    return v / torch.linalg.norm(v, dim=-1, keepdim=True).clamp_min(eps)


def _complement(w, eps):
    """Orthonormal (U, V) spanning the plane perpendicular to unit w."""
    abs_w = w.abs()
    use_x = abs_w[..., 0] > abs_w[..., 2]
    inv1 = 1.0 / torch.sqrt(w[..., 0] ** 2 + w[..., 1] ** 2).clamp_min(eps)
    inv2 = 1.0 / torch.sqrt(w[..., 1] ** 2 + w[..., 2] ** 2).clamp_min(eps)
    zero = torch.zeros_like(w[..., 0])
    u_a = torch.stack([-w[..., 1] * inv1, w[..., 0] * inv1, zero], -1)
    u_b = torch.stack([zero, -w[..., 2] * inv2, w[..., 1] * inv2], -1)
    U = torch.where(use_x[..., None], u_a, u_b)
    return U, torch.linalg.cross(w, U, dim=-1)


def eigh3(A):
    """Symmetric [...,3,3] -> (eigvals [...,3] ascending, eigvecs
    [...,3,3] with the k-th COLUMN the k-th eigenvector), mirroring
    Eigen's ``SelfAdjointEigenSolver`` layout.  The JAX package's
    ``eigh3``: the better-isolated extreme eigenvector from a null
    space, the other from the 2x2 problem on its complement, so its
    choices in degenerate cases (a rank-1 neighbourhood, equal
    eigenvalues) are the JAX package's; ``eigh3_c`` is the
    component-major scheme of the setup and the loop."""
    dtype = A.dtype
    eps = 1e-7 if dtype == torch.float32 else 1e-14
    scale = A.abs().amax(dim=(-2, -1)).clamp_min(1e-30)
    As = A / scale[..., None, None]
    vals_s = eigvalsh3(As)
    e0, e1, e2 = vals_s[..., 0], vals_s[..., 1], vals_s[..., 2]
    eye = torch.eye(3, dtype=dtype, device=A.device)
    first_is_low = (e1 - e0) >= (e2 - e1)
    lam_first = torch.where(first_is_low, e0, e2)
    w = _null_vec(As - lam_first[..., None, None] * eye, eps)
    # the complement as a 2x2 symmetric problem
    U, V = _complement(w, eps)
    AU = (As @ U[..., None])[..., 0]
    AV = (As @ V[..., None])[..., 0]
    a = torch.sum(U * AU, -1)
    b = torch.sum(U * AV, -1)
    c = torch.sum(V * AV, -1)
    lam_other = torch.where(first_is_low, e2, e0)
    d1 = torch.stack([b, lam_other - a], -1)
    d2 = torch.stack([lam_other - c, b], -1)
    d = torch.where((torch.sum(d1 * d1, -1) >= torch.sum(d2 * d2, -1))
                    [..., None], d1, d2)
    nd = torch.linalg.norm(d, dim=-1, keepdim=True)
    e1_2 = torch.zeros_like(d)
    e1_2[..., 0] = 1.0
    # degenerate 2x2 (equal remaining eigenvalues): any direction
    d = torch.where(nd > eps, d / nd.clamp_min(eps), e1_2)
    v_other = d[..., 0:1] * U + d[..., 1:2] * V
    v_mid = torch.linalg.cross(w, v_other, dim=-1)
    v0 = torch.where(first_is_low[..., None], w, v_other)
    v2 = torch.where(first_is_low[..., None], v_other, w)
    return vals_s * scale[..., None], torch.stack([v0, v_mid, v2], -1)


def smallest_eigvec3_c(a00, a01, a02, a11, a12, a22):
    """Unit eigenvector of the smallest eigenvalue, component-major:
    returns (v0, v1, v2) tensors."""
    return eigh3_c(a00, a01, a02, a11, a12, a22)[1][0]


def smallest_eigvec3(A):
    """Unit eigenvector [...,3] of the smallest eigenvalue (the normal
    direction of a neighbourhood covariance)."""
    return torch.stack(smallest_eigvec3_c(*_components(A)), -1)


_SYM_PAIRS = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))


def inv_sqrt_sym3_c(a00, a01, a02, a11, a12, a22, eps_clamp=1e-12):
    """M^(-1/2) = sum_k lam_k^(-1/2) v_k v_k^T on component-major
    operands: returns the components (w00, w01, w02, w11, w12, w22)."""
    vals, vecs = eigh3_c(a00, a01, a02, a11, a12, a22)
    out = [torch.zeros_like(a00) for _ in range(6)]
    for lam, v in zip(vals, vecs):
        s = 1.0 / torch.sqrt(lam.clamp_min(eps_clamp))
        for m, (i, j) in enumerate(_SYM_PAIRS):
            out[m] = out[m] + s * v[i] * v[j]
    return tuple(out)


def inv_sqrt_sym3(A, eps_clamp=1e-12):
    """M^(-1/2) for symmetric PSD [...,3,3] (the reference uses Eigen
    ``M.inverse().sqrt()``)."""
    w = inv_sqrt_sym3_c(*_components(A), eps_clamp=eps_clamp)
    return torch.stack([torch.stack([w[0], w[1], w[2]], -1),
                        torch.stack([w[1], w[3], w[4]], -1),
                        torch.stack([w[2], w[4], w[5]], -1)], -2)
