"""Local-reference-frame estimation + normals + GICP covariances from
the exact sorted kNN, natively batched.

  * TOLDI SE(3) frames (``computeSingleTOLDISE3Frame`` of the
    reference): centroid / covariance / smallest eigenvector / arrow
    weighting over the k nearest neighbours.
  * PCA normal estimation (Open3D ``EstimateNormals`` analog).
  * GICP covariance initialisation, including the reference's
    ``c < -0.99 -> identity`` quirk in GetRotationFromE1ToX.

Every neighbourhood reduction is a masked ``[B,C,N] x [B,N,*]`` matrix
product, with rank membership recovered from the SORTED kNN distances:
ranks 1..r == {j : 0 < d2_ij <= d2sorted[i, r]}, at midpoint thresholds
so a last-ulp difference between the distance block here and the one
inside the kNN cannot flip boundary membership.  Query rows go in
chunks so the distance block stays bounded.

Intentional parity quirk: the TOLDI centroid sums neighbours ranked
1..k//3-1 but divides by k//3, while the covariance uses ranks 1..k//3.
Reproduced by default; ``exact_centroid=True`` divides by k//3-1.

SHOT frames are a later slice of the port.
"""

from __future__ import annotations

import torch

from se3_icp_tpu_torch.ops import eigh3, knn
from se3_icp_tpu_torch.utils.se3 import skew

_CHUNK_BYTES = 400_000_000    # one [B, chunk, N] block of the reductions


def _chunk_rows(bsz: int, n: int, itemsize: int) -> int:
    return max(8, _CHUNK_BYTES // max(bsz * n * itemsize, 1))


def _p12(points: torch.Tensor) -> torch.Tensor:
    """[B,N,3] -> [B,N,12] = [p | vec(p p^T)]: one masked product then
    yields both first and second neighbourhood moments."""
    p9 = (points[:, :, :, None] * points[:, :, None, :]).flatten(2)
    return torch.cat([points, p9], dim=-1)


def _cov_components(s1, s2, mean, m):
    """Components of sum_j m_j (p_j - mean)(p_j - mean)^T from the
    masked sums s1 = sum p, s2 = sum vec(p p^T), m = sum 1."""
    def c(i, j):
        return (s2[..., 3 * i + j] - s1[..., i] * mean[..., j]
                - mean[..., i] * s1[..., j]
                + m * mean[..., i] * mean[..., j])
    return c(0, 0), c(0, 1), c(0, 2), c(1, 1), c(1, 2), c(2, 2)


def toldi_frames_dense(points: torch.Tensor, d2sorted: torch.Tensor,
                       n_valid: torch.Tensor,
                       exact_centroid: bool = False) -> torch.Tensor:
    """TOLDI frames for every point of every cloud.

    points [B,N,3]; d2sorted [B,N,k] ascending squared neighbour
    distances with self at rank 0 (``knn.knn_self``); n_valid [B].
    Returns rot [B,N,3,3] with columns x, y, z.
    """
    dtype = points.dtype
    bsz, n, _ = points.shape
    k = d2sorted.shape[2]
    rz = k // 3
    divisor = float((rz - 1) if exact_centroid else rz)
    col = torch.arange(n, device=points.device)
    colv = col[None, :] < n_valid[:, None]                    # [B,N]
    p12 = _p12(points)
    # radius = distance to the k-th neighbour; when a cloud has fewer
    # than k valid points that slot holds the masked-kNN sentinel and
    # (radius - d)^2 would overflow -- clamp to the last VALID neighbour
    last = torch.clamp(n_valid - 1, min=1).clamp(max=k - 1)   # [B]
    out = []
    chunk = _chunk_rows(bsz, n, points.element_size())
    for s in range(0, n, chunk):
        q = points[:, s:s + chunk]                            # [B,C,3]
        d2row = d2sorted[:, s:s + chunk]
        c = q.shape[1]
        D2 = knn._pairwise_d2(q, points)                      # [B,C,N]
        base = ((col[None, None, :] != col[s:s + c][None, :, None])
                & colv[:, None, :])
        # midpoint thresholds: rank sets {1..rz-1}, {1..rz}, {1..k-1}
        thr_cen = 0.5 * (d2row[..., rz - 1] + d2row[..., rz])
        thr_cov = 0.5 * (d2row[..., rz] + d2row[..., rz + 1])
        r2 = torch.gather(d2row, 2,
                          last[:, None, None].expand(-1, c, 1))[..., 0]
        thr_all = r2 * (1.0 + 1e-6) + 1e-30
        Mcen = (base & (D2 <= thr_cen[..., None])).to(dtype)
        Mcov = (base & (D2 <= thr_cov[..., None])).to(dtype)
        Mall = (base & (D2 <= thr_all[..., None])).to(dtype)

        cen = (Mcen @ points) / divisor                       # [B,C,3]
        S = Mcov @ p12                                        # [B,C,12]
        normal = torch.stack(eigh3.smallest_eigvec3_c(
            *_cov_components(S[..., :3], S[..., 3:], cen,
                             Mcov.sum(-1))), -1)              # [B,C,3]

        arrow = Mall @ points - Mall.sum(-1, keepdim=True) * q
        d = torch.sqrt(D2.clamp_min(0.0))
        radius = torch.sqrt(r2.clamp_min(0.0))
        w1 = (radius[..., None] - d) ** 2
        # (n_i . v_ij) = n_i . p_j - n_i . p_i
        zdot = normal @ points.mT - torch.sum(normal * q, -1,
                                              keepdim=True)
        W = Mall * w1 * zdot * zdot
        scaled = W @ points - W.sum(-1, keepdim=True) * q

        flip = torch.sum(normal * arrow, -1, keepdim=True) < 0.0
        z = torch.where(flip, -normal, normal)
        x = scaled - torch.sum(scaled * z, -1, keepdim=True) * z
        x = x / torch.linalg.norm(x, dim=-1, keepdim=True).clamp_min(
            1e-30)
        y = torch.linalg.cross(z, x, dim=-1)
        out.append(torch.stack([x, y, z], dim=-1))
    return torch.cat(out, dim=1)


def normals_dense(points: torch.Tensor, d2sorted: torch.Tensor,
                  k_use: int, n_valid: torch.Tensor) -> torch.Tensor:
    """PCA normals [B,N,3] over the k_use nearest neighbours INCLUDING
    self, recovered as the masked set {j : d2_ij <= midpoint(
    d2sorted[i, k_use-1], d2sorted[i, k_use])} -- so ``d2sorted`` must
    be at least k_use+1 wide."""
    dtype = points.dtype
    bsz, n, _ = points.shape
    if d2sorted.shape[2] <= k_use:
        raise ValueError(f"d2sorted width {d2sorted.shape[2]} must "
                         f"exceed k_use={k_use}")
    col = torch.arange(n, device=points.device)
    colv = col[None, :] < n_valid[:, None]
    p12 = _p12(points)
    kinv = 1.0 / k_use
    thr = 0.5 * (d2sorted[..., k_use - 1] + d2sorted[..., k_use])
    out = []
    chunk = _chunk_rows(bsz, n, points.element_size())
    for s in range(0, n, chunk):
        D2 = knn._pairwise_d2(points[:, s:s + chunk], points)
        M = ((D2 <= thr[:, s:s + chunk, None])
             & colv[:, None, :]).to(dtype)
        S = M @ p12
        s1 = S[..., :3]
        cov = _cov_components(s1, S[..., 3:], s1 * kinv, M.sum(-1))
        out.append(torch.stack(eigh3.smallest_eigvec3_c(
            *(cc * kinv for cc in cov)), -1))
    return torch.cat(out, dim=1)


def rotation_from_e1_to_x(x: torch.Tensor) -> torch.Tensor:
    """Open3D's private GetRotationFromE1ToX, copied by the reference
    -- INCLUDING the c < -0.99 -> identity quirk.  x [...,3] unit."""
    e1 = torch.zeros_like(x)
    e1[..., 0] = 1.0
    v = torch.linalg.cross(e1, x, dim=-1)
    c = x[..., 0]                                        # e1 . x
    quirk = c < -0.99
    sv = skew(v)
    factor = 1.0 / (1.0 + torch.where(quirk, torch.ones_like(c), c))
    eye = torch.eye(3, dtype=x.dtype, device=x.device)
    R = eye + sv + (sv @ sv) * factor[..., None, None]
    return torch.where(quirk[..., None, None], eye.expand_as(R), R)


def gicp_covariances_dense(points: torch.Tensor, d2sorted: torch.Tensor,
                           k_use: int, epsilon: float,
                           n_valid: torch.Tensor) -> torch.Tensor:
    """GICP covariance init [B,N,3,3]: dense normals ->
    Sigma = Rx diag(eps,1,1) Rx^T."""
    normals = normals_dense(points, d2sorted, k_use, n_valid)
    Rx = rotation_from_e1_to_x(normals)
    C = torch.diag(torch.tensor([epsilon, 1.0, 1.0], dtype=points.dtype,
                                device=points.device))
    return Rx @ C @ Rx.mT


def _sym_to_6(cov: torch.Tensor) -> torch.Tensor:
    """[...,N,3,3] symmetric -> [...,6,N] components (xx, xy, xz, yy,
    yz, zz), the component-major layout the loop carries."""
    return torch.stack([cov[..., 0, 0], cov[..., 0, 1], cov[..., 0, 2],
                        cov[..., 1, 1], cov[..., 1, 2], cov[..., 2, 2]],
                       dim=-2)


def _cov6_to_mat(cov6: torch.Tensor) -> torch.Tensor:
    """[...,6,N] symmetric components -> [...,N,3,3]."""
    c = cov6.unbind(-2)
    return torch.stack([torch.stack([c[0], c[1], c[2]], -1),
                        torch.stack([c[1], c[3], c[4]], -1),
                        torch.stack([c[2], c[4], c[5]], -1)], -2)
