"""Local-reference-frame estimation + normals + GICP covariances,
natively batched, on two routes.

  * TOLDI SE(3) frames (``computeSingleTOLDISE3Frame`` of the
    reference): centroid / covariance / smallest eigenvector / arrow
    weighting over the k nearest neighbours.
  * PCA normal estimation (Open3D ``EstimateNormals`` analog).
  * GICP covariance initialisation, including the reference's
    ``c < -0.99 -> identity`` quirk in GetRotationFromE1ToX.
  * SHOT SE(3) frames (``computeSingleSHOTSE3Frame``, the reference's
    dormant alternative LRF): a (radius - d)-weighted covariance over a
    radius neighbourhood, axes signed by majority with a 5-sample
    median-rank tie-break.  ``shot_frames_dense`` keeps the exact radius
    semantics; ``shot_frames`` caps a neighbourhood at its ``max_k``
    nearest (``shot_truncated_count`` counts the points it truncates).

The EXACT route (``*_dense``) takes the sorted kNN: every neighbourhood
reduction is a masked ``[B,C,N] x [B,N,*]`` matrix product, with rank
membership recovered from the SORTED kNN distances: ranks 1..r ==
{j : 0 < d2_ij <= d2sorted[i, r]}, at midpoint thresholds so a last-ulp
difference between the distance block here and the one inside the kNN
cannot flip boundary membership.  Query rows go in chunks so the
distance block stays bounded.  ``normals_knn`` takes the same members
from the kNN's own ranks and sums them in ascending row index (FGR's
normals, whose bits do not depend on the batch).

The THRESHOLD route (``*_thr_t``, the default setup) takes one
squared-distance threshold per query and self-inclusive count from
``cuda_moments.neighborhood_thresholds_batched`` and reduces the balls
in the kernels of ``ops/cuda_moments.py``; the glue around them, the
JAX package's ``_toldi_fused_from_thr`` / ``_normals_fused_batched`` /
``gicp_cov6_from_normals_t``, COMPONENT-MAJOR throughout ([B,C,N]), is
two kernels of its own with their plain versions (``ops/cuda_frames.py``).

Row slices: every function of both routes but SHOT's takes
``rows=(r0, r1)`` and computes the query rows [r0, r1) only, against the
whole cloud (the points route of ``parallel/points.py``, where each rank
takes its own rows; the JAX package's ``queries=`` / ``row_offset=``
arguments); its per-query inputs and results are then r1 - r0 wide.
On the threshold route a slice gives the whole call's rows bit for bit
(the kernels and their plain versions); the exact route's dense
reductions run their row blocks from the slice's first row, and a CPU
matrix product's row can take other last bits in a block of another
height or offset.

Intentional parity quirk: the TOLDI centroid sums neighbours ranked
1..k//3-1 but divides by k//3, while the covariance uses ranks 1..k//3.
Reproduced by default; ``exact_centroid=True`` divides by k//3-1 (exact
route only).
"""

from __future__ import annotations

import torch

from se3_icp_tpu_torch.ops import cuda_frames, cuda_moments, eigh3, knn
# the threshold route's glue, whose plain versions live beside its
# kernels (G1, G2) in ``ops/cuda_frames.py``
from se3_icp_tpu_torch.ops.cuda_frames import (  # noqa: F401
    gicp_cov6_from_normals_t, toldi_axis_inputs)
from se3_icp_tpu_torch.utils.se3 import skew

_CHUNK_BYTES = 400_000_000    # one [B, chunk, N] block of the reductions


def _chunk_rows(bsz: int, n: int, itemsize: int, device) -> int:
    """Query rows a block of the dense reductions: within the budget,
    or 256 on the CPU, which keeps the block in the caches (a row's
    arithmetic is the same at any chunk)."""
    if device.type == "cpu":
        return 256
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
                       n_valid: torch.Tensor, exact_centroid: bool = False,
                       rows=None) -> torch.Tensor:
    """TOLDI frames for every point of every cloud.

    points [B,N,3]; d2sorted [B,N,k] ascending squared neighbour
    distances with self at rank 0 (``knn.knn_self``); n_valid [B].
    Returns rot [B,N,3,3] with columns x, y, z.  ``rows=(r0, r1)``: the
    rows [r0, r1) only (d2sorted and the result r1 - r0 long).
    """
    dtype = points.dtype
    bsz, n, _ = points.shape
    r0, r1 = cuda_moments.row_span(rows, n)
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
    chunk = _chunk_rows(bsz, n, points.element_size(), points.device)
    for s in range(r0, r1, chunk):
        e = min(r1, s + chunk)
        q = points[:, s:e]                                    # [B,C,3]
        d2row = d2sorted[:, s - r0:e - r0]
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
                  k_use: int, n_valid: torch.Tensor,
                  rows=None) -> torch.Tensor:
    """PCA normals [B,N,3] over the k_use nearest neighbours INCLUDING
    self, recovered as the masked set {j : d2_ij <= midpoint(
    d2sorted[i, k_use-1], d2sorted[i, k_use])} -- so ``d2sorted`` must
    be at least k_use+1 wide.  ``rows=(r0, r1)``: the rows [r0, r1) only
    (d2sorted and the result r1 - r0 long)."""
    dtype = points.dtype
    bsz, n, _ = points.shape
    r0, r1 = cuda_moments.row_span(rows, n)
    if d2sorted.shape[2] <= k_use:
        raise ValueError(f"d2sorted width {d2sorted.shape[2]} must "
                         f"exceed k_use={k_use}")
    col = torch.arange(n, device=points.device)
    colv = col[None, :] < n_valid[:, None]
    p12 = _p12(points)
    kinv = 1.0 / k_use
    thr = 0.5 * (d2sorted[..., k_use - 1] + d2sorted[..., k_use])
    out = []
    chunk = _chunk_rows(bsz, n, points.element_size(), points.device)
    for s in range(r0, r1, chunk):
        e = min(r1, s + chunk)
        D2 = knn._pairwise_d2(points[:, s:e], points)
        M = ((D2 <= thr[:, s - r0:e - r0, None])
             & colv[:, None, :]).to(dtype)
        S = M @ p12
        s1 = S[..., :3]
        cov = _cov_components(s1, S[..., 3:], s1 * kinv, M.sum(-1))
        out.append(torch.stack(eigh3.smallest_eigvec3_c(
            *(cc * kinv for cc in cov)), -1))
    return torch.cat(out, dim=1)


def normals_knn(points: torch.Tensor, idx: torch.Tensor,
                d2sorted: torch.Tensor, k_use: int,
                n_valid: torch.Tensor) -> torch.Tensor:
    """``normals_dense``'s PCA normals [B,N,3] from the sorted kNN itself
    (idx / d2sorted [B,N,k], k > k_use): the members are the ranks whose
    distance is at most the midpoint threshold (``normals_dense``'s set
    wherever it lies inside the k ranks), their moments summed by
    ``knn.neighbor_sums`` in ascending row index: a pair's bits do not
    depend on its batch (FGR's features)."""
    if d2sorted.shape[2] <= k_use:
        raise ValueError(f"d2sorted width {d2sorted.shape[2]} must "
                         f"exceed k_use={k_use}")
    n = points.shape[1]
    thr = 0.5 * (d2sorted[..., k_use - 1] + d2sorted[..., k_use])
    colv = torch.arange(n, device=points.device)[None, :] < n_valid[:, None]
    keep = (d2sorted <= thr[..., None]) & torch.gather(
        colv[:, None, :].expand(-1, n, -1), 2, idx.to(torch.int64))
    S = knn.neighbor_sums(_p12(points), idx, keep)
    s1 = S[..., :3]
    kinv = 1.0 / k_use
    cov = _cov_components(s1, S[..., 3:], s1 * kinv,
                          keep.sum(-1).to(points.dtype))
    return torch.stack(eigh3.smallest_eigvec3_c(*(cc * kinv for cc in cov)),
                       -1)


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
                           n_valid: torch.Tensor, rows=None) -> torch.Tensor:
    """GICP covariance init [B,N,3,3]: dense normals ->
    Sigma = Rx diag(eps,1,1) Rx^T (of the rows ``rows`` only, as
    ``normals_dense``)."""
    normals = normals_dense(points, d2sorted, k_use, n_valid, rows)
    Rx = rotation_from_e1_to_x(normals)
    # made by fills: a copy from the host could not be captured
    diag = torch.ones(3, dtype=points.dtype, device=points.device)
    diag[:1].fill_(epsilon)
    C = torch.diag(diag)
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


# ---------------------------------------------------------------------
# Threshold route: the balls come from per-query thresholds, the sums
# from the setup kernels (ops/cuda_moments.py).

def rot_t9_to_rot(rot_t9: torch.Tensor) -> torch.Tensor:
    """[B,9,N] transposed frames (rows x0,x1,x2, y0,y1,y2, z0,z1,z2) ->
    [B,N,3,3] rotations with axis j in COLUMN j."""
    bsz, _, n = rot_t9.shape
    return rot_t9.reshape(bsz, 3, 3, n).permute(0, 3, 2, 1)


def toldi_frames_thr_t(points, thr_cen, thr_cov, thr_k, k: int, n_valid,
                       cloud=None, normals_k: int | None = None, rows=None,
                       point_major: bool = False):
    """TOLDI frames from neighbourhood thresholds, TRANSPOSED.

    points [B,N,3]; thr_cen / thr_cov / thr_k [B,N] squared-distance
    thresholds of the self-inclusive counts rz, rz+1, k (rz = k//3, also
    the centroid divisor: the reference's quirk); thr_k doubles as
    radius^2.  ``cloud``: the shared operands (``cuda_moments.
    setup_cloud``).  Returns [B,9,N] rows (x0,x1,x2, y0,y1,y2, z0,z1,z2).

    ``normals_k``: the pt2pl normals' count when it equals rz (the
    GOLDEN configuration: 30 = 90//3).  The centroid ball's sums ARE
    then the normals' moments, and three rows (n0,n1,n2) are appended
    ([B,12,N]): no separate normals pass.  ``rows=(r0, r1)``: the rows
    [r0, r1) only (thresholds and result r1 - r0 wide).
    ``point_major``: return (rows, frames [B,N,9]), the frames also
    point-major (``frames.view(B,N,3,3).mT`` is the rotation with axis j
    in column j).

    Four launches on the card: K2 (``cuda_moments.moments_raw``), G1
    (``cuda_frames.frame_inputs``), K3 (``cuda_moments.axis_sums_aux``),
    G2 (``cuda_frames.frame_assembly``).
    """
    rz = k // 3
    if normals_k is not None and normals_k != rz:
        raise ValueError(f"normals_k={normals_k} must equal k//3={rz}")
    cloud = cuda_moments._cloud(points, n_valid, cloud)
    r0 = cuda_moments.row_span(rows, points.shape[1])[0]
    raw = cuda_moments.moments_raw(points, n_valid, (thr_cen, thr_cov, thr_k),
                                   cloud, rows)
    normal_t, aux, fused = cuda_frames.frame_inputs(
        raw, points, cloud.tn, thr_k, rz, normals_k, r0)
    w = cuda_moments.axis_sums_aux(points, n_valid, normal_t, aux, cloud,
                                   rows)
    out_t, frames = cuda_frames.frame_assembly(raw, points, normal_t, w,
                                               fused, r0)
    return (out_t, frames) if point_major else out_t


def frames_to_rot(frames: torch.Tensor) -> torch.Tensor:
    """[B,N,9] point-major frames (``toldi_frames_thr_t(...,
    point_major=True)``) -> [B,N,3,3] rotations with axis j in COLUMN j
    (a view)."""
    bsz, n, _ = frames.shape
    return frames.view(bsz, n, 3, 3).mT


def normals_thr_t(points, thr, k_use: int, n_valid, cloud=None,
                  rows=None) -> torch.Tensor:
    """PCA normals [B,3,N] from one threshold per query: the ball of the
    self-inclusive count ``k_use`` (the mean still divides by k_use, as
    ``normals_dense``); of the rows ``rows`` only.  K2's one-ball
    instance, then G1 (``cuda_frames.ball_normals``)."""
    raw = cuda_moments.moments_raw(points, n_valid, (thr,), cloud, rows)
    r0 = cuda_moments.row_span(rows, points.shape[1])[0]
    return cuda_frames.ball_normals(raw, points, k_use, r0)


def gicp_covariances_thr_t(points, thr, k_use: int, epsilon: float,
                           n_valid, cloud=None, rows=None) -> torch.Tensor:
    """GICP covariance init [B,6,N] from one threshold per query (of the
    rows ``rows`` only): the normals of ``normals_thr_t`` and
    ``gicp_cov6_from_normals_t`` in one G1 pass."""
    raw = cuda_moments.moments_raw(points, n_valid, (thr,), cloud, rows)
    r0 = cuda_moments.row_span(rows, points.shape[1])[0]
    return cuda_frames.ball_normals(raw, points, k_use, r0,
                                    gicp_epsilon=epsilon)


# ---------------------------------------------------------------------
# SHOT frames (the JAX package's ``shot_frames_dense``, ``shot_frames``,
# ``shot_truncated_count``), batched over pairs.

def _shot_axes(cov):
    """(x+, z+) [.., 3]: the eigenvectors of the largest and smallest
    eigenvalue of a [..,3,3] covariance."""
    _, vecs = eigh3.eigh3(cov)
    return vecs[..., 2], vecs[..., 0]


def _shot_rot(x, z):
    return torch.stack([x, torch.linalg.cross(z, x, dim=-1), z], dim=-1)


def shot_frames_dense(points: torch.Tensor, radius: float,
                      n_valid: torch.Tensor,
                      tie_iters: int = 40) -> torch.Tensor:
    """SHOT frames with EXACT radius semantics (no neighbour cap).

    points [B,N,3]; n_valid [B].  Returns rot [B,N,3,3], columns x, y, z.
    Query rows go in chunks (``_chunk_rows``: a [B,C,N] block within
    ``_CHUNK_BYTES``, 256 rows on the CPU).  A chunk's
    (radius - d)-weighted covariance is three masked products expanded
    about the query point; the sign counts are masked indicator sums;
    the median band (neighbour positions med-2..med+2 of the
    self-exclusive ascending list) comes sort-free from bisecting the
    neighbour count for its two bracketing order statistics,
    ``tie_iters`` steps each, a count of 0 opening the band at -inf so
    that d2 == 0 duplicates stay in.  Where the band clips at the list's
    ends (m < 5) it holds fewer than 5 samples (the reference reads out
    of bounds there); distance ties at its edges are all in."""
    dtype, dev = points.dtype, points.device
    bsz, n, _ = points.shape
    r2 = radius * radius
    col = torch.arange(n, device=dev)
    colv = col[None, :] < n_valid[:, None]                   # [B,N]
    P9 = (points[:, :, :, None] * points[:, :, None, :]).flatten(2)
    out = []
    chunk = _chunk_rows(bsz, n, points.element_size(), dev)
    for s0 in range(0, n, chunk):
        q = points[:, s0:s0 + chunk]                          # [B,C,3]
        c = q.shape[1]
        D2 = knn._pairwise_d2(q, points)                      # [B,C,N]
        mask = ((D2 <= r2) & colv[:, None, :]
                & (col[s0:s0 + c, None] != col[None, :]))     # skip self
        d = torch.sqrt(D2.clamp_min(0.0))
        w = torch.where(mask, radius - d, torch.zeros_like(d))
        del d
        S0 = w.sum(-1)
        S1 = w @ points                                       # [B,C,3]
        S2 = (w @ P9).reshape(bsz, c, 3, 3)
        del w
        cov = (S2 - S1[..., :, None] * q[..., None, :]
               - q[..., :, None] * S1[..., None, :]
               + S0[..., None, None] * q[..., :, None] * q[..., None, :])
        cov = cov / S0.clamp_min(1e-30)[..., None, None]
        x_plus, z_plus = _shot_axes(cov)
        m = mask.sum(-1)                                      # [B,C]
        # the median band's thresholds: the c-th smallest neighbour d2
        # for c = med-2 (below the band) and med+3 (through it); outside
        # the neighbourhood a distance counts as +inf, so the count is
        # one comparison (the bisection stays within [0, r2])
        med = m // 2
        counts = torch.stack([torch.minimum(torch.clamp_min(med - 2, 0), m),
                              torch.minimum(med + 3, m)])     # [2,B,C]
        D2n = torch.where(mask, D2, torch.full_like(D2, float("inf")))
        lo = torch.zeros((2, bsz, c), dtype=dtype, device=dev)
        hi = torch.full((2, bsz, c), r2, dtype=dtype, device=dev)
        for _ in range(tie_iters):
            mid = 0.5 * (lo + hi)
            cnt = torch.stack([(D2n <= mid[i, ..., None]).sum(-1)
                               for i in range(2)])
            below = cnt < counts
            lo = torch.where(below, mid, lo)
            hi = torch.where(below, hi, mid)
        del D2n
        thr = torch.where(counts == 0,
                          torch.full_like(hi, float("-inf")), hi)
        band = mask & (D2 > thr[0, ..., None]) & (D2 <= thr[1, ..., None])
        del D2
        # each axis flips when fewer than half of the neighbours lie on
        # its positive side; on an exact half, when fewer than 3 of the
        # median band's samples do
        axes = []
        for a in (x_plus, z_plus):
            pos = (a @ points.mT - torch.sum(q * a, -1, keepdim=True)) >= 0
            s2 = 2 * torch.sum(pos & mask, -1) - m
            s_tie = torch.sum(pos & band, -1)
            flip = torch.where(s2 == 0, s_tie < 3, s2 < 0)
            axes.append(torch.where(flip[..., None], -a, a))
        out.append(_shot_rot(*axes))
    return torch.cat(out, dim=1)


def shot_frames(points: torch.Tensor, radius: float, n_valid: torch.Tensor,
                max_k: int = 128) -> torch.Tensor:
    """SHOT frames over a radius neighbourhood capped at its ``max_k``
    nearest points (self included at rank 0): a neighbourhood denser than
    the cap is truncated to its nearest, unlike the reference's radius
    search (``shot_truncated_count`` counts such points).  points
    [B,N,3], n_valid [B] -> rot [B,N,3,3]."""
    idx, d2 = knn.knn_self(points, max_k, n_valid)            # [B,N,K]
    nb = _gather_rows(points, idx)                            # [B,N,K,3]
    d = torch.sqrt(d2.clamp_min(0.0))
    rank = torch.arange(max_k, device=points.device)
    in_r = (d2 <= radius * radius) & (rank >= 1)              # skip self
    w = torch.where(in_r, radius - d, torch.zeros_like(d))
    diffs = nb - points[:, :, None, :]                        # [B,N,K,3]
    cov = torch.einsum("bnk,bnki,bnkj->bnij", w, diffs, diffs)
    cov = cov / w.sum(-1).clamp_min(1e-30)[..., None, None]
    x_plus, z_plus = _shot_axes(cov)
    m = in_r.sum(-1)
    # the median band: neighbour positions med-2..med+2 of the
    # self-exclusive ascending list are ranks med-1..med+3 here
    med = m // 2
    offs = torch.arange(-2, 3, device=points.device)
    tie_rank = torch.clamp(med[..., None] + 1 - offs, 1, max_k - 1)
    axes = []
    for a in (x_plus, z_plus):
        dots = (diffs * a[..., None, :]).sum(-1)              # [B,N,K]
        pos = dots >= 0
        s2 = 2 * torch.sum(pos & in_r, -1) - m
        # a clipped band repeats a rank: count each of the 5 samples
        s_tie = torch.sum(torch.gather(pos, -1, tie_rank), -1)
        flip = torch.where(s2 == 0, s_tie < 3, s2 < 0)
        axes.append(torch.where(flip[..., None], -a, a))
    return _shot_rot(*axes)


def _gather_rows(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points [B,N,3], idx [B,N,K] -> [B,N,K,3]."""
    bsz, n, k = idx.shape
    flat = torch.gather(points, 1, idx.reshape(bsz, n * k, 1).expand(
        -1, -1, 3).to(torch.int64))
    return flat.reshape(bsz, n, k, 3)


def shot_truncated_count(points, radius: float, max_k: int) -> int:
    """Host check of the capped SHOT route: the number of points whose
    radius neighbourhood (self included) holds more than ``max_k``
    points, whose frames ``shot_frames`` builds from a truncated
    neighbourhood.  points [N,3] (numpy)."""
    import numpy as np
    from scipy.spatial import cKDTree
    pts = np.asarray(points)
    counts = cKDTree(pts).query_ball_point(
        pts, r=float(radius), return_length=True)
    return int((counts > max_k).sum())
