"""The threshold route's setup glue as two kernels (G1, G2) around the
moments (K2) and the TOLDI axis sums (K3).

No TPU kernel: on the TPU these are XLA fusions of the JAX package's
glue (``se3_icp_tpu/ops/lrf.py`` ``_toldi_fused_from_thr``,
``_normals_fused_batched``, ``gicp_cov6_from_normals_t``).  The port ran
the same glue as ~1,000 small torch ops a setup; ``csrc/frames.cu`` runs
it in one pass a query:

  * G1 ``frame_inputs`` (TOLDI): from K2's raw sums of the three balls,
    the unsigned normal of the covariance ball about the quirky centroid
    (``toldi_axis_inputs``), and K3's operands -- the normal and aux =
    (thr_k - |q|^2, radius, n.q) --; with ``normals_k`` the pt2pl normal
    of the centroid ball too (``_pca_normal_t``).  ``ball_normals``: the
    one-ball modes, PCA normals [B,3,C] or, with ``gicp_epsilon``, the
    GICP covariances [B,6,C] (``gicp_cov6_from_normals_t``).
  * G2 ``frame_assembly``: after K3, the frame rows [B,9,C] (with the
    fused normal [B,12,C]) and the same frames point-major [B,C,9], the
    layout the loop's packing reads (``registration.pack_match_state``:
    ``frames.view(B,C,3,3).mT`` is the rotation with its axes in columns).

The plain versions are the torch glue as it was, on the moments dict of
``cuda_moments._moments_dict``; they run in the caller's dtype.  The
kernels take float32 and give the plain versions' bits on the card: each
float32 step of that glue, in its order, explicitly rounded
(``csrc/eigh3_rn.cuh``), torch's division of a tensor by a Python number
as the multiplication by its float32 reciprocal that torch performs on
the card, and torch's three-term component sums as ((a0 + a1) + a2) + 0.
A wrapper given CUDA tensors launches its kernel or raises; it runs the
plain version only for tensors on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from se3_icp_tpu_torch.ops import _build, cuda_moments, eigh3
from se3_icp_tpu_torch.ops.cuda_knn import _check

_MODE = {"toldi": 0, "normals": 1, "gicp": 2}


def _bits(x) -> int:
    """The int32 bit pattern of ``x`` as float32 (a float argument of a C
    entry point that takes ints only)."""
    return int(np.asarray(x, dtype=np.float32).view(np.int32))


def _p9self(q_t: torch.Tensor) -> torch.Tensor:
    return torch.cat([q_t * q_t[:, i:i + 1] for i in range(3)], 1)


def _pca_normal_t(mom, k_use: int, key: str) -> torch.Tensor:
    """PCA normal [B,3,N] from the ``key`` ball's sums with the self term
    added back (self INCLUDED, as ``lrf.normals_dense``), mean over
    k_use."""
    q_t = mom["q_t"]
    s1 = mom[key + "_sum"] + q_t
    s2 = mom[key + "_p9"] + _p9self(q_t)
    m = mom[key + "_cnt"] + 1.0
    kinv = 1.0 / k_use
    mean = s1 * kinv

    def covc(i, j):
        return (s2[:, 3 * i + j] - s1[:, i] * mean[:, j]
                - mean[:, i] * s1[:, j] + m * mean[:, i] * mean[:, j]) * kinv
    return torch.stack(eigh3.smallest_eigvec3_c(
        covc(0, 0), covc(0, 1), covc(0, 2), covc(1, 1), covc(1, 2),
        covc(2, 2)), 1)


def toldi_axis_inputs(mom, thr_k, rz: int):
    """What the TOLDI x-axis sums (K3) take from the moments (K2): the
    unsigned normal [B,3,N] of the covariance ball about the quirky
    centroid (the rz-ball's sum over rz), n.q [B,N], and the radius
    sqrt(thr_k) [B,N]."""
    q_t = mom["q_t"]
    cen = mom["cen_sum"] / float(rz)
    s1, s2, m = mom["cov_sum"], mom["cov_p9"], mom["cov_cnt"]

    def covc(i, j):
        return (s2[:, 3 * i + j] - s1[:, i] * cen[:, j]
                - cen[:, i] * s1[:, j] + m * cen[:, i] * cen[:, j])
    nx, ny, nz = eigh3.smallest_eigvec3_c(
        covc(0, 0), covc(0, 1), covc(0, 2), covc(1, 1), covc(1, 2),
        covc(2, 2))
    ndotq = nx * q_t[:, 0] + ny * q_t[:, 1] + nz * q_t[:, 2]
    radius = torch.sqrt(torch.clamp_min(thr_k, 0.0))
    return torch.stack([nx, ny, nz], 1), ndotq, radius


def gicp_cov6_from_normals_t(normals_t: torch.Tensor,
                             epsilon: float = 1e-3) -> torch.Tensor:
    """GICP covariance init from unit normals [B,3,N]: the closed form
    C = I - (1 - eps) n n^T of Rx diag(eps,1,1) Rx^T, INCLUDING the
    reference's c < -0.99 -> identity-rotation quirk (C = diag(eps,1,1)
    there).  Returns [B,6,N] rows (xx, xy, xz, yy, yz, zz)."""
    nx, ny, nz = normals_t.unbind(1)
    f = 1.0 - epsilon
    one = torch.ones_like(nx)
    zero = torch.zeros_like(nx)
    comps = [one - f * nx * nx, -f * nx * ny, -f * nx * nz,
             one - f * ny * ny, -f * ny * nz, one - f * nz * nz]
    quirk_comps = [torch.full_like(nx, epsilon), zero, zero, one, zero, one]
    quirk = nx < -0.99
    return torch.stack([torch.where(quirk, qc, c)
                        for c, qc in zip(comps, quirk_comps)], 1)


def _rows(points, r0: int, nq: int):
    return points[:, r0:r0 + nq]


# ---------------------------------------------------------------- G1

def frame_inputs_plain(raw, points, tn, thr_k, rz: int, normals_k=None,
                       r0: int = 0):
    """Plain PyTorch version of ``frame_inputs``."""
    nq = raw.shape[2]
    mom = cuda_moments._moments_dict(raw, _rows(points, r0, nq))
    normal_t, ndotq, radius = toldi_axis_inputs(mom, thr_k, rz)
    f32 = torch.float32
    aux = torch.stack([thr_k.to(f32) - tn[:, r0:r0 + nq], radius.to(f32),
                       ndotq.to(f32)], 1)
    fused = (None if normals_k is None
             else _pca_normal_t(mom, normals_k, "cen"))
    return normal_t, aux, fused


def frame_inputs(raw, points, tn, thr_k, rz: int, normals_k=None,
                 r0: int = 0):
    """G1, TOLDI mode: from K2's raw sums of the query rows r0 .. r0 + C
    - 1 (``cuda_moments.moments_raw``, three balls: the rz-, rz+1- and
    k-balls, raw [B,30,C]), the cloud ``points`` [B,N,3] and its |p|^2
    ``tn`` [B,N], and the k-ball's threshold ``thr_k`` [B,C]:

      normal_t [B,3,C]  the unsigned TOLDI z-axis (caller's dtype);
      aux [B,3,C]       K3's per-query operands (thr_k - |q|^2, radius,
                        n.q), float32;
      fused [B,3,C]     with ``normals_k`` (= rz), the PCA normal of the
                        centroid ball, else None.
    """
    if not raw.is_cuda:
        return frame_inputs_plain(raw, points, tn, thr_k, rz, normals_k, r0)
    bsz, _, nq = raw.shape
    n = points.shape[1]
    dev, f32 = raw.device, torch.float32
    _check(raw, "raw", (bsz, 30, nq), f32, dev)
    _check(points, "points", (bsz, n, 3), f32, dev)
    _check(tn, "tn", (bsz, n), f32, dev)
    if thr_k.shape != (bsz, nq) or thr_k.dtype != f32 or thr_k.stride(1) != 1:
        raise ValueError("thr_k: [B,C] float32 with unit column stride")
    out = torch.empty((3, bsz, 3, nq), dtype=f32, device=dev)
    fuse = normals_k is not None
    code = _build.launch(
        _build.load().se3icp_frame_inputs, dev, raw.data_ptr(),
        points.data_ptr(), tn.data_ptr(), thr_k.data_ptr(), out[0].data_ptr(),
        out[1].data_ptr(), out[2].data_ptr(), bsz, n, nq, r0,
        thr_k.stride(0), _MODE["toldi"], int(fuse),
        _bits(np.float32(1.0) / np.float32(rz)),
        _bits(1.0 / normals_k) if fuse else 0, 0)
    _build.check(code, "frame_inputs")
    _build.count_launch("frame_inputs", dev)
    return out[0], out[1], (out[2] if fuse else None)


def ball_normals_plain(raw, points, k_use: int, r0: int = 0,
                       gicp_epsilon=None):
    """Plain PyTorch version of ``ball_normals``."""
    mom = cuda_moments._moments_dict(raw, _rows(points, r0, raw.shape[2]))
    nrm = _pca_normal_t(mom, k_use, "cov")
    if gicp_epsilon is None:
        return nrm
    return gicp_cov6_from_normals_t(nrm, gicp_epsilon)


def ball_normals(raw, points, k_use: int, r0: int = 0, gicp_epsilon=None):
    """G1, one-ball modes: from K2's raw sums of one ball (raw [B,10,C],
    ``cuda_moments.moments_raw`` with one threshold) of the query rows
    r0 .. r0 + C - 1 of ``points`` [B,N,3], the PCA normals [B,3,C]
    (self included, mean over ``k_use``), or with ``gicp_epsilon`` the
    GICP covariances [B,6,C] made from them."""
    if not raw.is_cuda:
        return ball_normals_plain(raw, points, k_use, r0, gicp_epsilon)
    bsz, _, nq = raw.shape
    n = points.shape[1]
    dev, f32 = raw.device, torch.float32
    _check(raw, "raw", (bsz, 10, nq), f32, dev)
    _check(points, "points", (bsz, n, 3), f32, dev)
    gicp = gicp_epsilon is not None
    out = torch.empty((bsz, 6 if gicp else 3, nq), dtype=f32, device=dev)
    code = _build.launch(
        _build.load().se3icp_frame_inputs, dev, raw.data_ptr(),
        points.data_ptr(), None, None, out.data_ptr(), None, None, bsz, n,
        nq, r0, 0, _MODE["gicp" if gicp else "normals"], 0,
        _bits(1.0 / k_use), _bits(1.0 - gicp_epsilon) if gicp else 0,
        _bits(gicp_epsilon) if gicp else 0)
    _build.check(code, "frame_inputs")
    _build.count_launch("frame_inputs", dev)
    return out


# ---------------------------------------------------------------- G2

def frame_assembly_plain(raw, points, normal_t, w, fused=None, r0: int = 0):
    """Plain PyTorch version of ``frame_assembly``."""
    nq = raw.shape[2]
    dtype = points.dtype
    mom = cuda_moments._moments_dict(raw, _rows(points, r0, nq))
    q_t = mom["q_t"]
    arrow = mom["all_sum"] - mom["all_cnt"][:, None] * q_t
    w_p, w_sum = w[:, :3], w[:, 3]
    scaled = w_p.to(dtype) - w_sum.to(dtype)[:, None] * q_t   # [B,3,N]

    flip = torch.sum(normal_t * arrow, 1) < 0.0
    z = torch.where(flip[:, None], -normal_t, normal_t)
    x = scaled - torch.sum(scaled * z, 1, keepdim=True) * z
    xn = torch.sqrt(torch.sum(x * x, 1, keepdim=True))
    x = x / torch.clamp_min(xn, 1e-30)
    y = torch.stack([z[:, 1] * x[:, 2] - z[:, 2] * x[:, 1],
                     z[:, 2] * x[:, 0] - z[:, 0] * x[:, 2],
                     z[:, 0] * x[:, 1] - z[:, 1] * x[:, 0]], 1)
    rows = [x, y, z]
    if fused is not None:
        rows.append(fused)
    out_t = torch.cat(rows, 1)
    return out_t, out_t[:, :9].mT


def frame_assembly(raw, points, normal_t, w, fused=None, r0: int = 0):
    """G2: the TOLDI frames of the query rows r0 .. r0 + C - 1 from K2's
    raw sums (raw [B,30,C]: the arrow of the k-ball), ``points``
    [B,N,3], G1's ``normal_t`` [B,3,C], K3's sums ``w`` [B,4,C]
    (sum W p, sum W) and, optionally, G1's fused normal [B,3,C].
    Returns (out_t [B,9,C] rows x0,x1,x2, y0,y1,y2, z0,z1,z2 -- [B,12,C]
    with the fused normal's rows appended --, frames [B,C,9] the same
    nine point-major)."""
    if not raw.is_cuda:
        return frame_assembly_plain(raw, points, normal_t, w, fused, r0)
    bsz, _, nq = raw.shape
    n = points.shape[1]
    dev, f32 = raw.device, torch.float32
    _check(raw, "raw", (bsz, 30, nq), f32, dev)
    _check(points, "points", (bsz, n, 3), f32, dev)
    _check(normal_t, "normal_t", (bsz, 3, nq), f32, dev)
    _check(w, "w", (bsz, 4, nq), f32, dev)
    if fused is not None:
        _check(fused, "fused", (bsz, 3, nq), f32, dev)
    rows = 9 if fused is None else 12
    out_t = torch.empty((bsz, rows, nq), dtype=f32, device=dev)
    frames = torch.empty((bsz, nq, 9), dtype=f32, device=dev)
    code = _build.launch(
        _build.load().se3icp_frame_assembly, dev, raw.data_ptr(),
        points.data_ptr(), normal_t.data_ptr(), w.data_ptr(),
        None if fused is None else fused.data_ptr(), out_t.data_ptr(),
        frames.data_ptr(), bsz, n, nq, r0)
    _build.check(code, "frame_assembly")
    _build.count_launch("frame_assembly", dev)
    return out_t, frames
