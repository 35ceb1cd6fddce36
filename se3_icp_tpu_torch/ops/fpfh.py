"""FPFH (Fast Point Feature Histograms) descriptors, natively batched.

Port of the JAX package's ``ops/fpfh.py``.  The reference feeds
Open3D's ``ComputeFPFHFeature`` (``KDTreeSearchParamKNN(100)`` on
normals of ``KDTreeSearchParamKNN(30)``) to its FGR baseline.  Semantics
follow Open3D's ``ComputePairFeatures`` / ``ComputeSPFHFeature`` /
``ComputeFPFHFeature`` (cpp/open3d/pipelines/registration/Feature.cpp):

  * per neighbour pair (p, q) with normals (n_p, n_q): order the pair so
    the point whose normal is closest (by |cos|) to the connecting line
    acts as the Darboux frame origin; features are
    f1 = atan2(w.n2, u.n2) in [-pi, pi], f2 = v.n2 in [-1, 1],
    f3 = u.d in [-1, 1];
  * SPFH: 3 x 11-bin histograms over the k-1 non-self neighbours, each
    neighbour contributing 100/(k-1);
  * FPFH_i = SPFH_i + sum_j SPFH_j / d2_ij, each 11-bin block re-scaled
    to sum 100 before the self term is added (Open3D's "simplification"
    of the PCL weighting, dividing by the SQUARED neighbour distance).

Every function takes clouds ``[B, N, ...]``.  The per-point neighbour
loops are one [B, rows, k] pair-feature pass (row chunks bound its
memory); a histogram is a ``scatter_add_`` of equal weights, which sums
the same in any order.  The neighbour-SPFH sum has the JAX package's two
routes: dense (default), a masked [B, rows, N] weight block contracted
with the SPFH table by ``torch.matmul`` -- a plain product, as the JAX
package leaves it to XLA -- and gathered (the oracle route; FGR's, its
sums in a fixed order of the pair's own rows).
"""

from __future__ import annotations

import math

import torch

from se3_icp_tpu_torch.ops import knn as knn_ops

FPFH_DIM = 33
_NBINS = 11
_ROW_ELEMS = 1 << 24     # [B, rows, k] elements of one pair-feature chunk
_DENSE_ROWS = 512        # query rows of one dense-sum block


def _dot3(a, b):
    """sum over the last axis of 3, as ((a0 b0 + a1 b1) + a2 b2): a fixed
    order, where a reduction's split on the card follows its shape."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) \
        + a[..., 2] * b[..., 2]


def pair_features(p1, n1, p2, n2):
    """Darboux-frame pair features, vectorised over leading dims.

    Returns (f1, f2, f3, d): angle atan2 in [-pi,pi], two cosines in
    [-1,1], and the euclidean distance.  Zero features when the points
    coincide or the frame is degenerate (Open3D returns all-zeros then).
    """
    eps = 1e-30
    dp = p2 - p1
    d = torch.sqrt(_dot3(dp, dp))
    dsafe = torch.clamp_min(d, eps)
    angle1 = _dot3(n1, dp) / dsafe
    angle2 = _dot3(n2, dp) / dsafe
    # acos(|a1|) > acos(|a2|)  <=>  |a1| < |a2|: swap roles.  In the
    # swapped branch Open3D sets f3 = -angle2 (the direction vector is
    # negated along with the role swap)
    swap = torch.abs(angle1) < torch.abs(angle2)
    sw = swap[..., None]
    n1b, n2b = torch.broadcast_tensors(n1, n2)
    n1c = torch.where(sw, n2b, n1b)
    n2c = torch.where(sw, n1b, n2b)
    dpc = torch.where(sw, -dp, dp)
    f3 = torch.where(swap, -angle2, angle1)

    v = torch.linalg.cross(dpc, n1c, dim=-1)
    vn = torch.sqrt(_dot3(v, v))
    v = v / torch.clamp_min(vn, eps)[..., None]
    w = torch.linalg.cross(n1c, v, dim=-1)
    f2 = _dot3(v, n2c)
    f1 = torch.atan2(_dot3(w, n2c), _dot3(n1c, n2c))

    ok = (d > 0) & (vn > 0)
    zero = torch.zeros_like(f1)
    return (torch.where(ok, f1, zero), torch.where(ok, f2, zero),
            torch.where(ok, f3, zero), d)


def _hist11(value, lo: float, hi: float, weight):
    """[B,C,k] values -> [B,C,11] weighted histogram."""
    b = torch.floor(_NBINS * (value - lo) / (hi - lo)).to(torch.int64)
    b = torch.clamp(b, 0, _NBINS - 1)
    out = torch.zeros(value.shape[:-1] + (_NBINS,), dtype=value.dtype,
                      device=value.device)
    return out.scatter_add_(-1, b, weight)


def _gather_rows(table, idx):
    """table [B,N,F], idx [B,C,k] -> [B,C,k,F]."""
    bsz, c, k = idx.shape
    f = table.shape[-1]
    flat = idx.reshape(bsz, c * k, 1).expand(-1, -1, f)
    return torch.gather(table, 1, flat).reshape(bsz, c, k, f)


def spfh(points, normals, idx, nb_mask):
    """Simple Point Feature Histograms: [B,N,33].

    ``idx [B,N,k]``: neighbour indices with self at rank 0 (dropped);
    ``nb_mask [B,N,k]``: True for real (non-padded) neighbours.
    """
    dtype = points.dtype
    bsz, n, k = idx.shape
    pn = torch.cat([points, normals], dim=-1)
    rows = max(1, _ROW_ELEMS // max(bsz * k, 1))
    out = []
    for s in range(0, n, rows):
        nb_idx = idx[:, s:s + rows, 1:].to(torch.int64)
        mask = nb_mask[:, s:s + rows, 1:].to(dtype)
        q = _gather_rows(pn, nb_idx)                      # [B,C,k-1,6]
        f1, f2, f3, _ = pair_features(points[:, s:s + rows, None, :],
                                      normals[:, s:s + rows, None, :],
                                      q[..., :3], q[..., 3:])
        # hist_incr = 100 / (#neighbours excl. self)  (SPFH loop)
        cnt = torch.clamp_min(torch.sum(mask, dim=-1, keepdim=True), 1.0)
        w = 100.0 / cnt * mask
        out.append(torch.cat([_hist11(f1, -math.pi, math.pi, w),
                              _hist11(f2, -1.0, 1.0, w),
                              _hist11(f3, -1.0, 1.0, w)], dim=-1))
    return torch.cat(out, dim=1)


def fpfh_from_neighbors(points, normals, idx, d2, nb_mask, n_valid=None,
                        dense_sum: bool = True, spfh_table=None):
    """FPFH [B,N,33] from a precomputed sorted kNN (self at rank 0).

    ``d2``: squared neighbour distances (the divisor Open3D uses).  The
    neighbour-SPFH accumulation  sum_j spfh[j]/d2_ij  runs DENSELY by
    default (as the JAX package's): the kNN's own last distance column is
    the ball threshold, the weights  (d2 <= thr) / d2  are recomputed
    block-wise from positions, and the sum is a product ``w @ spfh`` --
    no [B,N,k,33] gather.  A boundary tie may add a member or two.  The
    query itself is left out by its index (the JAX package leaves it out
    by ``d2 > 0`` alone, which its float32 self-distance misses for ~10%
    of the rows).  ``dense_sum=False``: the gathered route, over the
    kNN's own ranks (the query left out by its index), summed in
    ascending row index whatever the batch (FGR's route).  ``n_valid``
    [B]: valid-row counts for the dense column mask (default all rows).
    ``spfh_table``: the SPFH [B,N,33] of these neighbourhoods, if the
    caller has it.
    """
    dtype = points.dtype
    s = (spfh(points, normals, idx, nb_mask) if spfh_table is None
         else spfh_table)                                 # [B,N,33]
    bsz, n, _ = points.shape
    if dense_sum:
        thr = d2[..., -1]                                 # rank-k radius^2
        tn = torch.sum(points * points, dim=-1)           # [B,N]
        col = torch.arange(n, device=points.device)
        if n_valid is None:
            col_ok = torch.ones((bsz, n), dtype=torch.bool,
                                device=points.device)
        else:
            col_ok = col[None, :] < n_valid[:, None]
        acc = []
        for r in range(0, n, _DENSE_ROWS):
            q = points[:, r:r + _DENSE_ROWS]
            qn = torch.sum(q * q, dim=-1, keepdim=True)
            d2f = qn - 2.0 * (q @ points.mT) + tn[:, None, :]
            # the query itself by its index: its float32 distance
            # |q|^2 - 2 q.q + |q|^2 is a few ulps of |q|^2, not always 0,
            # and 1/d2 would give it a weight ~1e5
            other = col[None, :] != col[r:r + _DENSE_ROWS, None]
            keep = ((d2f <= thr[:, r:r + _DENSE_ROWS, None]) & (d2f > 0)
                    & other & col_ok[:, None, :])
            w = torch.where(keep, 1.0 / torch.clamp_min(d2f, 1e-30),
                            torch.zeros((), dtype=dtype,
                                        device=points.device))
            acc.append(w @ s)
        acc = torch.cat(acc, dim=1)
    else:
        # the kNN's own members, the query left out by its index, summed
        # in ascending row index (``knn.neighbor_sums``: a pair's bits do
        # not depend on its batch)
        own = torch.arange(n, device=points.device)[None, :, None]
        keep = nb_mask & (d2 > 0) & (idx.to(torch.int64) != own)
        inv_d2 = 1.0 / torch.clamp_min(d2, 1e-30)
        acc = knn_ops.neighbor_sums(s, idx, keep, inv_d2)
    # per-block renormalisation to 100, then + own SPFH (Feature.cpp)
    blocks = acc.reshape(bsz, n, 3, _NBINS)
    bsum = blocks[..., :1]
    for i in range(1, _NBINS):          # bin by bin, in a fixed order
        bsum = bsum + blocks[..., i:i + 1]
    scale = torch.where(bsum > 0, 100.0 / torch.clamp_min(bsum, 1e-30),
                        torch.zeros((), dtype=dtype, device=points.device))
    return (blocks * scale).reshape(bsz, n, FPFH_DIM) + s


def neighbor_mask(n: int, k: int, n_valid: torch.Tensor) -> torch.Tensor:
    """[B,n,k]: a valid query's first min(n_valid, k) ranks are real
    neighbours (padded targets sort to the back of the masked kNN)."""
    rank = torch.arange(k, device=n_valid.device)
    row = torch.arange(n, device=n_valid.device)
    return ((rank[None, None, :] < torch.clamp(n_valid, max=k)[:, None, None])
            & (row[None, :, None] < n_valid[:, None, None]))


def fpfh(points, normals, n_valid: torch.Tensor, knn: int = 100):
    """FPFH descriptors for padded clouds [B,N,3] with valid counts
    n_valid [B]: [B,N,33].  Rows beyond ``n_valid`` are garbage and must
    be masked downstream."""
    idx, d2 = knn_ops.knn_self(points, knn, n_valid)
    return fpfh_from_neighbors(points, normals, idx, d2,
                               neighbor_mask(points.shape[1], knn, n_valid),
                               n_valid=n_valid)
