"""Cross-route LRF quality evaluation.

Port of the JAX package's ``utils/lrf_eval.py``.  The reference checks
local reference frames with ``cc::evaluate_LRF_quality``: the SO(3)
error between GT-transformed source frames and matched target frames.
This module packages that check for comparing the engine's two TOLDI
setup routes -- the sort-free threshold route (K1-K3, the default) and
the exact sorted kNN -- across independently sampled, noisy, partially
overlapping cloud pairs, the regime in which the 12-D correspondence
search matches frames.

The ground-truth correspondences come from the port's own 1-NN
(``metrics.compute_corrs_with_gt``: the kernel K9 on the card), where
the JAX package asks scipy's k-d tree in float64; both are exact 1-NN
searches, and they can differ only between targets within float32
rounding of each other.
"""

from __future__ import annotations

import numpy as np
import torch

from se3_icp_tpu_torch.utils import metrics


def _pad(pts, dev):
    """One cloud as a padded batch of one: ([1,bucket,3] float32, [1])."""
    from se3_icp_tpu_torch.models import registration as reg
    pts = np.asarray(pts, np.float64)
    n = len(pts)
    out = np.zeros((1, reg._bucket(n), 3))
    out[0, :n] = pts
    return (torch.as_tensor(out, dtype=torch.float32, device=dev),
            torch.tensor([n], dtype=torch.int32, device=dev), n)


def toldi_frames_thr_route(pts, k: int, device="cuda") -> torch.Tensor:
    """TOLDI frames [N,3,3] (axes in columns) through the sort-free
    threshold route: K1 thresholds of the counts {k//3, k//3+1, k},
    then K2/K3 and the glue of ``lrf.toldi_frames_thr_t``."""
    from se3_icp_tpu_torch.models import registration as reg
    from se3_icp_tpu_torch.ops import lrf
    dev = reg.resolve_device(device)
    pp, nv, n = _pad(pts, dev)
    rz = k // 3
    with torch.no_grad():
        cloud, thr = reg._thresholds(pp, nv, sorted({rz, rz + 1, k},
                                                    reverse=True))
        rot_t = lrf.toldi_frames_thr_t(pp, thr[rz], thr[rz + 1], thr[k], k,
                                       nv, cloud=cloud)
    return lrf.rot_t9_to_rot(rot_t)[0, :n]


def toldi_frames_exact_route(pts, k: int, device="cuda") -> torch.Tensor:
    """TOLDI frames [N,3,3] through the exact sorted kNN."""
    from se3_icp_tpu_torch.models import registration as reg
    from se3_icp_tpu_torch.ops import knn, lrf
    dev = reg.resolve_device(device)
    pp, nv, n = _pad(pts, dev)
    with torch.no_grad():
        _, d2 = knn.knn_self(pp, k, nv)
        rot = lrf.toldi_frames_dense(pp, d2, nv)
    return rot[0, :n]


def cross_cloud_lrf_errors(src, tgt, T_gt, k: int = 90, inlier=None,
                           device="cuda") -> dict:
    """Per-route LRF angular errors (degrees, numpy) over GT
    correspondences, restricted to the true overlap region when
    ``inlier`` (a distance) is given.  Returns {"thr": errors, "exact":
    errors}."""
    src = np.asarray(src, np.float64)
    tgt = np.asarray(tgt, np.float64)
    T_gt = np.asarray(T_gt, np.float64)
    corr = metrics.compute_corrs_with_gt(src, tgt, T_gt, device=device)
    nn = corr[:, 1].cpu().numpy()
    keep = np.ones(len(src), bool)
    if inlier is not None:
        moved = src @ T_gt[:3, :3].T + T_gt[:3, 3]
        keep = np.linalg.norm(moved - tgt[nn], axis=-1) < inlier
    out = {}
    for name, frames in (("thr", toldi_frames_thr_route),
                         ("exact", toldi_frames_exact_route)):
        rs = frames(src, k, device)
        rt = frames(tgt, k, device)
        R = torch.as_tensor(T_gt[:3, :3], dtype=rs.dtype, device=rs.device)
        keep_t = torch.as_tensor(keep, device=rs.device)
        nn_t = torch.as_tensor(nn[keep], device=rs.device)
        out[name] = metrics.angular_error_so3_alt(
            R @ rs[keep_t], rt[nn_t], device=rs.device).cpu().numpy()
    return out
