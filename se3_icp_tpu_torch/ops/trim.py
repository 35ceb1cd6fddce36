"""Trimmed correspondence rejection as a fixed-shape rank mask.

Replaces PCL's ``CorrespondenceRejectorTrimmed``: keep the
``floor(overlap_ratio * N)`` correspondences with the smallest stored
distance.  The kept subset is a 0/1 mask fed to the weight-aware
estimators -- mathematically identical to compaction.

The mask comes from a sort-free count bisection: ``_STEPS`` halvings on
the distance values bracket the count-th distance, then an
index-ordered cumulative count fills the boundary band to the EXACT
count (equal values resolve toward the lower index, like a stable
sort).  The fused loop epilogue runs the same bisection, so both give
the same kept set.
"""

from __future__ import annotations

import torch

_BIG = 3.4e38
_STEPS = 26


def _value_brackets(distances: torch.Tensor, valid: torch.Tensor,
                    count: torch.Tensor):
    """``_STEPS`` halvings on the distance values of each row.

    distances/valid [B,N], count [B,1] in the distances' dtype.  Returns
    (d, lo, hi): d the distances with invalid entries at ``_BIG``, and
    brackets [B,1] with #(d <= lo) < count <= #(d <= hi) (for count >= 1)."""
    dt = distances.dtype
    d = torch.where(valid, distances, torch.full_like(distances, _BIG))
    hi = torch.where(valid, distances,
                     torch.zeros_like(distances)).amax(-1, keepdim=True)
    lo = torch.full_like(hi, -1.0)   # distances >= 0: c(lo) = 0 < count
    for _ in range(_STEPS):
        mid = 0.5 * (lo + hi)
        pred = (d <= mid).sum(-1, keepdim=True).to(dt) >= count
        lo, hi = torch.where(pred, lo, mid), torch.where(pred, mid, hi)
    return d, lo, hi


def _trim_mask_bisect(distances: torch.Tensor, valid: torch.Tensor,
                      count: torch.Tensor) -> torch.Tensor:
    """Keep the ``count`` smallest valid distances of each row (ties
    toward lower index).  distances [B,N], valid [B,N] bool, count [B]
    integer -> [B,N] bool."""
    d, lo, hi = _value_brackets(distances, valid,
                                count.to(distances.dtype)[:, None])
    below = d <= lo                             # strictly fewer than count
    n_below = below.sum(-1, keepdim=True)
    band = (d > lo) & (d <= hi)
    in_rank = torch.cumsum(band.to(torch.int64), dim=-1)  # 1-indexed
    kept_band = band & (in_rank <= count.to(torch.int64)[:, None] - n_below)
    return below | kept_band


def trim_mask(distances: torch.Tensor, valid: torch.Tensor,
              overlap_ratio: float, n_valid: torch.Tensor) -> torch.Tensor:
    """0/1 mask keeping the best floor(ratio * n_valid) valid entries of
    each row.  ``n_valid`` [B] carries the working float dtype."""
    if overlap_ratio >= 1.0:
        return valid
    count = torch.floor(overlap_ratio * n_valid).to(torch.int64)
    return _trim_mask_bisect(distances, valid, count)


def masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Row mean over masked entries (the reference's
    ``estimate_current_mse``: mean of the stored correspondence
    distances)."""
    m = mask.to(values.dtype)
    return (values * m).sum(-1) / m.sum(-1).clamp_min(1.0)
