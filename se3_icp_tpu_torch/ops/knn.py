"""Brute-force nearest-neighbour search, natively batched.

Replaces every FLANN KD-tree of the reference: the k-NN of a cloud
against itself (TOLDI k=90, normal/covariance neighbourhoods) and the
plain 1-NN searches.  At the reference's cloud sizes (~4k-15k points) an
O(N^2) distance block is one batched matrix product followed by a
selection.

All functions take clouds ``[B, N, D]`` with per-cloud valid counts
``[B]`` so padded rows mask correctly, and break 1-NN distance ties
toward the lowest target index.  Squared distances are written in the
explicit ``|q|^2 - 2 q.t^T + |t|^2`` form (not ``torch.cdist``) so they
round like the JAX package's ``_pairwise_d2``; the product must run in
full float32 (see ``require_full_precision``).
"""

from __future__ import annotations

import torch

_BIG = 3.4e38  # ~f32 max; used instead of inf so masked math stays finite

# Memory budget of one query chunk's [B, chunk, Nt] distance block
# (bytes): the chunk shrinks with the batch so the block stays bounded
# (1152 query rows at 64 x 4608 float32).
_TOPK_BATCH_BUDGET = 1_500_000_000


def require_full_precision() -> None:
    """State and enforce full-float32 matrix products.  TF32 or bf16
    distances flip nearest neighbours between close candidates and the
    GICP solve diverges; every contraction of the engine is exact-class
    float32, as the JAX package runs them at ``highest`` precision."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _pairwise_d2(q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """[...,Cq,D] x [...,Nt,D] -> [...,Cq,Nt] squared distances (matmul
    form)."""
    qn = torch.sum(q * q, dim=-1, keepdim=True)
    tn = torch.sum(t * t, dim=-1)
    return qn - 2.0 * (q @ t.mT) + tn[..., None, :]


def _mask_cols(d2: torch.Tensor, n_targets: torch.Tensor) -> torch.Tensor:
    """Columns j >= n_targets[b] -> _BIG.  d2 [B,Cq,Nt], n_targets [B]."""
    col = torch.arange(d2.shape[-1], device=d2.device)
    return torch.where(col[None, None, :] < n_targets[:, None, None], d2,
                       torch.full((), _BIG, dtype=d2.dtype,
                                  device=d2.device))


def _query_chunk(bsz: int, nq: int, nt: int, itemsize: int) -> int:
    """Equal lane-aligned query chunks whose [B, chunk, Nt] block fits
    the budget (same rule as the JAX package's ``_knn_topk_batched``)."""
    chunk = max(128, _TOPK_BATCH_BUDGET // max(bsz * nt * itemsize, 1))
    steps = max(1, -(-nq // chunk))
    return -(-(-(-nq // steps)) // 128) * 128


def knn_topk(queries: torch.Tensor, targets: torch.Tensor, k: int,
             n_targets: torch.Tensor):
    """k smallest-distance neighbours, ascending.

    queries [B,Nq,D], targets [B,Nt,D], n_targets [B] ->
    (idx [B,Nq,k] int64, d2 [B,Nq,k]).  Exact (``torch.topk`` on the
    masked distance block); chunked over QUERIES only, so results do not
    depend on the chunk size.
    """
    bsz, nq, _ = queries.shape
    nt = targets.shape[1]
    if k > nt:
        raise ValueError(f"k={k} exceeds the padded target count {nt}")
    chunk = _query_chunk(bsz, nq, nt, queries.element_size())
    idx_out, d2_out = [], []
    for s in range(0, nq, chunk):
        d2 = _mask_cols(_pairwise_d2(queries[:, s:s + chunk], targets),
                        n_targets)
        val, idx = torch.topk(d2, k, dim=-1, largest=False, sorted=True)
        idx_out.append(idx)
        d2_out.append(val)
    return torch.cat(idx_out, 1), torch.cat(d2_out, 1)


def knn_self(points: torch.Tensor, k: int, n_valid: torch.Tensor):
    """kNN of each cloud against itself (self included at rank 0)."""
    return knn_topk(points, points, k, n_valid)


def nn_argmin(queries: torch.Tensor, targets: torch.Tensor,
              n_targets: torch.Tensor):
    """Exact 1-NN: (idx [B,Nq] int64, d2 [B,Nq]); ties go to the lowest
    target index."""
    bsz, nq, _ = queries.shape
    nt = targets.shape[1]
    chunk = _query_chunk(bsz, nq, nt, queries.element_size())
    idx_out, d2_out = [], []
    for s in range(0, nq, chunk):
        d2 = _mask_cols(_pairwise_d2(queries[:, s:s + chunk], targets),
                        n_targets)
        val = d2.amin(-1)
        # first index attaining the minimum (argmin's tie order is not
        # part of torch's contract on every backend)
        col = torch.arange(nt, device=d2.device)
        idx = torch.where(d2 == val[..., None], col,
                          torch.full((), nt, device=d2.device)).amin(-1)
        idx_out.append(idx)
        d2_out.append(val)
    return torch.cat(idx_out, 1), torch.cat(d2_out, 1)


def nn_match(queries: torch.Tensor, targets: torch.Tensor,
             payload: torch.Tensor, n_targets: torch.Tensor):
    """1-NN + matched payload row: (idx [B,Nq], d2 [B,Nq], matched
    [B,Nq,P]) with matched[b,i] == payload[b, idx[b,i]]."""
    idx, d2 = nn_argmin(queries, targets, n_targets)
    matched = torch.gather(
        payload, 1, idx[..., None].expand(-1, -1, payload.shape[-1]))
    return idx, d2, matched
