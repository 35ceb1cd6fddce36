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
full float32 (see ``full_precision``).

The k-NN is a masked distance block and ``torch.topk``; the 1-NN
searches (``nn_argmin``, ``nn_match``, ``nn_match_packed``,
``nn_distances``) dispatch to the hand-written kernels K6-K9 of
``ops/cuda_nn.py`` on the card and to their plain versions on the CPU.
"""

from __future__ import annotations

import contextlib

import torch

from se3_icp_tpu_torch.ops import cuda_nn

_BIG = 3.4e38  # ~f32 max; used instead of inf so masked math stays finite

# Memory budget of one query chunk's [B, chunk, Nt] distance block
# (bytes): the chunk shrinks with the batch so the block stays bounded
# (1152 query rows at 64 x 4608 float32).
_TOPK_BATCH_BUDGET = 1_500_000_000


@contextlib.contextmanager
def full_precision():
    """Run the body with full-float32 matrix products, and give the
    caller's settings back on exit (also when the body raises).  TF32 or
    bf16 distances flip nearest neighbours between close candidates and
    the GICP solve diverges; every contraction of the engine is
    exact-class float32, as the JAX package runs its own work at
    ``highest`` precision.  Saved and restored:
    ``torch.backends.cuda.matmul.allow_tf32``,
    ``torch.backends.cudnn.allow_tf32`` and
    ``torch.get_float32_matmul_precision()``."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def _pairwise_d2(q: torch.Tensor, t: torch.Tensor,
                 fixed_order: bool = False) -> torch.Tensor:
    """[...,Cq,D] x [...,Nt,D] -> [...,Cq,Nt] squared distances (matmul
    form).  ``fixed_order``: the products and sums over D written out
    elementwise, component after component, so an entry's bits do not
    depend on the batch (a product's kernel on the card follows the
    batch's shape)."""
    if not fixed_order:
        qn = torch.sum(q * q, dim=-1, keepdim=True)
        tn = torch.sum(t * t, dim=-1)
        return qn - 2.0 * (q @ t.mT) + tn[..., None, :]
    qn, tn, dot = q[..., 0:1] * q[..., 0:1], t[..., 0] * t[..., 0], None
    for k in range(q.shape[-1]):
        if k:
            qn = qn + q[..., k:k + 1] * q[..., k:k + 1]
            tn = tn + t[..., k] * t[..., k]
        term = q[..., :, None, k] * t[..., None, :, k]
        dot = term if dot is None else dot + term
    return qn - 2.0 * dot + tn[..., None, :]


def _mask_cols(d2: torch.Tensor, n_targets: torch.Tensor) -> torch.Tensor:
    """Columns j >= n_targets[b] -> _BIG.  d2 [B,Cq,Nt], n_targets [B]."""
    col = torch.arange(d2.shape[-1], device=d2.device)
    return torch.where(col[None, None, :] < n_targets[:, None, None], d2,
                       torch.full((), _BIG, dtype=d2.dtype,
                                  device=d2.device))


def _query_chunk(bsz: int, nq: int, nt: int, itemsize: int,
                 device=None) -> int:
    """Equal lane-aligned query chunks whose [B, chunk, Nt] block fits
    the budget (same rule as the JAX package's ``_knn_topk_batched``).
    On the CPU (``device``) 128 rows, which keeps the block in the
    caches; a row's arithmetic is the same at any chunk."""
    if device is not None and device.type == "cpu":
        return 128
    chunk = max(128, _TOPK_BATCH_BUDGET // max(bsz * nt * itemsize, 1))
    steps = max(1, -(-nq // chunk))
    return -(-(-(-nq // steps)) // 128) * 128


def knn_topk(queries: torch.Tensor, targets: torch.Tensor, k: int,
             n_targets: torch.Tensor, fixed_order: bool = False):
    """k smallest-distance neighbours, ascending.

    queries [B,Nq,D], targets [B,Nt,D], n_targets [B] ->
    (idx [B,Nq,k] int64, d2 [B,Nq,k]).  Exact (``torch.topk`` on the
    masked distance block); chunked over QUERIES only, so results do not
    depend on the chunk size.  ``fixed_order``: the distances of
    ``_pairwise_d2(fixed_order=True)``, whose bits do not depend on the
    batch.
    """
    bsz, nq, _ = queries.shape
    nt = targets.shape[1]
    if k > nt:
        raise ValueError(f"k={k} exceeds the padded target count {nt}")
    chunk = _query_chunk(bsz, nq, nt, queries.element_size(),
                         queries.device)
    idx_out, d2_out = [], []
    for s in range(0, nq, chunk):
        d2 = _mask_cols(_pairwise_d2(queries[:, s:s + chunk], targets,
                                     fixed_order), n_targets)
        val, idx = torch.topk(d2, k, dim=-1, largest=False, sorted=True)
        idx_out.append(idx)
        d2_out.append(val)
    return torch.cat(idx_out, 1), torch.cat(d2_out, 1)


def knn_self(points: torch.Tensor, k: int, n_valid: torch.Tensor,
             fixed_order: bool = False):
    """kNN of each cloud against itself (self included at rank 0)."""
    return knn_topk(points, points, k, n_valid, fixed_order)


def neighbor_sums(table: torch.Tensor, idx: torch.Tensor,
                  keep: torch.Tensor, weight=None) -> torch.Tensor:
    """[B,Nq,F]: for each query the sum of the rows of ``table`` [B,N,F]
    at its kept neighbours (idx [B,Nq,k] indices, keep [B,Nq,k] bool),
    each times its ``weight`` [B,Nq,k] if given, added from +0 in
    ascending row index: elementwise adds in an order that the pair's
    own rows fix, where a masked ``[B,Nq,N] x [B,N,F]`` product leaves
    the order to the library (on the card, cuBLAS splits the sum by the
    shape of the batch)."""
    big = table.shape[1]
    key = torch.where(keep, idx.to(torch.int64), torch.full_like(
        idx, big, dtype=torch.int64))
    key, order = torch.sort(key, dim=-1)
    on = key < big
    key = torch.where(on, key, torch.zeros_like(key))
    if weight is not None:
        weight = torch.gather(weight, -1, order)
    bsz, nq, k = key.shape
    acc = table.new_zeros((bsz, nq, table.shape[-1]))
    for r in range(k):
        row = torch.gather(table, 1, key[..., r, None].expand(
            -1, -1, table.shape[-1]))
        if weight is not None:
            row = row * weight[..., r, None]
        acc = acc + torch.where(on[..., r, None], row,
                                torch.zeros_like(row))
    return acc


def _pad_width(x: torch.Tensor) -> torch.Tensor:
    """Zero-pad the last axis up to the next kernel width (zero columns
    change no distance)."""
    d = x.shape[-1]
    if d in cuda_nn.WIDTHS:
        return x
    wide = next((w for w in cuda_nn.WIDTHS if w > d), None)
    if wide is None:
        raise ValueError(f"point width {d} exceeds the kernel's largest "
                         f"width {cuda_nn.WIDTHS[-1]}")
    return torch.nn.functional.pad(x, (0, wide - d))


def _kernel_operand(x: torch.Tensor) -> torch.Tensor:
    """A contiguous operand of the width the kernel takes; CPU tensors
    (the plain versions) pass as they are."""
    return _pad_width(x).contiguous() if x.is_cuda else x


def _n_targets(targets: torch.Tensor, n_targets, bsz: int | None):
    """Valid-target counts as the wrappers take them: [B] int32 for a
    batch; for one cloud an int or an integer tensor, passed on as it is
    (``cuda_nn.nn_argmin_unbatched`` keeps a device count where it lies
    and an int in a cached device tensor)."""
    nt = targets.shape[-2]
    if n_targets is None:
        n_targets = nt
    if bsz is None:
        return n_targets
    n = torch.as_tensor(n_targets, device=targets.device).to(torch.int32)
    return n.expand(bsz).contiguous() if n.dim() == 0 else n.contiguous()


def nn_argmin(queries: torch.Tensor, targets: torch.Tensor,
              n_targets=None):
    """Exact 1-NN, ties to the lowest target index; targets at or past
    ``n_targets`` never match.

    Batched: queries [B,Nq,D], targets [B,Nt,D], n_targets [B] (or one
    count, or None for all) -> (idx [B,Nq] int32, d2 [B,Nq]) through K6.
    One cloud: queries [Nq,D], targets [Nt,D] -> (idx [Nq] int32,
    d2 [Nq]) through K9.  On CPU tensors the plain versions run."""
    if queries.dim() == 2:
        return cuda_nn.nn_argmin_unbatched(
            _kernel_operand(queries), _kernel_operand(targets),
            _n_targets(targets, n_targets, None))
    return cuda_nn.nn_argmin_batched(
        _kernel_operand(queries), _kernel_operand(targets),
        _n_targets(targets, n_targets, queries.shape[0]))


def nn_match(queries: torch.Tensor, targets: torch.Tensor,
             payload: torch.Tensor, n_targets=None):
    """1-NN + matched payload row through K7: (idx [B,Nq] int32,
    d2 [B,Nq], matched [B,Nq,P]) with matched[b,i] == payload[b, idx[b,i]]
    bit for bit.  Unbatched inputs ([Nq,D], [Nt,D], [Nt,P]) run as a
    batch of one and return unbatched results."""
    if queries.dim() == 2:
        idx, d2, matched = nn_match(queries[None], targets[None],
                                    payload[None], n_targets)
        return idx[0], d2[0], matched[0]
    pay = payload.contiguous() if payload.is_cuda else payload
    return cuda_nn.nn_match_batched(
        _kernel_operand(queries), _kernel_operand(targets), pay,
        _n_targets(targets, n_targets, queries.shape[0]))


def nn_match_packed(queries: torch.Tensor, targets, phase: torch.Tensor):
    """1-NN + matched payload row against the dual-phase targets of
    ``cuda_knn.pack_match_targets`` through K8; ``phase`` [B] picks each
    pair's block (0 or 1).  Returns (idx, d2, matched [B,Nq,P])."""
    if queries.is_cuda:
        queries = queries.contiguous()
        phase = phase.to(torch.int32).contiguous()
    return cuda_nn.nn_match_packed(queries, targets, phase)


def nn_distances(queries: torch.Tensor, targets: torch.Tensor,
                 tgt_valid=None) -> torch.Tensor:
    """min_j |q_i - t_j|^2 per query (Open3D's ComputePointCloudDistance
    returns the square root of this); ``tgt_valid``: the targets' valid
    mask, whose count is the valid prefix."""
    n_targets = None
    if tgt_valid is not None:
        n_targets = torch.as_tensor(tgt_valid, device=targets.device).to(
            torch.int32).sum(-1)
    _, d2 = nn_argmin(queries, targets, n_targets)
    return d2
