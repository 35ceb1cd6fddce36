"""Exact 1-NN search with the lowest index on ties: the kernels K6-K9.

Counterpart of four kernels of the JAX package's ``ops/pallas_knn.py``
that compute one function:

  * K6 ``nn_argmin_batched``  <- ``_kernel_batched`` /
    ``nn_argmin_pallas_batched``: q [B,Nq,D], t [B,Nt,D], n_targets [B]
    -> (idx [B,Nq] int32, d2 [B,Nq]);
  * K9 ``nn_argmin_unbatched`` <- ``_kernel`` / ``nn_argmin_pallas``: the
    same for one cloud, q [Nq,D], t [Nt,D];
  * K7 ``nn_match_batched``   <- ``_kernel_match`` /
    ``nn_match_pallas_batched``: K6 plus matched [B,Nq,P] =
    payload[b, idx[b, i]], bit for bit;
  * K8 ``nn_match_packed``    <- ``_kernel_match_packed`` /
    ``nn_match_packed``: K7 against the dual-phase 12-D targets that
    ``cuda_knn.pack_match_targets`` packs once, with a per-pair phase
    [B] choosing the block.  No tie averaging (that is K4's contract).

Targets at or past ``n_targets[b]`` never match; with none valid the
index is 0 and d2 is ~3.4e38.  d2 is |q|^2 + (|t|^2 - 2 q.t), the
shifted form every JAX kernel uses, in float32 FMAs (``csrc/
nn_argmin.cu``); the plain versions compute ``|q|^2 - 2 q.t + |t|^2``
with a full-float32 matrix product, so the two agree to a few ulps of
|q|^2 + |t|^2, and the index may differ where two targets are closer
than that.  The kernel takes the widths ``WIDTHS``; ``knn.nn_argmin``
pads other widths (zero columns change no distance).

K6, K7 and K8 launch the register-tiled search (``nn_tiled_kernel``;
K8's instance reads the pair's phase block and its given |t|^2), K9 the
search of one query a thread (``nn_kernel``, its targets split over S
blocks a query tile where the grid is small); both return the same bits
on the same inputs (one FMA chain a distance, the lowest index on ties),
and ``untiled_argmin`` / ``untiled_match_packed`` run ``nn_kernel`` on a
batch as the card checks' bit reference.  Each wrapper launches its CUDA
kernel for tensors on the card and raises if it cannot; it takes the
plain version only for CPU tensors.
"""

from __future__ import annotations

import functools

import torch

from se3_icp_tpu_torch.ops import _build, cuda_knn, knn

WIDTHS = (3, 12, 33, 64)    # query widths the kernel is instantiated for


# ---------------------------------------------------------------- plain

def _first_min(d2: torch.Tensor):
    """[B,C,Nt] -> (idx [B,C] int32 of the FIRST minimum, min [B,C])
    (argmin's tie order is not part of torch's contract on every
    backend)."""
    nt = d2.shape[-1]
    val = d2.amin(-1)
    col = torch.arange(nt, device=d2.device)
    idx = torch.where(d2 == val[..., None], col,
                      torch.full((), nt, device=d2.device)).amin(-1)
    return idx.to(torch.int32), val


def _search_plain(queries, targets, n_targets, tn=None):
    """Shared body of the plain versions: chunked over queries so the
    [B, chunk, Nt] distance block stays bounded.  ``tn`` (|t|^2 [B,Nt])
    is the packed targets' own when given."""
    bsz, nq, _ = queries.shape
    nt = targets.shape[1]
    n64 = n_targets.to(device=queries.device, dtype=torch.int64)
    if tn is None:
        tn = torch.sum(targets * targets, dim=-1)
    chunk = knn._query_chunk(bsz, nq, nt, queries.element_size())
    idx_out, d2_out = [], []
    for s in range(0, nq, chunk):
        q = queries[:, s:s + chunk]
        qn = torch.sum(q * q, dim=-1, keepdim=True)
        d2 = knn._mask_cols(qn - 2.0 * (q @ targets.mT) + tn[:, None, :],
                            n64)
        idx, val = _first_min(d2)
        idx_out.append(idx)
        d2_out.append(val)
    return torch.cat(idx_out, 1), torch.cat(d2_out, 1)


def _gather_rows(payload, idx):
    return torch.gather(payload, 1, idx.to(torch.int64)[..., None].expand(
        -1, -1, payload.shape[-1]))


def nn_argmin_batched_plain(queries, targets, n_targets):
    """Plain PyTorch version of ``nn_argmin_batched`` (any float dtype,
    any device)."""
    return _search_plain(queries, targets, n_targets)


def nn_argmin_unbatched_plain(queries, targets, n_targets):
    """Plain PyTorch version of ``nn_argmin_unbatched``."""
    n = torch.as_tensor(n_targets, device=queries.device).reshape(1)
    idx, d2 = _search_plain(queries[None], targets[None], n)
    return idx[0], d2[0]


def nn_match_batched_plain(queries, targets, payload, n_targets):
    """Plain PyTorch version of ``nn_match_batched``."""
    idx, d2 = _search_plain(queries, targets, n_targets)
    return idx, d2, _gather_rows(payload, idx)


def nn_match_packed_plain(queries, targets: cuda_knn.MatchTargets, phase):
    """Plain PyTorch version of ``nn_match_packed``."""
    ar = torch.arange(queries.shape[0], device=queries.device)
    sel = (phase != 0).to(torch.int64)                  # as the kernel
    idx, d2 = _search_plain(queries, targets.emb[ar, sel], targets.n,
                            tn=targets.tn[ar, sel])
    return idx, d2, _gather_rows(targets.payload, idx)


# ---------------------------------------------------------------- kernels

MAX_SPLIT = 8   # target slices a query tile (the portable cluster size)
_QUERY_TILE = 128   # queries a block of nn_kernel (csrc/nn_argmin.cu kThreads)


def split_size(bsz: int, nq: int, device) -> int:
    """Target slices a query tile of ``nn_kernel`` (K9): the
    smallest S in (1, 2, 4, 8) with
    S times the grid's ceil(Nq/128) * B blocks at least twice the SM
    count of ``device`` (8 if none); 1 for a grid that fills the card
    twice.  Two blocks an SM: one cloud of 4608 queries ran 0.022 ms
    at S = 8 and 0.034 ms at S = 4 (one block an SM) on an H100
    (``tools/kernel_tiling_sweep.py --only nn``)."""
    blocks = -(-nq // _QUERY_TILE) * bsz
    return _build.cluster_for(blocks, torch.device(device).index or 0,
                              waves=2, most=MAX_SPLIT)


def _split_arg(split, bsz, nq, dev) -> int:
    if split is None:
        return split_size(bsz, nq, dev)
    if not 1 <= split <= MAX_SPLIT:
        raise ValueError(f"split {split}: the kernel takes 1 to "
                         f"{MAX_SPLIT} target slices")
    return int(split)


def _check_search(queries, targets, n_targets):
    """The shapes every variant shares; returns (B, Nq, Nt, D, device)."""
    bsz, nq, d = queries.shape
    nt = targets.shape[-2]
    dev, f32 = queries.device, torch.float32
    if d not in WIDTHS:
        raise ValueError(f"query width {d}: the kernel takes {WIDTHS} "
                         "(knn.nn_argmin pads other widths)")
    if nt < 1:
        raise ValueError("no target rows")
    cuda_knn._check(queries, "queries", (bsz, nq, d), f32, dev)
    cuda_knn._check(n_targets, "n_targets", (bsz,), torch.int32, dev)
    return bsz, nq, nt, d, dev


def _outputs(bsz, nq, dev):
    """idx [B,Nq] int32 and d2 [B,Nq] float32: views of one allocation."""
    out = torch.empty((2, bsz, nq), dtype=torch.float32, device=dev)
    return out[0].view(torch.int32), out[1]


def untiled_argmin(queries, targets, n_targets, split=None):
    """The search of one query a thread (``nn_kernel``, K9's entry point)
    at any batch: queries [B,Nq,D], targets [B,Nt,D] float32 on the card,
    n_targets [B] int32 -> (idx [B,Nq] int32, d2 [B,Nq]).  ``split``:
    target slices a query tile (default ``split_size``; every S gives the
    same bits).  K9's wrapper launches it at B = 1; the card checks hold
    K6 and K7 bit for bit against it.  Counts no launch."""
    bsz, nq, nt, d, dev = _check_search(queries, targets, n_targets)
    cuda_knn._check(targets, "targets", (bsz, nt, d), torch.float32, dev)
    idx, d2 = _outputs(bsz, nq, dev)
    code = _build.launch(
        _build.load().se3icp_nn_argmin, dev, queries.data_ptr(),
        targets.data_ptr(), n_targets.data_ptr(), idx.data_ptr(),
        d2.data_ptr(), bsz, nq, nt, d, _split_arg(split, bsz, nq, dev))
    _build.check(code, "nn_argmin (untiled)")
    return idx, d2


def nn_argmin_batched(queries, targets, n_targets):
    """K6: batched exact 1-NN.  queries [B,Nq,D], targets [B,Nt,D]
    float32, n_targets [B] int32 -> (idx [B,Nq] int32, d2 [B,Nq])."""
    if not queries.is_cuda:
        return nn_argmin_batched_plain(queries, targets, n_targets)
    bsz, nq, nt, d, dev = _check_search(queries, targets, n_targets)
    cuda_knn._check(targets, "targets", (bsz, nt, d), torch.float32, dev)
    idx, d2 = _outputs(bsz, nq, dev)
    code = _build.launch(
        _build.load().se3icp_nn_argmin_batched, dev, queries.data_ptr(),
        targets.data_ptr(), n_targets.data_ptr(), idx.data_ptr(),
        d2.data_ptr(), bsz, nq, nt, d)
    _build.check(code, "nn_argmin_batched")
    _build.count_launch("nn_argmin_batched", dev)
    return idx, d2


@functools.lru_cache(maxsize=64)
def _count_on(device, n: int) -> torch.Tensor:
    """A [1] int32 count on the card, made once per (device, value)."""
    return torch.tensor([n], dtype=torch.int32, device=device)


def nn_argmin_unbatched(queries, targets, n_targets, split=None):
    """K9: exact 1-NN of one cloud.  queries [Nq,D], targets [Nt,D]
    float32, n_targets an int or a 0-d/[1] integer tensor (on the card
    it is used where it lies, without a copy; an int becomes a cached
    device tensor) -> (idx [Nq] int32, d2 [Nq]).  ``split``: target
    slices a query tile (default ``split_size``; every S gives the same
    bits)."""
    if not queries.is_cuda:
        return nn_argmin_unbatched_plain(queries, targets, n_targets)
    dev = queries.device
    if isinstance(n_targets, torch.Tensor):
        n = n_targets.reshape(1)
        if n.device != dev:
            n = n.to(dev)
        if n.dtype != torch.int32:
            n = n.to(torch.int32)
    else:
        n = _count_on(dev, int(n_targets))
    idx, d2 = untiled_argmin(queries[None], targets[None], n, split)
    _build.count_launch("nn_argmin_unbatched", dev)
    return idx[0], d2[0]


def nn_match_batched(queries, targets, payload, n_targets):
    """K7: K6 plus the matched payload rows.  payload [B,Nt,P] float32
    -> (idx, d2, matched [B,Nq,P])."""
    if not queries.is_cuda:
        return nn_match_batched_plain(queries, targets, payload, n_targets)
    bsz, nq, nt, d, dev = _check_search(queries, targets, n_targets)
    cuda_knn._check(targets, "targets", (bsz, nt, d), torch.float32, dev)
    p = payload.shape[-1]
    cuda_knn._check(payload, "payload", (bsz, nt, p), torch.float32, dev)
    if p < 1:
        raise ValueError("payload has no columns")
    idx, d2 = _outputs(bsz, nq, dev)
    matched = torch.empty((bsz, nq, p), dtype=torch.float32, device=dev)
    code = _build.launch(
        _build.load().se3icp_nn_match_batched, dev, queries.data_ptr(),
        targets.data_ptr(), payload.data_ptr(), n_targets.data_ptr(),
        idx.data_ptr(), d2.data_ptr(), matched.data_ptr(), bsz, nq, nt, d,
        p)
    _build.check(code, "nn_match_batched")
    _build.count_launch("nn_match_batched", dev)
    return idx, d2, matched


def _packed_call(entry, what, queries, targets, phase, *extra):
    """Checks K8's inputs and calls C entry point ``entry`` (the tiled
    search, or ``nn_kernel`` with the ``extra`` split) -> (idx, d2,
    matched)."""
    bsz, nq, _ = queries.shape
    nt, p = targets.payload.shape[1:]
    dev, f32 = queries.device, torch.float32
    cuda_knn._check(queries, "queries", (bsz, nq, cuda_knn.EMB_DIM), f32, dev)
    cuda_knn._check(targets.emb, "targets.emb", (bsz, 2, nt, cuda_knn.EMB_DIM), f32, dev)
    cuda_knn._check(targets.tn, "targets.tn", (bsz, 2, nt), f32, dev)
    cuda_knn._check(targets.payload, "targets.payload", (bsz, nt, p), f32, dev)
    cuda_knn._check(targets.n, "targets.n", (bsz,), torch.int32, dev)
    cuda_knn._check(phase, "phase", (bsz,), torch.int32, dev)
    if nt < 1 or p < 1:
        raise ValueError("no target rows or no payload columns")
    idx, d2 = _outputs(bsz, nq, dev)
    matched = torch.empty((bsz, nq, p), dtype=f32, device=dev)
    code = _build.launch(
        getattr(_build.load(), entry), dev, queries.data_ptr(),
        targets.emb.data_ptr(), targets.tn.data_ptr(),
        targets.payload.data_ptr(), targets.n.data_ptr(), phase.data_ptr(),
        idx.data_ptr(), d2.data_ptr(), matched.data_ptr(), bsz, nq, nt, p,
        *extra)
    _build.check(code, what)
    return idx, d2, matched


def untiled_match_packed(queries, targets: cuda_knn.MatchTargets, phase,
                         split=None):
    """K8's function by the search of one query a thread (``nn_kernel``
    on the packed targets), on the card: the bit reference the card
    checks hold the tiled K8 against.  ``split``: target slices a query
    tile (default ``split_size``; every S gives the same bits).  Counts
    no launch."""
    bsz, nq, _ = queries.shape
    return _packed_call("se3icp_nn_match_packed", "nn_match_packed (untiled)",
                        queries, targets, phase,
                        _split_arg(split, bsz, nq, queries.device))


def nn_match_packed(queries, targets: cuda_knn.MatchTargets, phase):
    """K8: K7 against pre-packed dual-phase targets.  queries [B,Nq,12]
    float32, ``targets`` from ``cuda_knn.pack_match_targets`` (each
    pair's |t|^2 is read from ``targets.tn`` as given), phase [B] int32
    (0 = first block, any other value = second) -> (idx, d2, matched
    [B,Nq,P])."""
    if not queries.is_cuda:
        return nn_match_packed_plain(queries, targets, phase)
    out = _packed_call("se3icp_nn_match_packed_batched", "nn_match_packed",
                       queries, targets, phase)
    _build.count_launch("nn_match_packed", queries.device)
    return out


