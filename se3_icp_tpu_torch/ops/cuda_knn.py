"""The per-iteration correspondence search: fused 1-NN + matched
payload with the query embedding built inside the kernel.

Counterpart of the JAX package's ``ops/pallas_knn.py``
(``_kernel_match_affine`` / ``nn_match_affine`` / ``pack_match_targets``).
The static per-point feature block ``feat = [F^T(9) | s(3) | 1 | 0(3)]``
is packed once in setup; each iteration only builds a per-pair
``[16,16]`` matrix ``W(R, t, alpha, beta, phase)``.  The kernel computes
``q = feat @ W``, searches the phase-selected target embedding (12-D
chordal metric before the switch, 3-D euclidean after it, where the
rotation block is zero) for the minimum of the shifted squared distance
``-2 q.t + |t|^2``, and returns the matched target's payload row --
the loop consumes the match's data, never its index.  Exact distance
ties average their payload rows; targets ``j >= n_tgt[b]`` never match;
pairs whose done flag is set are skipped and their outputs left
unspecified (only done-masked consumers may read them).

What the TPU kernel needed and this one does not: the three-limb bf16
split of every operand, ``|t|^2`` limb columns against constant-1 query
columns, the min-mask matmul that stands in for a gather, poisoned
coordinates in place of a bound check.  Float32 FMAs on the CUDA cores
are exact-class already, so ``pack_match_targets`` keeps just the two
float32 phase embeddings, their ``|t|^2``, the payload and the counts.

``nn_match_affine`` launches the CUDA kernel (``csrc/match_affine.cu``)
for tensors on the card and raises if it cannot; it takes the plain
PyTorch version below only for CPU tensors.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from se3_icp_tpu_torch.ops import _build, knn

EMB_DIM = 12
FEAT_DIM = 16


@dataclass
class MatchTargets:
    """Loop-invariant targets of the match kernel."""
    emb: torch.Tensor       # [B,2,Nt,12] phase A / phase B embeddings
    tn: torch.Tensor        # [B,2,Nt]    |t|^2 of each embedding row
    payload: torch.Tensor   # [B,Nt,P]    what the loop needs of a match
    n: torch.Tensor         # [B] int32   valid target count


def pack_match_targets(targets_a: torch.Tensor, targets_b: torch.Tensor,
                       payload: torch.Tensor,
                       n_targets: torch.Tensor) -> MatchTargets:
    """Pack BOTH phase variants of the target embedding [B,Nt,12] and
    the (phase-independent) payload [B,Nt,P] once, in setup."""
    emb = torch.stack([targets_a, targets_b], dim=1).contiguous()
    return MatchTargets(emb=emb, tn=torch.sum(emb * emb, dim=-1),
                        payload=payload.contiguous(),
                        n=n_targets.to(torch.int32).contiguous())


def nn_match_affine_plain(feat, w, targets: MatchTargets, phase):
    """Plain PyTorch version of ``nn_match_affine`` (any float dtype,
    any device).  Done pairs are skipped, as by the kernel: their
    outputs are zeros."""
    bsz, nq, _ = feat.shape
    nt, p = targets.payload.shape[1:]
    d2_out = feat.new_zeros((bsz, nq))
    pay_out = feat.new_zeros((bsz, nq, p))
    live = torch.nonzero(phase[:, 1] == 0)[:, 0]
    if len(live):
        sel = phase[live, 0].to(torch.int64)
        emb = targets.emb[live, sel]                         # [L,Nt,12]
        tn = targets.tn[live, sel]                           # [L,Nt]
        q2 = -2.0 * (feat[live] @ w[live])[..., :EMB_DIM]    # [L,Nq,12]
        pay = targets.payload[live]                          # [L,Nt,P]
        n64 = targets.n[live].to(torch.int64)
        chunk = knn._query_chunk(len(live), nq, nt, feat.element_size(),
                                 feat.device)
        for s in range(0, nq, chunk):
            d2 = knn._mask_cols(q2[:, s:s + chunk] @ emb.mT
                                + tn[:, None, :], n64)
            best = d2.amin(-1)
            tie = (d2 <= best[..., None]).to(feat.dtype)     # multi-hot
            d2_out[live, s:s + chunk] = best
            pay_out[live, s:s + chunk] = (tie @ pay) / tie.sum(
                -1, keepdim=True)
    return d2_out, pay_out.mT.contiguous()


def _check(t: torch.Tensor, name: str, shape, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, the kernel takes "
                        f"{dtype} only")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def nn_match_affine(feat, w, targets: MatchTargets, phase):
    """Batched fused match.

    feat [B,Nq,16] static per-point features, w [B,16,16] per-iteration
    affine (q = feat @ w, first 12 columns), ``targets`` from
    ``pack_match_targets``, phase [B,2] int32: column 0 the phase flag
    (0 = SE(3), 1 = R3), column 1 the DONE flag (1 = skip this pair; its
    outputs are then unspecified).  In the R3 phase the rotation block
    (columns 0-8) of the phase-B embedding must be zero, as
    ``models/registration.py`` packs it: the kernel reads only columns
    9-11 there.  Returns (d2_shifted [B,Nq], matchedT [B,P,Nq]): the
    payload rows TRANSPOSED, and d2 without the +|q|^2 shift
    (argmin-equivalent).
    """
    if not feat.is_cuda:
        return nn_match_affine_plain(feat, w, targets, phase)
    bsz, nq, _ = feat.shape
    nt, p = targets.payload.shape[1:]
    dev, f32 = feat.device, torch.float32
    _check(feat, "feat", (bsz, nq, FEAT_DIM), f32, dev)
    _check(w, "w", (bsz, FEAT_DIM, FEAT_DIM), f32, dev)
    _check(targets.emb, "targets.emb", (bsz, 2, nt, EMB_DIM), f32, dev)
    _check(targets.tn, "targets.tn", (bsz, 2, nt), f32, dev)
    _check(targets.payload, "targets.payload", (bsz, nt, p), f32, dev)
    _check(targets.n, "targets.n", (bsz,), torch.int32, dev)
    _check(phase, "phase", (bsz, 2), torch.int32, dev)
    for name, t in (("feat", feat), ("targets.emb", targets.emb)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: the kernel reads it as float4s and "
                             "needs a 16-byte aligned start")
    lib = _build.load()
    d2 = torch.empty((bsz, nq), dtype=f32, device=dev)
    matched_t = torch.empty((bsz, p, nq), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        code = lib.se3icp_match_affine(
            feat.data_ptr(), w.data_ptr(), targets.emb.data_ptr(),
            targets.tn.data_ptr(), targets.payload.data_ptr(),
            targets.n.data_ptr(), phase.data_ptr(), d2.data_ptr(),
            matched_t.data_ptr(), bsz, nq, nt, p,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "nn_match_affine")
    _build.count_launch("nn_match_affine", dev)
    return d2, matched_t


