"""The setup's centring and scaling as one kernel (G4).

No TPU kernel: on the TPU, XLA fuses the JAX package's
``_masked_centroid``, ``_largest_radius`` and the scaling
(``se3_icp_tpu/models/registration.py:85-93, 209-220``) into its setup
program.  The port ran them as torch reductions (a ``sum`` over N of
[B,N,3], ``linalg.norm``, ``amax``), and on the card torch splits a
reduction over threads and blocks by the number of its outputs: a pair's
centroid, and with it every later bit of its registration, could follow
the size of its batch.

``center_scale_plain`` fixes one order that depends on the valid count
alone, written from elementwise torch ops: the rows as slabs of
``LANES`` ([B, N/256, 256, 3], rows past the count zeroed) added in
index order from +0, then a halving tree over the lanes (lane i + h into
lane i, h = 128 .. 1); the centroid that sum over max(n, 1); the radius
the largest sqrt((dx dx + dy dy) + dz dz) of the valid rows (-1 without
one); the scale 1 / max(max(r_s, r_t), 1e-30) times
``scale_preprocessing``; the clouds centred, scaled, their padded rows
0.  Its bits depend neither on the batch, nor on the padded width (a
zero added to a sum that starts at +0 changes nothing), nor on the
device; it runs in float32 and float64.  ``center_scale`` launches
``csrc/prep.cu`` for tensors on the card (a pair a cluster of 2C
blocks, C = ``cluster_size`` a cloud, every float32 step an explicit
``__f*_rn``): the plain version's bits at every C.  A wrapper given CUDA
tensors launches the kernel or raises; it runs the plain version only
for tensors on the CPU.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from se3_icp_tpu_torch.ops import _build, cuda_moments
from se3_icp_tpu_torch.ops.cuda_knn import _check

LANES = 256


def _sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root in ``x``'s dtype."""
    if x.dtype == torch.float32:
        return cuda_moments._sqrt_rn(x)
    return torch.sqrt(x)


def _valid(pts: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    return torch.arange(pts.shape[1], device=pts.device)[None] < n[:, None]


def lane_sums(x: torch.Tensor, n: torch.Tensor, lanes: int = LANES,
              warp: int | None = None) -> torch.Tensor:
    """[B,C]: each pair's sum of the rows of x [B,N,C] that ``n`` keeps
    (a count [B]: the rows below it; or a mask [B,N]), in a fixed order
    that depends on the pair's own rows alone: lane t adds the rows t,
    t + lanes, t + 2 lanes, ... in index order from +0 (x [B,N,S,C]: a
    row's S sub-rows one after another), then a halving tree, lane i + h
    into lane i: over all the lanes (G4's order, ``warp`` None), or
    within each warp of ``warp`` lanes, whose partials are then added in
    warp order from +0 (K5's order, ``csrc/loop_epilogue.cu``).  Rows
    not kept are never added (the sum starts at +0 and adds +0 for
    them), so the bits depend neither on the batch nor on the padded
    width, and a column's bits not on the other columns."""
    bsz, width = x.shape[:2]
    keep = n if n.dim() == 2 else _valid(x, n)
    keep = keep.view(keep.shape + (1,) * (x.dim() - 2))
    x = torch.where(keep, x, torch.zeros_like(x))
    pad = [0, 0] * (x.dim() - 2) + [0, -width % lanes]
    x = F.pad(x, pad).view(bsz, -1, lanes, *x.shape[2:])
    sub = x.shape[3] if x.dim() == 5 else 0
    acc = x.new_zeros((bsz, lanes, x.shape[-1]))
    for k in range(x.shape[1]):
        for s in range(sub or 1):
            acc = acc + (x[:, k, :, s] if sub else x[:, k])
    if warp is not None:
        acc = acc.view(bsz, lanes // warp, warp, -1)
    while acc.shape[-2] > 1:
        h = acc.shape[-2] // 2
        acc = acc[..., :h, :] + acc[..., h:, :]
    if warp is None:
        return acc[:, 0]
    tot = torch.zeros_like(acc[:, 0, 0])
    for w in range(lanes // warp):
        tot = tot + acc[:, w, 0]
    return tot


def centroid(pts: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """[B,3] the mean of each pair's rows below n, in the fixed order."""
    return lane_sums(pts, n) / n.to(pts.dtype).clamp_min(1.0)[:, None]


def radius(pts: torch.Tensor, cen: torch.Tensor,
           n: torch.Tensor) -> torch.Tensor:
    """[B] the largest distance of a pair's rows below n from its
    centroid ``cen`` [B,3] (-1 without a valid row)."""
    d = pts - cen[:, None]
    dx, dy, dz = d.unbind(-1)
    dist = _sqrt_rn((dx * dx + dy * dy) + dz * dz)
    return torch.where(_valid(pts, n), dist,
                       torch.full_like(dist, -1.0)).amax(-1)


def center_scale_plain(src, n_src, tgt, n_tgt, scale_pre):
    """Plain PyTorch version of ``center_scale``."""
    cen_s, cen_t = centroid(src, n_src), centroid(tgt, n_tgt)
    r = torch.maximum(radius(src, cen_s, n_src), radius(tgt, cen_t, n_tgt))
    # a Python float over a tensor is its reciprocal times the float in
    # torch on the card; the vector's scale takes the same steps
    scaling = r.clamp_min(1e-30).reciprocal() * scale_pre
    src_c = (src - cen_s[:, None]) * scaling[:, None, None]
    tgt_c = (tgt - cen_t[:, None]) * scaling[:, None, None]
    src_c = torch.where(_valid(src, n_src)[..., None], src_c,
                        torch.zeros_like(src_c))
    tgt_c = torch.where(_valid(tgt, n_tgt)[..., None], tgt_c,
                        torch.zeros_like(tgt_c))
    return src_c, tgt_c, cen_s, cen_t, scaling


def center_scale(src, n_src, tgt, n_tgt, scale_pre, cluster=None):
    """G4: centre each cloud at its own centroid and scale both by
    s = ``scale_pre`` / max radius, padded rows to 0.

    src [B,Ns,3] / tgt [B,Nt,3] padded clouds, n_src / n_tgt [B] integer
    valid counts, ``scale_pre`` a 0-dim tensor (``Hyper.
    scale_preprocessing``).  ``cluster``: the blocks a cloud runs on (1,
    2, 4 or 8; default ``cluster_size``); every C gives the same bits.
    Returns (src_c, tgt_c, cen_s [B,3], cen_t [B,3], scaling [B]); every
    pair's bits depend on its own clouds only."""
    if not src.is_cuda:
        return center_scale_plain(src, n_src, tgt, n_tgt, scale_pre)
    bsz, ns, _ = src.shape
    nt = tgt.shape[1]
    dev, f32 = src.device, torch.float32
    _check(src, "src", (bsz, ns, 3), f32, dev)
    _check(tgt, "tgt", (bsz, nt, 3), f32, dev)
    _check(scale_pre, "scale_pre", (), f32, dev)
    n_s = n_src.to(device=dev, dtype=torch.int32).contiguous()
    n_t = n_tgt.to(device=dev, dtype=torch.int32).contiguous()
    _check(n_s, "n_src", (bsz,), torch.int32, dev)
    _check(n_t, "n_tgt", (bsz,), torch.int32, dev)
    src_c, tgt_c = torch.empty_like(src), torch.empty_like(tgt)
    cen = torch.empty((2, bsz, 3), dtype=f32, device=dev)
    scaling = torch.empty(bsz, dtype=f32, device=dev)
    if cluster is None:
        cluster = cluster_size(bsz, dev)
    elif cluster not in CLUSTERS:
        raise ValueError(f"cluster {cluster}: the kernel takes 1, 2, 4 or "
                         "8 blocks a cloud")
    code = _build.launch(
        _build.load().se3icp_prep, dev, src.data_ptr(), n_s.data_ptr(),
        tgt.data_ptr(), n_t.data_ptr(), scale_pre.data_ptr(),
        src_c.data_ptr(), tgt_c.data_ptr(), cen[0].data_ptr(),
        cen[1].data_ptr(), scaling.data_ptr(), bsz, ns, nt, cluster)
    _build.check(code, "center_scale")
    _build.count_launch("center_scale", dev)
    return src_c, tgt_c, cen[0], cen[1], scaling


CLUSTERS = (1, 2, 4, 8)


def cluster_size(bsz: int, device) -> int:
    """Blocks a cloud runs on: the smallest C in ``CLUSTERS`` with the
    ``2 * bsz * C`` blocks of a call at least the SM count of ``device``
    (8 if none): a 64-pair call on an H100 (132 SMs) takes 2, a pair
    alone 8 (a cluster of 16 blocks)."""
    return _build.cluster_for(2 * bsz, torch.device(device).index or 0)
