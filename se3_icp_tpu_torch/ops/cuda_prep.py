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
``csrc/prep.cu`` for tensors on the card (one cluster of two blocks a
pair, every float32 step an explicit ``__f*_rn``): the plain version's
bits.  A wrapper given CUDA tensors launches the kernel or raises; it
runs the plain version only for tensors on the CPU.
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


def lane_sums(pts: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """[B,3]: each pair's sum of its rows below n (pts [B,N,3]) in the
    fixed order: lane t adds the rows t, t + 256, ... in index order
    from +0, then the halving tree over the lanes."""
    bsz, width, _ = pts.shape
    x = torch.where(_valid(pts, n)[..., None], pts, torch.zeros_like(pts))
    x = F.pad(x, (0, 0, 0, -width % LANES)).view(bsz, -1, LANES, 3)
    acc = torch.zeros((bsz, LANES, 3), dtype=pts.dtype, device=pts.device)
    for k in range(x.shape[1]):
        acc = acc + x[:, k]
    while acc.shape[1] > 1:
        h = acc.shape[1] // 2
        acc = acc[:, :h] + acc[:, h:]
    return acc[:, 0]


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


def center_scale(src, n_src, tgt, n_tgt, scale_pre):
    """G4: centre each cloud at its own centroid and scale both by
    s = ``scale_pre`` / max radius, padded rows to 0.

    src [B,Ns,3] / tgt [B,Nt,3] padded clouds, n_src / n_tgt [B] integer
    valid counts, ``scale_pre`` a 0-dim tensor (``Hyper.
    scale_preprocessing``).  Returns (src_c, tgt_c, cen_s [B,3], cen_t
    [B,3], scaling [B]); every pair's bits depend on its own clouds
    only."""
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
    code = _build.launch(
        _build.load().se3icp_prep, dev, src.data_ptr(), n_s.data_ptr(),
        tgt.data_ptr(), n_t.data_ptr(), scale_pre.data_ptr(),
        src_c.data_ptr(), tgt_c.data_ptr(), cen[0].data_ptr(),
        cen[1].data_ptr(), scaling.data_ptr(), bsz, ns, nt)
    _build.check(code, "center_scale")
    _build.count_launch("center_scale", dev)
    return src_c, tgt_c, cen[0], cen[1], scaling
