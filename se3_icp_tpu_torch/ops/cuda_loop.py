"""Fused per-iteration loop EPILOGUE: everything the registration loop
does after the correspondence match, in one pass over the matched
payload.

Counterpart of the JAX package's ``ops/pallas_loop.py``
(``_kernel_epilogue`` / ``loop_epilogue_batched``): moving-source
rebuild from the loop-invariant centred source and the per-iteration
(R, t), the trim / MSE metric distance of the pair's phase, the
sort-free exact-count trim (the same count bisection as ``ops/trim.py``
plus an index bisection that fills the boundary band toward the lower
index), the convergence MSE, and the estimator's reduction -- JtJ / Jtr
for pt2pl and gicp (whitening ``(R C_s R^T + C_t)^(-1/2)`` per point,
optional confidence), or the weighted Umeyama moments for pt2pt.  The
caller finishes with a 6x6 solve or a 3x3 SVD (``ops/solve.py``).

``loop_epilogue_batched`` launches the CUDA kernel
(``csrc/loop_epilogue.cu``) for tensors on the card and raises if it
cannot; it takes the plain PyTorch version below only for CPU tensors.
"""

from __future__ import annotations

import math

import torch

from se3_icp_tpu_torch.ops import _build, cuda_prep, eigh3, trim
from se3_icp_tpu_torch.ops.cuda_knn import _check

# pf row layout (per-pair iteration scalars, one [24] vector)
PF_T = 0          # 0:3   translation
PF_BETA = 3       # beta_transl (phase-A trim metric)
PF_SWITCHED = 4   # 0.0 = SE(3) phase, 1.0 = R3 phase
PF_NSRC = 5       # valid source count (exact integer-valued float)
PF_COUNT = 6      # trim keep count = floor(overlap * n_src)
PF_R = 8          # 8:17  R row-major
PF_WIDTH = 24

# the kernel's summation order: logical threads a pair, and a warp
K5_LANES = 512
K5_WARP = 32

_VARIANT_CODE = {"pt2pt": 0, "pt2pl": 1, "gicp": 2}


def index_steps(n: int) -> int:
    """Halvings of the index bisection that breaks the trim's ties."""
    return int(math.ceil(math.log2(max(n, 2)))) + 2


def _kept_mask(dist, valid, count, n):
    """The kernel's trim: the value bisection of ``ops/trim.py`` (same
    brackets) + an index bisection for the minimal index whose band
    prefix reaches the missing count -- the same kept set as the
    cumulative walk of ``trim._trim_mask_bisect``, in a form a block of
    threads can run.  dist/valid [B,N], count [B,1] float."""
    dt = dist.dtype
    d, lo, hi = trim._value_brackets(dist, valid, count)
    below = d <= lo
    band = (d > lo) & (d <= hi)
    target = count - below.sum(-1, keepdim=True).to(dt)
    colf = torch.arange(n, device=dist.device).to(dt)[None, :]
    li = torch.full_like(hi, -1.0)
    hii = torch.full_like(hi, float(n - 1))
    for _ in range(index_steps(n)):
        mid = torch.floor(0.5 * (li + hii))
        pred = (band & (colf <= mid)).sum(-1, keepdim=True).to(dt) >= target
        li, hii = torch.where(pred, li, mid), torch.where(pred, mid, hii)
    return below | (band & (colf <= hii))


def loop_epilogue_plain(srcT, matchedT, pf, cov6=None, conf=None, *,
                        variant, is_se3, use_cf, do_trim,
                        off_tr=0, off_nrm=0, off_cov=0, off_conf=0):
    """Plain PyTorch version of ``loop_epilogue_batched`` (any float
    dtype, any device); same arguments and results."""
    dt = srcT.dtype
    bsz, _, n = srcT.shape
    x, y, z = srcT[:, 0], srcT[:, 1], srcT[:, 2]

    def col(k):
        return pf[:, k:k + 1]

    t0, t1, t2 = col(PF_T), col(PF_T + 1), col(PF_T + 2)
    beta, sw = col(PF_BETA), col(PF_SWITCHED)
    n_src, count = col(PF_NSRC), col(PF_COUNT)
    R = [[col(PF_R + 3 * i + j) for j in range(3)] for i in range(3)]

    # moving source rows: s = R x + t
    rx = R[0][0] * x + R[0][1] * y + R[0][2] * z
    ry = R[1][0] * x + R[1][1] * y + R[1][2] * z
    rz = R[2][0] * x + R[2][1] * y + R[2][2] * z
    s0, s1, s2 = rx + t0, ry + t1, rz + t2
    g0, g1, g2 = matchedT[:, 0], matchedT[:, 1], matchedT[:, 2]
    dB0, dB1, dB2 = s0 - g0, s1 - g1, s2 - g2
    d_b = torch.sqrt(dB0 * dB0 + dB1 * dB1 + dB2 * dB2)

    # trim/MSE metric: R3 distance in both phases; phase A measures the
    # beta-weighted frame translations against the matched 12-D row's
    # translation block
    if is_se3:
        dA0 = beta * rx + t0 - matchedT[:, off_tr]
        dA1 = beta * ry + t1 - matchedT[:, off_tr + 1]
        dA2 = beta * rz + t2 - matchedT[:, off_tr + 2]
        d_a = torch.sqrt(dA0 * dA0 + dA1 * dA1 + dA2 * dA2)
        dist = torch.where(sw > 0.5, d_b, d_a)
    else:
        dist = d_b

    colf = torch.arange(n, device=srcT.device).to(dt)[None, :]
    valid = colf < n_src
    kept = _kept_mask(dist, valid, count, n) if do_trim else valid

    def fixed_sum(cols):
        """[B,C]: the kept rows' sums of the columns ([B,N] each, or
        [B,3,N] for a row's three whitened sub-rows) in the kernel's
        order: 512 lanes, a tree within each warp of 32, the 16 warp
        partials in warp order (``cuda_prep.lane_sums``)."""
        x = torch.stack(cols, -1)
        if x.dim() == 4:
            x = x.transpose(1, 2)                             # [B,N,3,C]
        return cuda_prep.lane_sums(x, kept, K5_LANES, K5_WARP)

    wsum = kept.sum(-1, keepdim=True).to(dt)
    # mse: mean kept distance; with_cf recomputes euclidean
    # moving-vs-target
    mse = fixed_sum([d_b if use_cf else dist]) / wsum.clamp_min(1.0)

    A = torch.zeros((bsz, 6, 6), dtype=dt, device=srcT.device)
    b = torch.zeros((bsz, 8), dtype=dt, device=srcT.device)
    if variant == "pt2pt":
        wsafe = wsum.clamp_min(1e-30)
        mu = fixed_sum([s0, s1, s2, g0, g1, g2]) / wsafe
        ds = (s0 - mu[:, 0:1], s1 - mu[:, 1:2], s2 - mu[:, 2:3])
        dt_ = (g0 - mu[:, 3:4], g1 - mu[:, 4:5], g2 - mu[:, 5:6])
        H = fixed_sum([dt_[r] * ds[c] for r in range(3) for c in range(3)])
        A[:, :3, :3] = H.view(bsz, 3, 3)
        b[:, :6] = mu
    else:
        if variant == "pt2pl":
            n0, n1, n2 = (matchedT[:, off_nrm + i] for i in range(3))
            r = dB0 * n0 + dB1 * n1 + dB2 * n2                # [B,N]
            jt = [s1 * n2 - s2 * n1, s2 * n0 - s0 * n2,
                  s0 * n1 - s1 * n0, n0, n1, n2]
        elif variant == "gicp":
            # rotated source covariance R C0 R^T on loop-invariant rows
            c6 = cov6.unbind(1)
            cidx = ((0, 1, 2), (1, 3, 4), (2, 4, 5))
            m6 = []
            for m, (i, j) in enumerate(eigh3._SYM_PAIRS):
                acc = matchedT[:, off_cov + m]                # matched C_t
                for k in range(3):
                    for l in range(3):
                        acc = acc + (R[i][k] * R[j][l]) * c6[cidx[k][l]]
                m6.append(acc)
            W6 = eigh3.inv_sqrt_sym3_c(*m6)
            if use_cf:
                cw = 0.5 * (conf + matchedT[:, off_conf])
                W6 = tuple(xw * cw for xw in W6)
            Wm = ((W6[0], W6[1], W6[2]), (W6[1], W6[3], W6[4]),
                  (W6[2], W6[4], W6[5]))
            zero = torch.zeros_like(s0)
            cols = ((zero, -s2, s1), (s2, zero, -s0), (-s1, s0, zero))

            def wdot(row, v):
                return row[0] * v[0] + row[1] * v[1] + row[2] * v[2]

            # the three whitened rows of a point: [B,3,N] each entry
            jt = [torch.stack([wdot(Wm[i], cols[a]) for i in range(3)], 1)
                  for a in range(3)]
            jt += [torch.stack([Wm[i][a] for i in range(3)], 1)
                   for a in range(3)]
            r = torch.stack([wdot(Wm[i], (dB0, dB1, dB2))
                             for i in range(3)], 1)
        else:
            raise ValueError(f"Invalid ICP variant name: {variant!r}")
        # the upper triangle of j j^T row by row, then j r
        sums = fixed_sum([jt[a] * jt[c] for a in range(6)
                          for c in range(a, 6)] + [ja * r for ja in jt])
        iu = torch.triu_indices(6, 6)
        A[:, iu[0], iu[1]] = sums[:, :21]
        A[:, iu[1], iu[0]] = sums[:, :21]
        b[:, :6] = sums[:, 21:]
    st = torch.zeros((bsz, 8), dtype=dt, device=srcT.device)
    st[:, 0:1] = mse
    st[:, 1:2] = wsum
    return A, b, st


def loop_epilogue_batched(srcT, matchedT, pf, cov6=None, conf=None, *,
                          variant, is_se3, use_cf, do_trim,
                          off_tr=0, off_nrm=0, off_cov=0, off_conf=0,
                          cluster=None):
    """Batched fused epilogue.

    srcT [B,3,N] loop-invariant centred source (feature-major);
    matchedT [B,P,N] matched payload rows from ``nn_match_affine``;
    pf [B,24] per-iteration scalars (PF_* layout);
    cov6 [B,6,N] loop-invariant source covariance components (gicp);
    conf [B,N] source confidences (with_cf); ``off_*`` the payload rows
    of the beta-weighted translation, normal, covariance, confidence.
    ``cluster``: the blocks a pair runs on (1, 2, 4 or 8; default:
    ``cluster_size``); every C gives the same bits.

    Returns (A [B,6,6], b [B,8], st [B,8]):
      pt2pl/gicp: A = JtJ, b[:6] = Jtr;
      pt2pt:      A[:3,:3] = H (weighted centred cross-covariance),
                  b[0:3] = mu_src, b[3:6] = mu_tgt;
      st = [mse, wsum, 0...].
    """
    if variant not in _VARIANT_CODE:
        raise ValueError(f"Invalid ICP variant name: {variant!r}")
    if not srcT.is_cuda:
        return loop_epilogue_plain(
            srcT, matchedT, pf, cov6, conf, variant=variant, is_se3=is_se3,
            use_cf=use_cf, do_trim=do_trim, off_tr=off_tr, off_nrm=off_nrm,
            off_cov=off_cov, off_conf=off_conf)
    bsz, _, n = srcT.shape
    p = matchedT.shape[1]
    dev, f32 = srcT.device, torch.float32
    _check(srcT, "srcT", (bsz, 3, n), f32, dev)
    _check(matchedT, "matchedT", (bsz, p, n), f32, dev)
    _check(pf, "pf", (bsz, PF_WIDTH), f32, dev)
    need = 3 + (3 if is_se3 else 0)
    cov_ptr = conf_ptr = None
    if variant == "gicp":
        _check(cov6, "cov6", (bsz, 6, n), f32, dev)
        cov_ptr = cov6.data_ptr()
        need = max(need, off_cov + 6)
        if use_cf:
            _check(conf, "conf", (bsz, n), f32, dev)
            conf_ptr = conf.data_ptr()
            need = max(need, off_conf + 1)
    elif use_cf:
        raise ValueError("use_cf needs the gicp variant")
    if variant == "pt2pl":
        need = max(need, off_nrm + 3)
    if is_se3:
        need = max(need, off_tr + 3)
    if p < need:
        raise ValueError(f"matchedT has {p} rows, the payload layout "
                         f"needs {need}")
    if cluster is None:
        cluster = cluster_size(bsz, dev, do_trim)
    elif cluster not in (1, 2, 4, 8):
        raise ValueError(f"cluster {cluster}: the kernel takes 1, 2, 4 "
                         "or 8 blocks a pair")
    # A, b and st: views of one allocation
    out = torch.empty(bsz * 52, dtype=f32, device=dev)
    A = out[:bsz * 36].view(bsz, 6, 6)
    b = out[bsz * 36:bsz * 44].view(bsz, 8)
    st = out[bsz * 44:].view(bsz, 8)
    args = (srcT.data_ptr(), matchedT.data_ptr(), pf.data_ptr(), cov_ptr,
            conf_ptr, A.data_ptr(), b.data_ptr(), st.data_ptr(), bsz, n, p,
            _VARIANT_CODE[variant], int(is_se3), int(use_cf), int(do_trim),
            off_tr, off_nrm, off_cov, off_conf, index_steps(n), cluster)
    code = _build.launch(_build.load().se3icp_loop_epilogue, dev, *args)
    _build.check(code, "loop_epilogue_batched")
    _build.count_launch("loop_epilogue_batched", dev)
    return A, b, st


def cluster_size(bsz: int, device, do_trim: bool) -> int:
    """Blocks a pair runs on: the smallest C in (1, 2, 4, 8) with
    ``bsz * C`` at least the SM count of ``device`` (8 if none), and at
    most 2 when the call trims: every block of a pair runs the trim's
    bisections over all the pair's keys, so more, smaller blocks slow
    them (64 x 4608 trimmed to 0.75 on an H100: 0.030 ms alone at C = 2,
    0.044 at C = 4; ``tools/kernel_tiling_sweep.py --only k5``)."""
    c = _build.cluster_for(bsz, torch.device(device).index or 0)
    return min(c, 2) if do_trim else c


