"""Sort-free neighbourhood setup, natively batched: distance thresholds
(K1), ball moments (K2) and TOLDI x-axis sums (K3).

Counterpart of the JAX package's ``ops/pallas_moments.py``
(``_kernel_thresholds`` / ``neighborhood_thresholds_batched``,
``_kernel_moments`` / ``moments_batched``, ``_kernel_axis`` /
``axis_sums_batched``), with the JAX package's names and public layouts.
Every setup consumer (TOLDI frames, PCA normals, GICP covariances) needs
only the squared-distance threshold of its ball, never a sorted index
list: K1 finds, per query and per self-inclusive count c, a threshold
whose ball holds about c points (a 512-lane candidate fold and a seeded
rank search -- see ``csrc/thresholds.cu``); K2 sums [p, p p^T, 1] over
three balls per query; K3 sums the TOLDI x-axis weights.  The glue that
turns these sums into frames, normals and covariances is in
``ops/lrf.py``.

``SetupCloud`` is what survives on Hopper of the TPU's shared packed
operands (``pack_cloud_batched``): component-major float32 positions,
|p|^2 and the valid count, built once per cloud and handed to all three
kernels.  The limb packs and the poisoned padding do not survive:
kernels and plain versions skip rows >= n_valid.  It adds a spatial
query order for K2 and K3 (a Z-order sort of the valid rows): a warp of
neighbouring queries shares most of its balls' members, so the warp's
member branch runs in few of its steps.  No result depends on the
order: each query's sums run over its members in target-index order.

Distances are r = |t|^2 - 2 q.t with q.t = (qx tx + qy ty) + qz tz and
|t|^2 = (x x + y y) + z z, every step rounded on its own, in the kernels
(``csrc/dist.cuh``) and in the plain versions alike; so are K1's probe
values and K3's weights (square roots correctly rounded on both sides).
K1's thresholds and the balls' member counts are therefore the same
bits on the card and in the plain versions; the float sums of K2/K3
differ only in their order (the plain versions' are matrix products).
The kernels work in float32 whatever the caller's dtype, as the JAX
package's do.

Row slices: each wrapper takes ``rows=(r0, r1)`` for the query rows
[r0, r1) of the cloud against the whole cloud (the points route of
``parallel/points.py`` gives each rank its own rows; the JAX package's
``queries=`` path).  The per-query inputs and outputs then have r1 - r0
columns; K1's count clamp and bracket top stay the whole cloud's, and
K2/K3 walk the slice's entries of the Z-order (``SetupCloud.
rows_order``).  A query's results depend on its own inputs and the
cloud only, so a slice gives the whole call's rows bit for bit.

Each wrapper launches its CUDA kernel for tensors on the card and
raises if it cannot; it takes the plain version only for CPU tensors.
Each ``*_plain`` twin has the wrapper's arguments and results.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch
import torch.nn.functional as F

from se3_icp_tpu_torch.ops import _build
from se3_icp_tpu_torch.ops.cuda_knn import _check

CAND = 512               # K1 candidate lanes (lane = target index mod 512)
THR_PLAN = (16, 9, 6)    # K1 probes per descending-sorted count, then 8
MAX_COUNTS = 8           # counts per K1 call
_INIT = 3.0e38           # K1 candidate initial value
_SUMS = 10               # K2 sums per ball: x y z | xx xy xz yy yz zz | 1
_CHUNK_BYTES = 400_000_000   # one [B, chunk, N] block of the plain versions


@dataclass
class SetupCloud:
    """The per-cloud operands every setup kernel reads.  ``order`` is
    built from the others, never passed in: K2 and K3 take it for a
    permutation of each pair's rows."""
    pts_t: torch.Tensor     # [B,3,N] float32 positions, component-major
    tn: torch.Tensor        # [B,N]   float32 |p|^2
    n: torch.Tensor         # [B]     int32 valid rows
    order: torch.Tensor = field(init=False, repr=False)   # [B,N] int32
    _slices: dict = field(init=False, repr=False, default_factory=dict)

    def __post_init__(self):
        self.order = _morton_order(self.pts_t, self.n).contiguous()

    def rows_order(self, rows) -> torch.Tensor:
        """[B, r1 - r0] int32: K2's and K3's query order of the rows
        ``rows`` = (r0, r1) -- the entries of ``order`` that lie in the
        slice, in their order, as offsets from r0 -- or ``order`` itself
        for ``rows=None``.  Made once a slice (and again if ``order`` is
        replaced)."""
        if rows is None:
            return self.order
        r0, r1 = rows
        made = self._slices.get((r0, r1))
        if made is not None and made[0] is self.order:
            return made[1]
        inside = (self.order >= r0) & (self.order < r1)
        keep = torch.argsort((~inside).to(torch.uint8), dim=1,
                             stable=True)[:, :r1 - r0]
        out = (torch.take_along_dim(self.order, keep, 1) - r0).to(
            torch.int32).contiguous()
        self._slices[(r0, r1)] = (self.order, out)
        return out


def row_span(rows, n: int) -> tuple:
    """(r0, r1) of ``rows`` (None: every row of an n-row cloud),
    checked to lie in [0, n]."""
    if rows is None:
        return 0, n
    r0, r1 = int(rows[0]), int(rows[1])
    if not 0 <= r0 <= r1 <= n:
        raise ValueError(f"rows ({r0}, {r1}) outside the cloud's {n}")
    return r0, r1


def _spread3(v: torch.Tensor) -> torch.Tensor:
    """The 10 low bits of v moved to every third bit (Z-order)."""
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    return (v | (v << 2)) & 0x09249249


def _morton_order(pts_t: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """[B,N] int32: each pair's valid rows sorted (stably) by the Z-order
    code of 10 bits an axis over their own bounding box, then the padded
    rows in index order."""
    valid = (torch.arange(pts_t.shape[2], device=pts_t.device)[None, :]
             < n[:, None])[:, None, :]                        # [B,1,N]
    lo = torch.where(valid, pts_t, float("inf")).amin(2, keepdim=True)
    hi = torch.where(valid, pts_t, float("-inf")).amax(2, keepdim=True)
    scale = 1023.0 / torch.clamp_min(hi - lo, 1e-30)
    cell = torch.where(valid, (pts_t - lo) * scale, 0.0).clamp(0.0, 1023.0)
    v = _spread3(cell.to(torch.int32))                        # [B,3,N]
    key = torch.where(valid[:, 0], v[:, 0] | (v[:, 1] << 1) | (v[:, 2] << 2),
                      1 << 30)
    return torch.argsort(key, dim=1, stable=True).to(torch.int32)


def setup_cloud(points: torch.Tensor, n_valid: torch.Tensor) -> SetupCloud:
    """points [B,N,3] (any float dtype; padded rows arbitrary), n_valid
    [B] -> the shared operands, built once per cloud."""
    pts_t = points.to(torch.float32).mT.contiguous()
    x, y, z = pts_t.unbind(1)
    tn = (x * x + y * y) + z * z
    return SetupCloud(pts_t=pts_t, tn=tn.contiguous(),
                      n=n_valid.to(device=pts_t.device,
                                   dtype=torch.int32).contiguous())


def _cloud(points, n_valid, cloud):
    return cloud if cloud is not None else setup_cloud(points, n_valid)


def _valid_cols(cloud: SetupCloud) -> torch.Tensor:
    n = cloud.pts_t.shape[2]
    col = torch.arange(n, device=cloud.pts_t.device)
    return col[None, :] < cloud.n[:, None]                    # [B,N]


def _chunk(cloud: SetupCloud) -> int:
    bsz, _, n = cloud.pts_t.shape
    return max(32, _CHUNK_BYTES // max(bsz * n * 4, 1))


def _row_blocks(r0: int, r1: int, chunk: int, n: int):
    """(b0, b1, lo, hi): the blocks of ``chunk`` rows at multiples of
    ``chunk`` (the last one cut at n) that meet the rows [r0, r1), and
    the rows [lo, hi) of each that lie in them.  The plain versions'
    matrix products run on whole blocks: a CPU product's row can take
    other bits in a block of another height or offset, so a row slice
    computes the whole call's blocks and keeps its rows."""
    for b0 in range(r0 - r0 % chunk, r1, chunk):
        b1 = min(n, b0 + chunk)
        yield b0, b1, max(b0, r0), min(b1, r1)


def _block_rows(x: torch.Tensor, r0: int, b0: int, b1: int, lo: int,
                hi: int, fill: float) -> torch.Tensor:
    """The rows [b0, b1) of the per-query inputs ``x`` [..., C] of the
    rows r0 .. r0 + C - 1 along the last axis: its rows [lo, hi), the
    others ``fill``."""
    out = x.new_full(x.shape[:-1] + (b1 - b0,), fill)
    out[..., lo - b0:hi - b0] = x[..., lo - r0:hi - r0]
    return out


def _shifted_d2(cloud: SetupCloud, s: int, e: int) -> torch.Tensor:
    """r = |t|^2 - 2 q.t [B,C,N] for the query rows s:e, in the kernels'
    rounding steps (``csrc/dist.cuh``)."""
    p = cloud.pts_t
    q = p[:, :, s:e, None]                                    # [B,3,C,1]
    t = p[:, :, None, :]                                      # [B,3,1,N]
    dot = q[:, 0] * t[:, 0] + q[:, 1] * t[:, 1]
    dot = dot + q[:, 2] * t[:, 2]
    return cloud.tn[:, None, :] - 2.0 * dot


def _sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root, as ``__fsqrt_rn``: torch's
    CPU float32 ``sqrt`` is off by one ulp for ~0.6% of inputs, and the
    square root of a float32 taken in float64 and rounded once is
    exact-rounded on every device."""
    return torch.sqrt(x.double()).to(torch.float32)


def _check_cloud(cloud: SetupCloud):
    bsz, _, n = cloud.pts_t.shape
    dev, f32 = cloud.pts_t.device, torch.float32
    _check(cloud.pts_t, "cloud.pts_t", (bsz, 3, n), f32, dev)
    _check(cloud.tn, "cloud.tn", (bsz, n), f32, dev)
    _check(cloud.n, "cloud.n", (bsz,), torch.int32, dev)
    _check(cloud.order, "cloud.order", (bsz, n), torch.int32, dev)
    return bsz, n, dev


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


# ---------------------------------------------------------------- K1

def plan(t_n: int) -> tuple:
    """Probes per descending-sorted count."""
    return tuple(THR_PLAN[t] if t < len(THR_PLAN) else 8 for t in range(t_n))


def _threshold_inputs(points, n_valid, counts, cloud):
    """The wrapper's host-side parts: counts clamped to n_valid and
    sorted descending (stable; ``order`` un-permutes the rows after),
    and the bracket top hib = 4 max|p|^2 + 1 over the valid rows."""
    cloud = _cloud(points, n_valid, cloud)
    t_n = counts.shape[1]
    if not 1 <= t_n <= MAX_COUNTS:
        raise ValueError(f"{t_n} counts per call; 1..{MAX_COUNTS} supported")
    nv = cloud.n.to(torch.int64)
    cc = torch.minimum(counts.to(device=nv.device, dtype=torch.int64),
                       nv[:, None])
    order = torch.argsort(-cc, dim=1, stable=True)
    cc = torch.take_along_dim(cc, order, 1).to(torch.float32).contiguous()
    p2 = torch.where(_valid_cols(cloud), cloud.tn, 0.0)
    hib = (4.0 * p2.amax(1) + 1.0).contiguous()
    return cloud, cc, hib, order


def _unpermute(out, order):
    inv = torch.argsort(order, dim=1, stable=True)
    return torch.take_along_dim(out, inv[:, :, None], 1)


def _rank_search(cand, cc):
    """Bracket seeds + the probe plan on candidates [B,C,512] for the
    descending counts cc [B,T]; returns the thresholds [B,T,C]."""
    dev, f32 = cand.device, torch.float32
    t_n = cc.shape[1]
    c1e9 = torch.tensor(1e-9, dtype=f32, device=dev)
    lo0, hi0 = cand.amin(-1), cand.amax(-1)
    seeds = []
    m = torch.minimum(cand[..., :256], cand[..., 256:])
    for g in (256, 128, 64, 32):
        seeds.append((m.amax(-1), float(g)))
        if g > 32:
            m = torch.minimum(m[..., :g // 2], m[..., g // 2:])
    tg = [cc[:, t, None] for t in range(t_n)]                 # [B,1]
    los = [lo0] * t_n
    cls = [torch.ones_like(lo0)] * t_n
    his = [hi0] * t_n
    chs = [torch.full_like(lo0, float(CAND))] * t_n
    for sv, g in seeds:
        for t in range(t_n):
            ok = (tg[t] <= g) & (sv < his[t])
            his[t] = torch.where(ok, sv, his[t])
            chs[t] = torch.where(ok, g, chs[t])
    chs = [torch.maximum(chs[t], tg[t] + 1.0) for t in range(t_n)]
    for t, steps in enumerate(plan(t_n)):
        for s in range(steps):
            lo, cl, hi, ch = los[t], cls[t], his[t], chs[t]
            dlt = hi - lo
            if s % 4 == 0:        # linear rank-secant
                fr = torch.clamp((tg[t] - cl) / torch.clamp_min(ch - cl, 1.0),
                                 0.02, 0.98)
                probe = lo + fr * dlt
            elif s % 4 == 2:      # geometric bisection
                probe = _sqrt_rn(torch.maximum(lo, hi * c1e9) * hi)
            else:                 # arithmetic bisection
                probe = lo + 0.5 * dlt
            cnt = (cand <= probe[..., None]).sum(-1).to(f32)
            for u in range(t_n):
                pred = cnt >= tg[u]
                take_hi = pred & (probe < his[u])
                take_lo = ~pred & (probe > los[u])
                los[u] = torch.where(take_lo, probe, los[u])
                cls[u] = torch.where(take_lo, cnt, cls[u])
                his[u] = torch.where(take_hi, probe, his[u])
                chs[u] = torch.where(take_hi, cnt, chs[u])
    return torch.stack(his, 1)


def _thresholds_core_plain(cloud, cc, hib, rows=None):
    bsz, _, n = cloud.pts_t.shape
    r0, r1 = row_span(rows, n)
    dev = cloud.pts_t.device
    init = torch.tensor(_INIT, dtype=torch.float32, device=dev)
    width = -(-n // CAND) * CAND
    valid = _valid_cols(cloud)
    out = torch.empty((bsz, cc.shape[1], r1 - r0), dtype=torch.float32,
                      device=dev)
    chunk = _chunk(cloud)
    for s in range(r0, r1, chunk):
        e = min(r1, s + chunk)
        r = torch.where(valid[:, None, :], _shifted_d2(cloud, s, e), init)
        r = F.pad(r, (0, width - n), value=_INIT)
        cand = torch.minimum(
            r.view(bsz, e - s, width // CAND, CAND).amin(2), init)
        cand = cand + cloud.tn[:, s:e, None]                  # un-shift
        cand = torch.minimum(cand, hib[:, None, None]).clamp_min(0.0)
        out[:, :, s - r0:e - r0] = _rank_search(cand, cc)
    return out


def neighborhood_thresholds_plain(points, n_valid, counts, cloud=None,
                                  rows=None):
    """Plain PyTorch version of ``neighborhood_thresholds_batched``."""
    cloud, cc, hib, order = _threshold_inputs(points, n_valid, counts,
                                              cloud)
    return _unpermute(_thresholds_core_plain(cloud, cc, hib, rows), order)


def neighborhood_thresholds_batched(points, n_valid, counts, cloud=None,
                                    rows=None):
    """Batched neighbourhood-size -> distance-threshold conversion.

    points [B,N,3] (padded rows arbitrary), n_valid [B], counts [B,T]
    integer SELF-INCLUSIVE neighbourhood sizes (T <= 8), ``cloud`` the
    optional shared operands of ``setup_cloud``.  Returns thr [B,T,N]
    float32 squared-distance thresholds, one [N]-wide row per count in
    the caller's order, with |{j valid : d2_ij <= thr[b,t,i]}| ~=
    min(counts[b,t], n_valid[b]) (within [c-2, c+4] plus lane-collision
    slack); thr of count k converges to the k-th nearest candidate
    distance from above, so it doubles as the TOLDI radius^2.
    ``rows=(r0, r1)``: the query rows [r0, r1) only, against the whole
    cloud -> thr [B,T,r1-r0], the whole call's columns r0:r1.
    """
    cloud, cc, hib, order = _threshold_inputs(points, n_valid, counts,
                                              cloud)
    if not cloud.pts_t.is_cuda:
        return _unpermute(_thresholds_core_plain(cloud, cc, hib, rows),
                          order)
    bsz, n, dev = _check_cloud(cloud)
    r0, r1 = row_span(rows, n)
    t_n = cc.shape[1]
    lib = _build.load()
    out = torch.empty((bsz, t_n, r1 - r0), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        code = lib.se3icp_thresholds_rows(
            cloud.pts_t.data_ptr(), cloud.tn.data_ptr(), cloud.n.data_ptr(),
            cc.data_ptr(), hib.data_ptr(), out.data_ptr(), bsz, n, r0,
            r1 - r0, t_n, _stream(dev))
    _build.check(code, "neighborhood_thresholds_batched")
    _build.count_launch("neighborhood_thresholds_batched", dev)
    return _unpermute(out, order)




# ---------------------------------------------------------------- K2

def _moments_raw_plain(cloud, thr_s, r0: int = 0):
    """[B,10 M,C] for thr_s [B,M,C] of the query rows r0 .. r0 + C - 1:
    per ball m, rows 10 m .. 10 m + 9 = sums of x y z, xx xy xz yy yz
    zz, 1 over the valid targets with r <= thr_s[:, m] (self
    included)."""
    bsz, balls, nq = thr_s.shape
    valid = _valid_cols(cloud)
    x, y, z = cloud.pts_t.unbind(1)
    feat = torch.stack([x, y, z, x * x, x * y, x * z, y * y, y * z, z * z,
                        torch.ones_like(x)], -1)              # [B,N,10]
    out = torch.empty((bsz, balls, _SUMS, nq), dtype=torch.float32,
                      device=cloud.pts_t.device)
    for b0, b1, lo, hi in _row_blocks(r0, r0 + nq, _chunk(cloud),
                                      cloud.pts_t.shape[2]):
        r = _shifted_d2(cloud, b0, b1)
        thr = _block_rows(thr_s, r0, b0, b1, lo, hi, float("nan"))
        for m in range(balls):
            mask = (r <= thr[:, m, :, None]) & valid[:, None, :]
            out[:, m, :, lo - r0:hi - r0] = (
                mask.to(torch.float32) @ feat).mT[..., lo - b0:hi - b0]
    return out.view(bsz, balls * _SUMS, nq)


def _moments_inputs(points, n_valid, thrs, cloud, rows=None):
    """The cloud and the shifted thresholds [B,M,C] of the M balls whose
    thresholds [B,C] of the query rows ``rows`` are ``thrs``."""
    cloud = _cloud(points, n_valid, cloud)
    r0, r1 = row_span(rows, cloud.pts_t.shape[2])
    thr = torch.stack(thrs, 1).to(torch.float32)
    return cloud, (thr - cloud.tn[:, None, r0:r1]).contiguous()


def _moments_dict(raw, points):
    """Component-major sums with the self term removed, the keys of the
    JAX package's ``moments_batched``, in the caller's dtype; a one-ball
    ``raw`` serves all three balls."""
    bsz, rows, n = raw.shape
    q_t = points.mT                                           # [B,3,N]
    x, y, z = q_t[:, 0:1], q_t[:, 1:2], q_t[:, 2:3]
    # slices and concatenations only: indexing a card tensor with a list
    # copies the list to the card and waits for the kernel before it
    self10 = torch.cat([q_t, x * q_t, y * q_t[:, 1:], z * z,
                        torch.ones_like(x)], 1)               # [B,10,N]
    d = (raw.to(points.dtype).view(bsz, rows // _SUMS, _SUMS, n)
         - self10[:, None])

    def block(m):
        s = d[:, min(m, d.shape[1] - 1)]
        # the nine of p p^T (row 3 i + j = p_j p_i) from xx xy xz yy yz zz
        p9 = torch.cat([s[:, 3:6], s[:, 4:5], s[:, 6:8], s[:, 5:6],
                        s[:, 7:9]], 1)
        return s[:, :3], p9, s[:, 9]
    cen_sum, cen_p9, cen_cnt = block(0)
    cov_sum, cov_p9, cov_cnt = block(1)
    all_sum, _, all_cnt = block(2)
    return dict(cen_sum=cen_sum, cen_cnt=cen_cnt, cen_p9=cen_p9,
                cov_sum=cov_sum, cov_p9=cov_p9, cov_cnt=cov_cnt,
                all_sum=all_sum, all_cnt=all_cnt, q_t=q_t)


def moments_plain(points, n_valid, thr_cen, thr_cov, thr_all, cloud=None,
                  rows=None):
    """Plain PyTorch version of ``moments_batched``."""
    cloud, thr_s = _moments_inputs(
        points, n_valid, (thr_cen, thr_cov, thr_all), cloud, rows)
    r0 = row_span(rows, points.shape[1])[0]
    return _moments_dict(_moments_raw_plain(cloud, thr_s, r0),
                         points[:, r0:r0 + thr_s.shape[2]])


def moments_batched(points, n_valid, thr_cen, thr_cov, thr_all,
                    cloud=None, rows=None):
    """Batched neighbourhood moments for three distance thresholds.

    points [B,N,3] (padded rows arbitrary), n_valid [B], thr_* [B,N]
    absolute squared-distance thresholds per query (the query itself is
    inside every ball), ``cloud`` the optional shared operands.  Returns
    a dict of COMPONENT-MAJOR per-query sums in the caller's dtype with
    the SELF term removed: cen_sum/cov_sum/all_sum [B,3,N], cen_p9 /
    cov_p9 [B,9,N], cen_cnt/cov_cnt/all_cnt [B,N], and q_t [B,3,N] (the
    query positions transposed).  ``rows=(r0, r1)``: the query rows
    [r0, r1) only (thr_* [B,r1-r0]), every result r1 - r0 wide.
    """
    return _moments(points, n_valid, (thr_cen, thr_cov, thr_all), cloud,
                    rows)


def moments_one_ball(points, n_valid, thr, cloud=None, rows=None):
    """``moments_batched(points, n_valid, thr, thr, thr, cloud, rows)``
    with the one ball summed once (K2's one-ball instance): the same
    dict, the same bits.  Its launches count as ``moments_batched``'s.
    """
    return _moments(points, n_valid, (thr,), cloud, rows)


def _moments(points, n_valid, thrs, cloud, rows):
    """K2 over the balls of ``thrs`` (three, or one serving all three)."""
    raw = moments_raw(points, n_valid, thrs, cloud, rows)
    r0 = row_span(rows, points.shape[1])[0]
    return _moments_dict(raw, points[:, r0:r0 + raw.shape[2]])


def moments_raw(points, n_valid, thrs, cloud=None, rows=None):
    """K2's sums before ``_moments_dict``: [B,10 M,C] float32 for the M
    balls whose thresholds [B,C] of the query rows ``rows`` are ``thrs``
    (a tuple; one ball is K2's one-ball instance): per ball, rows 10 m ..
    10 m + 9 = sums of x y z, xx xy xz yy yz zz, 1 over its members, the
    query itself included.  The setup glue's kernels
    (``ops/cuda_frames.py``) read these; the launches count as
    ``moments_batched``'s."""
    cloud, thr_s = _moments_inputs(points, n_valid, thrs, cloud, rows)
    r0, nq = row_span(rows, points.shape[1])[0], thr_s.shape[2]
    if not cloud.pts_t.is_cuda:
        return _moments_raw_plain(cloud, thr_s, r0)
    bsz, n, dev = _check_cloud(cloud)
    balls = thr_s.shape[1]
    _check(thr_s, "thresholds", (bsz, balls, nq), torch.float32, dev)
    order = cloud.rows_order(rows)
    lib = _build.load()
    raw = torch.empty((bsz, balls * _SUMS, nq), dtype=torch.float32,
                      device=dev)
    with torch.cuda.device(dev):
        code = lib.se3icp_moments_rows(
            cloud.pts_t.data_ptr(), cloud.tn.data_ptr(), cloud.n.data_ptr(),
            order.data_ptr(), thr_s.data_ptr(), raw.data_ptr(), bsz, n, r0,
            nq, balls, _stream(dev))
    _build.check(code, "moments_batched")
    _build.count_launch("moments_batched", dev)
    return raw




# ---------------------------------------------------------------- K3

def _axis_inputs(points, n_valid, normal_t, ndotq, radius, thr_all, cloud,
                 rows=None):
    cloud = _cloud(points, n_valid, cloud)
    r0, r1 = row_span(rows, cloud.pts_t.shape[2])
    f32 = torch.float32
    aux = torch.stack([thr_all.to(f32) - cloud.tn[:, r0:r1], radius.to(f32),
                       ndotq.to(f32)], 1).contiguous()        # [B,3,C]
    return cloud, normal_t.to(f32).contiguous(), aux


def _axis_raw_plain(cloud, nrm, aux, r0: int = 0):
    """[B,4,C] for the query rows r0 .. r0 + C - 1: sum_j W p_j (3 rows)
    and sum_j W over the valid targets."""
    bsz, _, n_rows = aux.shape
    valid = _valid_cols(cloud)
    pts = cloud.pts_t.mT                                      # [B,N,3]
    t = cloud.pts_t[:, :, None, :]                            # [B,3,1,N]
    out = torch.empty((bsz, 4, n_rows), dtype=torch.float32,
                      device=cloud.pts_t.device)
    for b0, b1, lo, hi in _row_blocks(r0, r0 + n_rows, _chunk(cloud),
                                      cloud.pts_t.shape[2]):
        blk = _block_rows(aux, r0, b0, b1, lo, hi, float("nan"))
        nrm_b = _block_rows(nrm, r0, b0, b1, lo, hi, 0.0)
        r = _shifted_d2(cloud, b0, b1)
        member = (r <= blk[:, 0, :, None]) & valid[:, None, :]
        d = _sqrt_rn(torch.clamp_min(r + cloud.tn[:, b0:b1, None], 0.0))
        w1 = blk[:, 1, :, None] - d
        nq = nrm_b[:, :, :, None]                             # [B,3,C,1]
        ndp = nq[:, 0] * t[:, 0] + nq[:, 1] * t[:, 1]
        ndp = ndp + nq[:, 2] * t[:, 2]
        zd = ndp - blk[:, 2, :, None]
        w = torch.where(member, (w1 * w1) * (zd * zd), 0.0)   # [B,C,N]
        keep = slice(lo - b0, hi - b0)
        out[:, :3, lo - r0:hi - r0] = (w @ pts).mT[..., keep]
        out[:, 3, lo - r0:hi - r0] = w.sum(-1)[:, keep]
    return out


def axis_sums_plain(points, n_valid, normal_t, ndotq, radius, thr_all,
                    cloud=None, rows=None):
    """Plain PyTorch version of ``axis_sums_batched``."""
    cloud, nrm, aux = _axis_inputs(points, n_valid, normal_t, ndotq,
                                   radius, thr_all, cloud, rows)
    r0 = row_span(rows, points.shape[1])[0]
    out = _axis_raw_plain(cloud, nrm, aux, r0)
    return out[:, :3], out[:, 3]


def axis_sums_batched(points, n_valid, normal_t, ndotq, radius, thr_all,
                      cloud=None, rows=None):
    """Batched TOLDI x-axis weighted sums (component-major).

    W_ij = [d2_ij <= thr_all_i] (radius_i - d_ij)^2 (n_i . (p_j - q_i))^2
    (the self term vanishes).  ``normal_t`` [B,3,N] unit normals;
    ``ndotq`` (n_i . q_i), ``radius``, ``thr_all`` [B,N] per query.
    Returns (sum_j W p_j [B,3,N], sum_j W [B,N]) in float32.
    ``rows=(r0, r1)``: the query rows [r0, r1) only (every per-query
    input and result r1 - r0 wide).
    """
    cloud, nrm, aux = _axis_inputs(points, n_valid, normal_t, ndotq,
                                   radius, thr_all, cloud, rows)
    out = axis_sums_aux(points, n_valid, nrm, aux, cloud, rows)
    return out[:, :3], out[:, 3]


def axis_sums_aux(points, n_valid, normal_t, aux, cloud=None, rows=None):
    """``axis_sums_batched`` on its per-query operands as K3 reads them:
    ``normal_t`` [B,3,C] and aux = (thr_all - |q|^2, radius, n.q)
    [B,3,C] float32 (``cuda_frames.frame_inputs`` writes both).  Returns
    K3's [B,4,C] (sum_j W p_j, sum_j W)."""
    cloud = _cloud(points, n_valid, cloud)
    r0 = row_span(rows, points.shape[1])[0]
    nrm = normal_t.to(torch.float32).contiguous()
    if not cloud.pts_t.is_cuda:
        return _axis_raw_plain(cloud, nrm, aux, r0)
    bsz, n, dev = _check_cloud(cloud)
    nq = aux.shape[2]
    _check(nrm, "normal_t", (bsz, 3, nq), torch.float32, dev)
    _check(aux, "thr_all/radius/ndotq", (bsz, 3, nq), torch.float32, dev)
    order = cloud.rows_order(rows)
    lib = _build.load()
    out = torch.empty((bsz, 4, nq), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        code = lib.se3icp_axis_rows(
            cloud.pts_t.data_ptr(), cloud.tn.data_ptr(), cloud.n.data_ptr(),
            order.data_ptr(), nrm.data_ptr(), aux.data_ptr(),
            out.data_ptr(), bsz, n, r0, nq, _stream(dev))
    _build.check(code, "axis_sums_batched")
    _build.count_launch("axis_sums_batched", dev)
    return out
