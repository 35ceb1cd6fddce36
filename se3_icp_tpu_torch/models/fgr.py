"""Fast Global Registration (FGR) -- the reference's comparison baseline,
natively batched over pairs.

Port of the JAX package's ``models/fgr.py``.  The reference delegates to
Open3D's ``FastGlobalRegistrationBasedOnFeatureMatching`` with default
options on FPFH(knn=100) features over normals(knn=30).  Algorithm:
Zhou, Park, Koltun, "Fast Global Registration", ECCV 2016.

Static shapes throughout, no KD-trees, no dynamic correspondence lists:

  * features: one exact sorted kNN (k = max(fpfh_knn, normals_knn) + 1)
    per cloud, PCA normals and FPFH (``ops/fpfh.py``), their
    neighbourhood sums over the kNN's members in ascending row index;
  * feature matching: exact 33-D nearest neighbours in both directions,
    two launches of K6 (``ops/cuda_nn.py``); the reciprocity test is a
    mask over the fixed-length forward match array;
  * tuple test: instead of rejection-sampling until 1000 accepted tuples,
    a static batch of random triples is tested at once and the first
    ``maximum_tuple_count`` accepted ones kept by cumulative rank;
    surviving correspondences get multiplicity weights by a scatter-add;
  * graduated non-convexity: 64 Gauss-Newton steps with Geman-McClure
    line-process weights l = (mu / (mu + r^2))^2, mu divided by 1.4
    every 4 steps from the normalised global scale down to
    ``maximum_correspondence_distance``;
  * the Gauss-Newton sums run in the fixed order of the setup's
    centring (``cuda_prep.lane_sums``), the 6x6 solve and Euler-ZYX
    retraction are the loop step's component-wise forms
    (``solve.solve6_c``, ``euler_zyx_c``): with the centroids and radii
    of that order, a pair's result depends on its own clouds alone.

The random triples: the JAX package draws ``jax.random.randint(key(
seed), (tuple_trials, 3), 0, 1 << 30)`` once, shared by every pair of a
batch.  Here the same shape is drawn from a ``torch.Generator`` seeded
with ``cfg.seed``, shared by the batch; the two generators give other
numbers, so ``raw_triples`` lets a caller hand in its own.

The JAX package's TPU route takes the feature kNN's top-k through the
TPU's approximate PartialReduce; off the TPU it is exact, as here.

Default options mirror ``FastGlobalRegistrationOption``: division_factor
1.4, use_absolute_scale False, decrease_mu True,
maximum_correspondence_distance 0.025, iteration_number 64, tuple_scale
0.95, maximum_tuple_count 1000.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from se3_icp_tpu_torch.ops import fpfh as fpfh_ops
from se3_icp_tpu_torch.ops import cuda_prep, knn, lrf, solve
from se3_icp_tpu_torch.utils import se3


@dataclass(frozen=True)
class FGRConfig:
    """Open3D ``FastGlobalRegistrationOption`` defaults + the fixed
    feature hyperparameters every reference call site uses."""

    division_factor: float = 1.4
    use_absolute_scale: bool = False
    decrease_mu: bool = True
    maximum_correspondence_distance: float = 0.025
    iteration_number: int = 64
    tuple_scale: float = 0.95
    maximum_tuple_count: int = 1000
    tuple_test: bool = True
    # feature pipeline (reference call sites)
    normals_knn: int = 30       # EstimateNormals KNN(30)
    fpfh_knn: int = 100         # ComputeFPFHFeature KNN(100)
    # static sampling budget replacing rejection sampling
    tuple_trials: int = 16384
    seed: int = 0

    def replace(self, **kw) -> "FGRConfig":
        return dataclasses.replace(self, **kw)


def _valid(n_valid: torch.Tensor, n: int) -> torch.Tensor:
    return torch.arange(n, device=n_valid.device)[None, :] < n_valid[:, None]


def features(points: torch.Tensor, n_valid: torch.Tensor,
             cfg: FGRConfig, probe=None) -> torch.Tensor:
    """FPFH [B,N,33] of padded clouds (padded rows zeroed first) on the
    ORIGINAL coordinates, as the reference computes them before any
    normalisation; padded rows set to 1e6 so they never match.  The
    kNN's distances are written out elementwise and the neighbourhood
    sums (the normals' moments, FPFH's weighted SPFH sum) run over the
    kNN's members in ascending row index (``knn.neighbor_sums``), so a
    pair's features do not depend on its batch.  ``probe`` (optional
    list) receives the stages' products: (idx, d2, normals, spfh,
    fpfh)."""
    valid = _valid(n_valid, points.shape[1])
    pts = torch.where(valid[..., None], points, torch.zeros_like(points))
    kw = max(cfg.fpfh_knn, cfg.normals_knn) + 1
    idx, d2 = knn.knn_self(pts, kw, n_valid, fixed_order=True)
    nrm = lrf.normals_knn(pts, idx, d2, cfg.normals_knn, n_valid)
    kf = cfg.fpfh_knn
    mask = fpfh_ops.neighbor_mask(pts.shape[1], kf, n_valid)
    spfh = fpfh_ops.spfh(pts, nrm, idx[..., :kf], mask)
    feat = fpfh_ops.fpfh_from_neighbors(
        pts, nrm, idx[..., :kf], d2[..., :kf], mask, n_valid=n_valid,
        dense_sum=False, spfh_table=spfh)
    if probe is not None:
        probe.append((idx, d2, nrm, spfh, feat))
    return torch.where(valid[..., None], feat,
                       torch.full((), 1e6, dtype=feat.dtype,
                                  device=feat.device))


def reciprocal_matches(feat_s, n_src, feat_t, n_tgt):
    """Feature matching with AdvancedMatching's cross check: (fwd [B,Ns]
    source i -> target, bwd [B,Nt] target j -> source), two K6
    launches."""
    fwd, _ = knn.nn_argmin(feat_s, feat_t, n_tgt)
    bwd, _ = knn.nn_argmin(feat_t, feat_s, n_src)
    return fwd.to(torch.int64), bwd.to(torch.int64)


def raw_triples(cfg: FGRConfig, device) -> torch.Tensor:
    """[tuple_trials, 3] random integers in [0, 2^30), from a generator
    seeded with ``cfg.seed``; one draw for the whole batch."""
    gen = torch.Generator(device="cpu").manual_seed(cfg.seed)
    return torch.randint(0, 1 << 30, (cfg.tuple_trials, 3), generator=gen,
                         dtype=torch.int64).to(device)


def _tuple_test(src, tgt, fwd, recip, cfg: FGRConfig, raw):
    """Static-batch tuple test: random correspondence triples must have
    consistent edge-length ratios in both clouds
    (tau < |e_src|/|e_tgt| < 1/tau, tau = tuple_scale).  Returns [B,Ns]
    multiplicity weights over the first ``maximum_tuple_count`` accepted
    triples of each pair."""
    dtype = src.dtype
    bsz, ns, _ = src.shape
    ncorr = torch.clamp_min(recip.sum(-1), 1)                  # [B]
    # valid correspondence indices compacted to a prefix, valid first
    order = torch.argsort((~recip).to(torch.uint8), dim=-1, stable=True)
    pick = (raw[None] % ncorr[:, None, None]).reshape(bsz, -1)
    tri = torch.gather(order, 1, pick)                          # [B,3T]
    pi = torch.gather(src, 1, tri[..., None].expand(-1, -1, 3))
    qi = torch.gather(tgt, 1, torch.gather(fwd, 1, tri)[..., None].expand(
        -1, -1, 3))
    pi = pi.reshape(bsz, -1, 3, 3)
    qi = qi.reshape(bsz, -1, 3, 3)
    tri = tri.reshape(bsz, -1, 3)

    def norm(d):
        dx, dy, dz = d.unbind(-1)
        return cuda_prep._sqrt_rn((dx * dx + dy * dy) + dz * dz)

    def edges(x):
        return torch.stack([norm(x[:, :, 0] - x[:, :, 1]),
                            norm(x[:, :, 1] - x[:, :, 2]),
                            norm(x[:, :, 2] - x[:, :, 0])], dim=-1)

    li, lj = edges(pi), edges(qi)
    tau = cfg.tuple_scale
    okr = (li * tau < lj) & (lj < li / tau)
    distinct = ((tri[..., 0] != tri[..., 1]) & (tri[..., 1] != tri[..., 2])
                & (tri[..., 0] != tri[..., 2]))
    accept = okr.all(-1) & distinct
    rank = torch.cumsum(accept.to(torch.int32), dim=-1)
    accept = accept & (rank <= cfg.maximum_tuple_count)
    # multiplicity weights: a scatter-add over the 3 member indices (sums
    # of whole numbers, the same in any order)
    contrib = accept.to(dtype)[..., None].expand(-1, -1, 3).reshape(bsz, -1)
    w = torch.zeros((bsz, ns), dtype=dtype, device=src.device)
    return w.scatter_add_(1, tri.reshape(bsz, -1), contrib)


# the upper triangle of a 6x6 matrix, row by row
_UPPER = [(a, c) for a in range(6) for c in range(a, 6)]


def _normal_equations(pm, r3, w, n_src):
    """One Gauss-Newton step's normal equations of the pt2pt rows
    J_k = [-skew(pm)_k | e_k], r_k = pm_k - q_k (k = 0, 1, 2 a point),
    weighted by w [B,Ns]: (A [B,6,6] = sum w J^T J, rhs six [B] tensors
    -sum w J^T r).  Each point's 21 + 6 entries, its three rows one
    after another, are summed over the rows below ``n_src`` in the
    fixed order of ``cuda_prep.lane_sums``: a pair's bits depend on its
    own rows alone.  Integer indexing only (a capture takes no index
    tensor made on the host)."""
    zero = torch.zeros_like(pm[0])
    # rows of -skew(pm): (0, pm2, -pm1), (-pm2, 0, pm0), (pm1, -pm0, 0)
    rot = ((zero, pm[2], -pm[1]), (-pm[2], zero, pm[0]),
           (pm[1], -pm[0], zero))
    J = torch.stack([torch.stack(
        list(rot[k]) + [torch.ones_like(zero) if a == k else zero
                        for a in range(3)], -1)
        for k in range(3)], -2)                             # [B,Ns,3,6]
    Jw = J * w[..., None, None]
    r = torch.stack(r3, -1)                                 # [B,Ns,3]
    x = torch.stack([Jw[..., a] * J[..., c] for a, c in _UPPER]
                    + [Jw[..., a] * r for a in range(6)], -1)  # [B,Ns,3,27]
    sums = cuda_prep.lane_sums(x, n_src)
    at = {ac: i for i, ac in enumerate(_UPPER)}
    A = torch.stack([torch.stack([sums[:, at[min(a, c), max(a, c)]]
                                  for c in range(6)], -1)
                     for a in range(6)], -2)
    return A, [-sums[:, 21 + a] for a in range(6)]


def _solve_retract(A, rhs):
    """A xi = rhs per pair by the component-wise elimination of the loop
    step (``solve.solve6_c``), retracted by Euler-ZYX
    (``solve.euler_zyx_c``): (dR, dt) as [B,1] components; the identity
    where the solve fails or its transform is not finite, the contract
    of ``solve.solve_normal_equations``."""
    xi, ok = solve.solve6_c(A, rhs)
    dR, dt = solve.euler_zyx_c(xi)
    for v in [x for row in dR for x in row] + dt:
        ok = ok & torch.isfinite(v)
    one, zero = torch.ones_like(xi[0]), torch.zeros_like(xi[0])
    dR = [[torch.where(ok, dR[i][j], one if i == j else zero)[:, None]
           for j in range(3)] for i in range(3)]
    dt = [torch.where(ok, v, zero)[:, None] for v in dt]
    return dR, dt


def register_from_matches(src, n_src, tgt, n_tgt, fwd, bwd,
                          cfg: FGRConfig, raw=None, stats=None):
    """FGR after the feature matching: the reciprocal set from ``fwd`` /
    ``bwd`` (int [B,Ns] / [B,Nt]), the tuple test on ``raw`` random
    integers [tuple_trials, 3] (default ``raw_triples(cfg)``), scale
    normalisation, the GNC loop and the denormalisation.  Returns T
    [B,4,4] (identity for pairs with fewer than 3 correspondences).
    ``stats`` (optional dict) receives the per-pair counts as lists."""
    if cfg.tuple_test and raw is None:
        raw = raw_triples(cfg, src.device)
    T, recip, kept = _register_from_matches(src, n_src, tgt, n_tgt, fwd,
                                            bwd, cfg, raw)
    if stats is not None:
        stats["reciprocal"] = recip.tolist()
        stats["kept_correspondences"] = kept.tolist()
    return T


def _register_from_matches(src, n_src, tgt, n_tgt, fwd, bwd,
                           cfg: FGRConfig, raw, probe=None):
    """``register_from_matches`` with the per-pair counts as device
    tensors: (T [B,4,4], reciprocal-set sizes [B], correspondences kept
    by the tuple test [B]).  Reads nothing back.  ``probe`` (optional
    dict) receives the stages' products: the tuple test's weights
    (``weights``), the centring and scale (``centring``) and each
    Gauss-Newton step's normal equations (``gn``, a list)."""
    dtype = src.dtype
    bsz, ns, _ = src.shape
    src_valid = _valid(n_src, ns)
    tgt_valid = _valid(n_tgt, tgt.shape[1])
    src = torch.where(src_valid[..., None], src, torch.zeros_like(src))
    tgt = torch.where(tgt_valid[..., None], tgt, torch.zeros_like(tgt))
    fwd = fwd.to(torch.int64)
    recip = (torch.gather(bwd.to(torch.int64), 1, fwd)
             == torch.arange(ns, device=src.device)[None, :]) & src_valid

    if cfg.tuple_test:
        corr_w = _tuple_test(src, tgt, fwd, recip, cfg, raw.to(src.device))
    else:
        corr_w = recip.to(dtype)
    kept = (corr_w > 0).sum(-1)
    if probe is not None:
        probe["weights"] = corr_w

    # scale normalisation (original FGR NormalizePoints): the centroids
    # and radii of the setup's fixed order (``ops/cuda_prep.py``, G4's
    # plain version); the clouds divided by the radius, as the JAX
    # package divides
    cen_s = cuda_prep.centroid(src, n_src)
    cen_t = cuda_prep.centroid(tgt, n_tgt)
    zero = torch.zeros((), dtype=dtype, device=src.device)
    src_c = torch.where(src_valid[..., None], src - cen_s[:, None], zero)
    tgt_c = torch.where(tgt_valid[..., None], tgt - cen_t[:, None], zero)
    radius = torch.maximum(cuda_prep.radius(src, cen_s, n_src),
                           cuda_prep.radius(tgt, cen_t, n_tgt))
    if cfg.use_absolute_scale:
        # points stay in metric units, mu starts at the global max radius
        scale = torch.ones_like(radius)
        mu = radius
    else:
        scale = torch.clamp_min(radius, 1e-30)
        src_c = src_c / scale[:, None, None]
        tgt_c = tgt_c / scale[:, None, None]
        mu = torch.ones_like(radius)                # normalised StartScale
    if probe is not None:
        probe["centring"] = (cen_s, cen_t, scale)
        probe["gn"] = []

    p = src_c.unbind(-1)                                     # 3 x [B,Ns]
    q = torch.gather(tgt_c, 1, fwd[..., None].expand(-1, -1, 3)).unbind(-1)
    # T as per-pair components [B,1]: R[i][j], t[i]
    one, nil = torch.ones_like(radius)[:, None], torch.zeros_like(
        radius)[:, None]
    R = [[one if i == j else nil for j in range(3)] for i in range(3)]
    t = [nil, nil, nil]
    for itr in range(cfg.iteration_number):
        if cfg.decrease_mu and itr % 4 == 0:
            mu = torch.where(mu > cfg.maximum_correspondence_distance,
                             mu / cfg.division_factor, mu)
        pm = [((R[i][0] * p[0] + R[i][1] * p[1]) + R[i][2] * p[2]) + t[i]
              for i in range(3)]
        r3 = [pm[i] - q[i] for i in range(3)]
        r2 = (r3[0] * r3[0] + r3[1] * r3[1]) + r3[2] * r3[2]
        w = corr_w * (mu[:, None] / (mu[:, None] + r2)) ** 2
        A, rhs = _normal_equations(pm, r3, w, n_src)
        if probe is not None:
            probe["gn"].append((A, -torch.stack(rhs, -1)))
        dR, dt = _solve_retract(A, rhs)
        R = [[(dR[i][0] * R[0][j] + dR[i][1] * R[1][j]) + dR[i][2] * R[2][j]
              for j in range(3)] for i in range(3)]
        t = [((dR[i][0] * t[0] + dR[i][1] * t[1]) + dR[i][2] * t[2])
             + dt[i] for i in range(3)]

    # denormalise: x' = R(x - cen_s)/scale + t
    #   => original: R x + (scale t - R cen_s + cen_t)
    c = cen_s.unbind(-1)
    t_orig = [(scale * t[i][:, 0]
               - ((R[i][0][:, 0] * c[0] + R[i][1][:, 0] * c[1])
                  + R[i][2][:, 0] * c[2])) + cen_t[:, i] for i in range(3)]
    T_out = se3.rt_to_T(
        torch.stack([torch.cat(row, -1) for row in R], -2),
        torch.stack(t_orig, -1))
    # degenerate correspondence sets fall back to the identity
    ok = kept >= 3
    return (torch.where(ok[:, None, None], T_out,
                        torch.eye(4, dtype=dtype, device=src.device)),
            recip.sum(-1), kept)


def program_body(inp: dict, cfg: FGRConfig, probe=None):
    """The whole of FGR on the buffers ``inp`` (``src``, ``n_src``,
    ``tgt``, ``n_tgt`` and, with the tuple test, ``raw``), reading
    nothing back: (T, iters, pure_iters, reciprocal [B], kept [B]).  The
    eager function runs it as it stands; on the card
    ``models/program.run_fgr`` captures it.  ``probe`` (optional dict)
    receives the features (``features``), the matches (``matches``) and
    the stages of ``_register_from_matches``."""
    src, n_src, tgt, n_tgt = inp["src"], inp["n_src"], inp["tgt"], \
        inp["n_tgt"]
    stages = [] if probe is not None else None
    feat_s = features(src, n_src, cfg, stages)
    feat_t = features(tgt, n_tgt, cfg, stages)
    fwd, bwd = reciprocal_matches(feat_s, n_src, feat_t, n_tgt)
    if probe is not None:
        probe["features"] = (feat_s, feat_t)
        probe["feature_stages"] = stages
        probe["matches"] = (fwd, bwd)
    del feat_s, feat_t
    T, recip, kept = _register_from_matches(src, n_src, tgt, n_tgt, fwd,
                                            bwd, cfg, inp.get("raw"), probe)
    iters = torch.full((src.shape[0],), cfg.iteration_number,
                       dtype=torch.int32, device=src.device)
    return T, iters, torch.zeros_like(iters), recip, kept


def fgr_register_arrays(src, n_src, tgt, n_tgt, cfg: FGRConfig,
                        raw=None, stats: dict | None = None):
    """FGR of a batch of padded pairs on the tensors' device, eagerly:
    the CPU's route, and on the card the reference of the captured
    program (``dispatch_arrays``).

    src [B,Ns,3], n_src [B], tgt [B,Nt,3], n_tgt [B].  Returns (T
    [B,4,4], iters [B], pure_iters [B]) with the contract of
    ``registration.register_arrays`` (iters = ``iteration_number``,
    pure_iters 0).  ``raw``: the tuple test's random integers (see
    ``raw_triples``).  ``stats`` (optional dict) receives the per-pair
    reciprocal-set sizes (``reciprocal``) and correspondences kept by the
    tuple test (``kept_correspondences``)."""
    inp = dict(src=src, n_src=n_src, tgt=tgt, n_tgt=n_tgt)
    if cfg.tuple_test:
        inp["raw"] = raw_triples(cfg, src.device) if raw is None else raw
    with torch.no_grad(), knn.full_precision():
        T, iters, pure, recip, kept = program_body(inp, cfg)
    if stats is not None:
        stats["reciprocal"] = recip.tolist()
        stats["kept_correspondences"] = kept.tolist()
    return T, iters, pure


def dispatch_arrays(src, n_src, tgt, n_tgt, cfg: FGRConfig, raw=None,
                    stats: dict | None = None):
    """``fgr_register_arrays`` without waiting for the card: on the card
    the captured program (``models/program.run_fgr``), on the CPU the
    eager function.  Returns a ``registration.Dispatched``."""
    from se3_icp_tpu_torch.models import registration as reg
    if src.device.type == "cuda":
        from se3_icp_tpu_torch.models import program
        return program.run_fgr(src, n_src, tgt, n_tgt, cfg, raw, stats)
    return reg.Dispatched(fgr_register_arrays(src, n_src, tgt, n_tgt, cfg,
                                              raw, stats))


def fgr_register(source_points, target_points,
                 cfg: FGRConfig | None = None, dtype=torch.float32,
                 device="cuda"):
    """Host-facing FGR of one pair (``RegistrationResult`` contract).
    Runs on the card (the captured program) unless ``device='cpu'``."""
    from se3_icp_tpu_torch.models.registration import (RegistrationResult,
                                                       _bucket,
                                                       resolve_device,
                                                       sanitize_cloud)
    dev = resolve_device(device)
    cfg = cfg or FGRConfig()
    # drop non-finite rows: one NaN point would poison the kNN distances,
    # normals and FPFH features
    src = sanitize_cloud(source_points)
    tgt = sanitize_cloud(target_points)
    ns, nt = len(src), len(tgt)
    src_p = np.zeros((1, _bucket(ns), 3))
    src_p[0, :ns] = src
    tgt_p = np.zeros((1, _bucket(nt), 3))
    tgt_p[0, :nt] = tgt
    T, it, pure = dispatch_arrays(
        torch.as_tensor(src_p, dtype=dtype, device=dev),
        torch.tensor([ns], dtype=torch.int32, device=dev),
        torch.as_tensor(tgt_p, dtype=dtype, device=dev),
        torch.tensor([nt], dtype=torch.int32, device=dev), cfg).settle()
    return RegistrationResult(T[0].double().cpu().numpy(), int(it[0]),
                              int(pure[0]))
