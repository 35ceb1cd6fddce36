"""The SE(3)-ICP registration engine, natively batched over pairs.

One program for the reference's four ``run_*`` methods, selected by
(mode, variant):

  mode='icp'      -> run_icp
  mode='se3'      -> run_se3_icp
  mode='se3_cf'   -> run_se3_icp_with_cf
  mode='se3_pure' -> run_se3_pure

Mechanics:
  * clouds are padded to bucket sizes with per-pair valid counts; the
    SE(3) modes centre and scale them first (G4, ``ops/cuda_prep.py``),
    in one order of each pair's own rows, so no bit of a pair's result
    follows the batch it is registered in;
  * the SE(3)->R3 "switch to vanilla ICP" annealing is not a branch:
    both phases run through the SAME 12-D match kernel, with the
    rotation block of the query/target embeddings zeroed after the
    switch (which reduces the 12-D chordal metric exactly to the 3-D
    euclidean one), so pairs of one batch may be in different phases;
  * setup: by default the sort-free threshold route the JAX package
    takes on its accelerator -- one threshold kernel call per cloud
    (``ops/cuda_moments.py``, K1) gives every consumer (TOLDI k, normals
    30, GICP 20) its ball, and the frames, normals and covariances are
    sums over those balls (K2, K3, and the glue kernels G1, G2 of
    ``ops/cuda_frames.py`` around them);
    ``exact_knn=True`` takes ONE exact sorted kNN per cloud instead,
    prefix-sliced by every consumer; SHOT frames (``lrf_method="shot"``)
    always take that route, with their own radius neighbourhoods;
  * each iteration is three hand-written kernels -- the fused match
    (``ops/cuda_knn.py``), the fused epilogue (``ops/cuda_loop.py``) and
    the step (``ops/cuda_step.py``: the 6x6 solve or pt2pt's Kabsch
    rotation, no SVD, the tests, the masked update and the next step's
    operands) --; with ``anderson_m`` >= 2 the step after the epilogue
    is torch glue around an Anderson-accelerated step in se(3) twist
    coordinates (``torch_glue_loop_step``, ``anderson_step``);
  * every state update is masked by a per-pair ``done`` flag, so a step
    after a pair converged is a no-op for it.  On the card the whole
    registration -- setup, loop, back to original coordinates -- runs
    as one captured CUDA graph (``models/program.py``) whose groups of
    ``_POLL_EVERY`` steps sit in conditional nodes that stop on the
    device once every pair is done: no host sync between upload and
    download.  The eager loop (``run_loop``: the same ``loop_step``,
    with the host reading ``done.all()`` every ``_POLL_EVERY`` steps) is
    the CPU route and the captured program's reference
    (``register_arrays_eager``);
  * float hyperparameters travel as one device vector (``split_cfg``,
    ``Hyper``), so one captured program serves every value of a sweep;
  * the points route (``group``: a ``torch.distributed`` process group,
    driven by ``parallel/points.py``) shards ONE registration's rows over
    the group's ranks while both clouds stay replicated.  Setup runs the
    neighbourhood kernels (K1-K3, or the exact route's kNN and dense
    reductions) on this rank's contiguous row slice and all-gathers the
    frames, normals and covariances to full rows; every step runs K4 on
    the rank's slice of ``feat16`` and all-gathers the matched payload
    rows.  Deviation from the JAX package, on purpose: K5 then runs
    replicated on the full rows (the JAX package's points route turns
    its fused epilogue off and takes its XLA epilogue), so the route
    keeps the unsharded bits and the exact-count trim, and every rank
    reaches the same stop decision, which the collectives need.  On an
    NCCL group the route is a captured program too, its all_gathers
    inside the graph (``models/program.py``); on a gloo group (the CPU)
    it runs the eager polled loop.

Behavioural parity notes, all reproduced:
  * the 12-D match uses alpha/beta-weighted frames, but trimming/MSE use
    the R3 translation distance;
  * with_cf solves with confidence *weights* only, and weights multiply
    the GICP whitening matrix, so they act quadratically;
  * with_cf packs the *unweighted* target points as the 12-D translation
    rows vs the beta-weighted ones in run_se3_icp;
  * post-switch convergence compares against ``scaling * mse`` while
    vanilla ICP uses plain ``mse``;
  * "MSE" is a mean of (non-squared) distances, and with_cf recomputes
    euclidean point distances instead.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from se3_icp_tpu_torch.ops import (cuda_knn, cuda_loop, cuda_moments,
                                   cuda_prep, cuda_step, knn, lrf, solve)
from se3_icp_tpu_torch.utils import se3
from se3_icp_tpu_torch.utils.config import (RegistrationConfig,
                                            parse_algorithm)

_BIG = 1e7  # the reference initializes its mse trackers to 1e7
_POLL_EVERY = 4

# Float hyperparameters read as ONE vector (the JAX package's
# ``split_cfg``), so a sweep over them (the alpha grid) reuses one
# captured program.  Fields that shape the work -- the k's, the caps,
# whether overlap trims, GICP's epsilon -- stay in the static config.
_TRACED_FIELDS = ("alpha_rot", "beta_transl", "scale_preprocessing", "mse",
                  "mse_switch_error", "estimated_overlap")


@dataclass
class Hyper:
    """The traced hyperparameters: 0-dim views of one vector on the
    batch's device, in its dtype.  A ``Hyper`` of the same values as
    Python floats gives the same bits (the tests hold it so)."""

    alpha_rot: torch.Tensor
    beta_transl: torch.Tensor
    scale_preprocessing: torch.Tensor
    mse: torch.Tensor
    mse_switch_error: torch.Tensor
    estimated_overlap: torch.Tensor


def split_cfg(cfg: RegistrationConfig, dtype, device):
    """(float vector [6] of ``_TRACED_FIELDS`` on ``device``, static
    config): the static config has those fields zeroed, but for
    ``estimated_overlap``, which keeps only whether it trims (0.0 if it
    does, 1.0 if not)."""
    floats = torch.tensor(traced_values(cfg), dtype=dtype)
    if torch.device(device).type == "cuda":     # no pageable, synced copy
        floats = floats.pin_memory().to(device, non_blocking=True)
    return floats, static_cfg(cfg)


def traced_values(cfg: RegistrationConfig) -> list:
    return [float(getattr(cfg, f)) for f in _TRACED_FIELDS]


def static_cfg(cfg: RegistrationConfig) -> RegistrationConfig:
    """``cfg`` without its traced values (see ``split_cfg``)."""
    zero = {f: 0.0 for f in _TRACED_FIELDS}
    zero["estimated_overlap"] = 0.0 if cfg.estimated_overlap < 1.0 else 1.0
    return cfg.replace(**zero)


def hyper(floats: torch.Tensor) -> Hyper:
    return Hyper(*floats.unbind(0))


@dataclass
class RegistrationResult:
    """Host-side result mirroring the reference's public outputs
    (``current_estimated_T_``, ``num_iterations_``,
    ``num_pure_se3_iterations_``)."""

    transformation: np.ndarray          # [4,4]
    num_iterations: int
    num_pure_se3_iterations: int
    # per-iteration accumulated transforms (``estimated_history_``);
    # filled when record_history=True
    history: np.ndarray | None = None   # [num_iterations,4,4]


@dataclass
class MatchState:
    """Everything the iteration loop needs, built once in setup (or from
    another package's setup products, see ``utils/convert.py``)."""

    feat16: torch.Tensor                # [B,Ns,16] static query features
    targets: cuda_knn.MatchTargets      # dual-phase targets + payload
    src_cT: torch.Tensor                # [B,3,Ns] centred+scaled source
    n_src: torch.Tensor                 # [B] integer valid source counts
    variant: str                        # effective: pt2pt | pt2pl | gicp
    is_se3: bool
    use_cf: bool
    pay_off: dict = field(default_factory=dict)   # payload row offsets
    cov_src6: torch.Tensor | None = None          # [B,6,Ns] (gicp)
    conf_src: torch.Tensor | None = None          # [B,Ns]   (with_cf)
    # the points route: its process group and this rank's rows of feat16
    group: object = None
    feat16_rows: torch.Tensor | None = None       # [B,Ns/world,16]


@dataclass
class Preprocess:
    """Centre + scale applied before the loop (identity for icp)."""

    cen_s: torch.Tensor                 # [B,3]
    cen_t: torch.Tensor                 # [B,3]
    scaling: torch.Tensor               # [B]


def resolve_device(device) -> torch.device:
    """The entry points run on the card unless the caller asks for the
    CPU; asking for the card without one raises (no silent CPU run)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "se3_icp_tpu_torch runs on a CUDA device by default and none "
            "is available; pass device='cpu' to run the plain versions")
    return dev


def lounge_point_confidence(points: torch.Tensor) -> torch.Tensor:
    """Depth-based RGB-D confidence (from LSG-CPD), [...,3] -> [...].

    conf = (p1*min_d + p2*min_d + p3) / (p1*d^2 + p2*d + p3); the
    numerator uses min_depth linearly in the quadratic term too -- that
    is what the reference computes; kept verbatim."""
    d = points[..., 2]
    p1, p2, p3, min_d = 0.002203, -0.001028, 0.0005351, 0.4
    err = p1 * d * d + p2 * d + p3
    return (p1 * min_d + p2 * min_d + p3) / err


def _embed12(rot, trans):
    """[B,N,3,3] frame rotations (columns x,y,z) + [B,N,3] translations
    -> [B,N,12] column-major flattening (the reference's layout)."""
    cols = rot.mT.flatten(2)                      # c1,c2,c3 stacked
    return torch.cat([cols, trans], dim=-1)


def preprocess(src, n_src, tgt, n_tgt, cfg: RegistrationConfig, is_se3,
               h: Hyper):
    """Centre each cloud at its own centroid and scale both by
    s = scale_preprocessing / max_radius; padded rows go to 0.  The SE(3)
    modes take G4 (``cuda_prep.center_scale``): its sums run in one order
    that depends on each pair's valid count alone, so a pair's bits do
    not follow its batch."""
    if is_se3:
        src_c, tgt_c, cen_s, cen_t, scaling = cuda_prep.center_scale(
            src, n_src, tgt, n_tgt, h.scale_preprocessing)
        return src_c, tgt_c, Preprocess(cen_s, cen_t, scaling)
    dtype = src.dtype
    bsz = src.shape[0]
    src_valid = torch.arange(src.shape[1], device=src.device) < n_src[:, None]
    tgt_valid = torch.arange(tgt.shape[1], device=src.device) < n_tgt[:, None]
    cen_s = torch.zeros((bsz, 3), dtype=dtype, device=src.device)
    cen_t = torch.zeros_like(cen_s)
    scaling = torch.ones(bsz, dtype=dtype, device=src.device)
    src_c = torch.where(src_valid[..., None], src, torch.zeros_like(src))
    tgt_c = torch.where(tgt_valid[..., None], tgt, torch.zeros_like(tgt))
    return src_c, tgt_c, Preprocess(cen_s, cen_t, scaling)


def pack_match_state(src_c, tgt_c, n_src, n_tgt, cfg, mode, variant, *,
                     h: Hyper, rot_src=None, rot_tgt=None, tgt_normals=None,
                     cov_src6=None, cov_tgt6=None, conf_src=None,
                     conf_tgt=None) -> MatchState:
    """Pack the setup products into the loop's layouts: the dual-phase
    12-D target embeddings, the per-target payload (everything the loop
    body needs FROM the matched target row, so it never gathers), and
    the static ``feat16`` query features.

    src_c/tgt_c [B,N,3] centred+scaled clouds; rot_* [B,N,3,3] frames
    (SE(3) modes); tgt_normals [B,Nt,3] (pt2pl); cov_*6 [B,6,N] (gicp);
    conf_* [B,N] (with_cf)."""
    dtype = src_c.dtype
    bsz, ns, _ = src_c.shape
    nt = tgt_c.shape[1]
    is_se3 = mode != "icp"
    use_cf = mode == "se3_cf"
    eff_variant = "gicp" if use_cf else variant
    dev = src_c.device
    zeros_rot = torch.zeros((bsz, nt, 3, 3), dtype=dtype, device=dev)
    # phase-B target embedding: zero rotation block + raw points == plain
    # 3-D euclidean NN through the same kernel
    tgt_embed_B = _embed12(zeros_rot, tgt_c)
    pay_parts, pay_off, off = [tgt_c], {"tgt_c": 0}, 3

    def pay_add(name, arr, width):
        nonlocal off
        pay_parts.append(arr)
        pay_off[name] = off
        off += width

    if is_se3:
        # rotation block alpha-weighted; translation rows are
        # beta-weighted points for run_se3_icp / run_se3_pure but the
        # RAW centred+scaled points for with_cf (reference quirk)
        tgt_tr_A = tgt_c if use_cf else tgt_c * h.beta_transl
        tgt_embed_A = _embed12(rot_tgt * h.alpha_rot, tgt_tr_A)
        # beta-weighted target translations: phase-A trim distance
        pay_add("tr_beta", tgt_c * h.beta_transl, 3)
        feat9 = rot_src.mT.flatten(2)
    else:
        tgt_embed_A = tgt_embed_B
        feat9 = torch.zeros((bsz, ns, 9), dtype=dtype, device=dev)
    if eff_variant == "pt2pl":
        pay_add("normals", tgt_normals, 3)
    elif eff_variant == "gicp":
        pay_add("cov", cov_tgt6.mT, 6)
        if use_cf:
            pay_add("conf_t", conf_tgt[..., None], 1)
    payload = torch.cat(pay_parts, dim=-1)                   # [B,Nt,P]
    targets = cuda_knn.pack_match_targets(tgt_embed_A, tgt_embed_B,
                                          payload, n_tgt)
    # q = feat @ W is affine in [F^T(9) | s(3) | 1], with R/t/alpha/
    # beta/phase folded into a [16,16] matrix built in the loop body
    feat16 = torch.cat(
        [feat9, src_c, torch.ones((bsz, ns, 1), dtype=dtype, device=dev),
         torch.zeros((bsz, ns, 3), dtype=dtype, device=dev)], dim=-1)
    return MatchState(
        feat16=feat16.contiguous(), targets=targets,
        src_cT=src_c.mT.contiguous(), n_src=n_src, variant=eff_variant,
        is_se3=is_se3, use_cf=use_cf, pay_off=pay_off,
        cov_src6=(cov_src6.contiguous() if eff_variant == "gicp" else None),
        conf_src=(conf_src.contiguous() if use_cf else None))


def _count_sets(cfg: RegistrationConfig, is_se3: bool, need_tgt_nrm: bool,
                need_cov: bool):
    """The threshold route's self-inclusive counts per cloud, unique and
    DESCENDING (the order K1's chained brackets want): TOLDI {k//3,
    k//3+1, k}, plus the pt2pl normals' count on the target and the GICP
    normals' count on both."""
    k = cfg.number_of_nn_for_lrf if is_se3 else 0
    lrf_counts = [k // 3, k // 3 + 1, k] if k else []
    gicp = [cfg.gicp_normals_knn] if need_cov else []
    src = sorted(set(lrf_counts + gicp), reverse=True)
    tgt = sorted(set(lrf_counts + ([cfg.normals_knn] if need_tgt_nrm
                                   else []) + gicp), reverse=True)
    return src, tgt


def _const(values, dtype, device) -> torch.Tensor:
    """A small constant vector made on ``device`` by fills: no copy from
    the host, which a graph capture could not hold."""
    out = torch.empty(len(values), dtype=dtype, device=device)
    for i, v in enumerate(values):
        out.narrow(0, i, 1).fill_(v)
    return out


def check_group(group, device) -> None:
    """The points route's process group fits the tensors' device: NCCL
    for CUDA tensors, gloo for CPU ones.  Nothing falls back."""
    import torch.distributed as dist
    backend = dist.get_backend(group)
    want = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if backend != want:
        raise ValueError(
            f"the points route on '{device}' tensors needs a {want} process "
            f"group; this one is {backend}")


def group_rows(group, n: int):
    """This rank's contiguous rows (r0, r1) of an n-row cloud sharded
    over ``group``, or None without a group.  n must divide by the
    group's size."""
    if group is None:
        return None
    import torch.distributed as dist
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    if n % world:
        raise ValueError(f"padded cloud size {n} must be divisible by the "
                         f"points group's size {world}")
    c = n // world
    return rank * c, (rank + 1) * c


def gather_rows(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``x`` (its rows along ``dim``), concatenated in rank
    order: one all_gather over ``group``; ``x`` itself without one."""
    if group is None:
        return x
    import torch.distributed as dist
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim)


def _thresholds(points, n_valid, counts, rows=None):
    """(SetupCloud, {count: thr [B,C]}) of one cloud's rows ``rows``
    (all: C = N), or (None, {})."""
    if not counts:
        return None, {}
    cloud = cuda_moments.setup_cloud(points, n_valid)
    cc = _const(counts, torch.int64, points.device)
    thr = cuda_moments.neighborhood_thresholds_batched(
        points, n_valid, cc.expand(points.shape[0], -1), cloud=cloud,
        rows=rows)
    return cloud, {c: thr[:, i] for i, c in enumerate(counts)}


def _setup_thr(src_c, n_src, tgt_c, n_tgt, cfg, is_se3, need_tgt_nrm,
               need_cov, group=None):
    """The sort-free threshold setup (the JAX package's accelerator
    route): one K1 call per cloud, then the frames (K2 + K3, with the
    pt2pl normals fused into the target's K2 pass when normals_knn ==
    k//3), normals and covariances (K2).  Kernels in float32, glue in
    the caller's dtype.  With a points ``group`` every kernel runs on
    this rank's rows and the products are all-gathered to full rows."""
    rows_s = group_rows(group, src_c.shape[1])
    rows_t = group_rows(group, tgt_c.shape[1])
    cu_src, cu_tgt = _count_sets(cfg, is_se3, need_tgt_nrm, need_cov)
    cloud_s, thr_s = _thresholds(src_c, n_src, cu_src, rows_s)
    cloud_t, thr_t = _thresholds(tgt_c, n_tgt, cu_tgt, rows_t)
    out = dict(rot_src=None, rot_tgt=None, tgt_normals=None, cov_src6=None,
               cov_tgt6=None)
    k = cfg.number_of_nn_for_lrf
    rz = k // 3
    nrm_t = None
    if is_se3:
        # the frames point-major ([B,N,9]), the layout the packing reads
        _, fr_s = lrf.toldi_frames_thr_t(
            src_c, thr_s[rz], thr_s[rz + 1], thr_s[k], k, n_src,
            cloud=cloud_s, rows=rows_s, point_major=True)
        out["rot_src"] = lrf.frames_to_rot(gather_rows(fr_s, group, 1))
        fuse = need_tgt_nrm and cfg.normals_knn == rz
        rows_tt, fr_t = lrf.toldi_frames_thr_t(
            tgt_c, thr_t[rz], thr_t[rz + 1], thr_t[k], k, n_tgt,
            cloud=cloud_t, normals_k=cfg.normals_knn if fuse else None,
            rows=rows_t, point_major=True)
        out["rot_tgt"] = lrf.frames_to_rot(gather_rows(fr_t, group, 1))
        if fuse:
            nrm_t = gather_rows(rows_tt[:, 9:12], group, 2)
    if need_tgt_nrm:
        if nrm_t is None:
            nrm_t = gather_rows(lrf.normals_thr_t(
                tgt_c, thr_t[cfg.normals_knn], cfg.normals_knn, n_tgt,
                cloud=cloud_t, rows=rows_t), group, 2)
        out["tgt_normals"] = nrm_t.mT
    elif need_cov:
        kg = cfg.gicp_normals_knn
        out["cov_src6"] = gather_rows(lrf.gicp_covariances_thr_t(
            src_c, thr_s[kg], kg, cfg.gicp_epsilon, n_src, cloud=cloud_s,
            rows=rows_s), group, 2)
        out["cov_tgt6"] = gather_rows(lrf.gicp_covariances_thr_t(
            tgt_c, thr_t[kg], kg, cfg.gicp_epsilon, n_tgt, cloud=cloud_t,
            rows=rows_t), group, 2)
    return out


def _shot_frames(points, n_valid, cfg):
    """SHOT frames of one cloud: exact radius semantics, or capped at
    ``shot_max_k`` neighbours (``shot_exact=False``)."""
    if cfg.shot_exact:
        return lrf.shot_frames_dense(points, cfg.lrf_radius, n_valid)
    return lrf.shot_frames(points, cfg.lrf_radius, n_valid,
                           max_k=cfg.shot_max_k)


def _knn_rows(points, k: int, n_valid, rows):
    """Sorted squared distances [B,C,k] of the rows ``rows`` (all: the
    cloud's self kNN) against the whole cloud."""
    if rows is None:
        return knn.knn_self(points, k, n_valid)[1]
    return knn.knn_topk(points[:, rows[0]:rows[1]], points, k, n_valid)[1]


def _setup_exact(src_c, n_src, tgt_c, n_tgt, cfg, is_se3, need_tgt_nrm,
                 need_cov, group=None):
    """The exact sorted-kNN setup: ONE sorted kNN per cloud,
    prefix-sliced by every consumer (TOLDI k, normals, GICP).  SHOT
    frames take their own radius neighbourhoods, so they add nothing to
    the kNN's width.  With a points ``group`` the kNN and the TOLDI,
    normal and covariance reductions run on this rank's rows and their
    products are all-gathered; SHOT frames run whole on every rank (as
    in the JAX package)."""
    rows_s = group_rows(group, src_c.shape[1])
    rows_t = group_rows(group, tgt_c.shape[1])
    shot = is_se3 and cfg.lrf_method != "toldi"
    k_lrf = cfg.number_of_nn_for_lrf if is_se3 and not shot else 0
    k_src = max(k_lrf, cfg.gicp_normals_knn if need_cov else 0)
    k_tgt = max(k_lrf, cfg.normals_knn if need_tgt_nrm else 0,
                cfg.gicp_normals_knn if need_cov else 0)
    # +1 column: rank sets are recovered from midpoint thresholds, which
    # needs the first EXCLUDED order statistic too
    d2_src = d2_tgt = None
    if k_src:
        d2_src = _knn_rows(src_c, k_src + 1, n_src, rows_s)
    if k_tgt:
        d2_tgt = _knn_rows(tgt_c, k_tgt + 1, n_tgt, rows_t)
    out = dict(rot_src=None, rot_tgt=None, tgt_normals=None, cov_src6=None,
               cov_tgt6=None)
    if shot:
        out["rot_src"] = _shot_frames(src_c, n_src, cfg)
        out["rot_tgt"] = _shot_frames(tgt_c, n_tgt, cfg)
    elif is_se3:
        out["rot_src"] = gather_rows(lrf.toldi_frames_dense(
            src_c, d2_src[..., :k_lrf], n_src, rows=rows_s), group, 1)
        out["rot_tgt"] = gather_rows(lrf.toldi_frames_dense(
            tgt_c, d2_tgt[..., :k_lrf], n_tgt, rows=rows_t), group, 1)
    if need_tgt_nrm:
        out["tgt_normals"] = gather_rows(lrf.normals_dense(
            tgt_c, d2_tgt, cfg.normals_knn, n_tgt, rows=rows_t), group, 1)
    elif need_cov:
        out["cov_src6"] = gather_rows(lrf._sym_to_6(
            lrf.gicp_covariances_dense(src_c, d2_src, cfg.gicp_normals_knn,
                                       cfg.gicp_epsilon, n_src, rows_s)),
            group, 2)
        out["cov_tgt6"] = gather_rows(lrf._sym_to_6(
            lrf.gicp_covariances_dense(tgt_c, d2_tgt, cfg.gicp_normals_knn,
                                       cfg.gicp_epsilon, n_tgt, rows_t)),
            group, 2)
    return out


def setup(src, n_src, tgt, n_tgt, cfg: RegistrationConfig, mode: str,
          variant: str, h: Hyper, exact_knn: bool = False, group=None):
    """Everything before the loop: confidences, preprocessing, the
    neighbourhood setup (frames, normals, covariances) and the packing.

    The neighbourhoods come from the sort-free threshold setup (K1-K3,
    the route the JAX package takes on its accelerator) unless
    ``exact_knn``, which takes the exact sorted kNN instead (the JAX
    package's ``SE3_ICP_TPU_EXACT_KNN=1``).  SHOT frames
    (``lrf_method="shot"``) always take the exact route, whatever
    ``exact_knn`` says, as the JAX package turns its threshold route off
    for them (any ``lrf_method`` but ``"toldi"`` is SHOT there).  ``h``:
    the traced hyperparameters (``split_cfg``, ``hyper``).  ``group``: a
    process group for the points route (see the module docstring); both
    padded widths must divide by its size, else ``ValueError``.  Returns
    (MatchState, Preprocess)."""
    if group is not None:
        check_group(group, src.device)
        group_rows(group, src.shape[1])
        group_rows(group, tgt.shape[1])
    is_se3 = mode != "icp"
    use_cf = mode == "se3_cf"
    eff_variant = "gicp" if use_cf else variant
    conf_src = conf_tgt = None
    if use_cf:  # on ORIGINAL coordinates
        conf_src = lounge_point_confidence(src)
        conf_tgt = lounge_point_confidence(tgt)
    src_c, tgt_c, pre = preprocess(src, n_src, tgt, n_tgt, cfg, is_se3, h)
    shot = is_se3 and cfg.lrf_method != "toldi"
    route = _setup_exact if exact_knn or shot else _setup_thr
    prod = route(src_c, n_src, tgt_c, n_tgt, cfg, is_se3,
                 eff_variant == "pt2pl", eff_variant == "gicp", group)
    state = pack_match_state(
        src_c, tgt_c, n_src, n_tgt, cfg, mode, variant, conf_src=conf_src,
        conf_tgt=conf_tgt, h=h, **prod)
    if group is not None:
        r0, r1 = group_rows(group, src.shape[1])
        state.group = group
        state.feat16_rows = state.feat16[:, r0:r1].contiguous()
    return state, pre


def setup_checksum(ms: MatchState, h: Hyper) -> torch.Tensor:
    """[B] per-pair checksum of the pre-loop tensors the JAX package's
    setup-only program sums (its ``registration.py:566-580`` on its
    unpacked route): the payload, the phase-B target embedding and, for
    the SE(3) modes, the alpha-weighted source frames and the phase-A
    embedding.  Each pair's sums are taken on its own slices, so a pair's
    checksum has the same bits in any batch."""
    emb = ms.targets.emb
    out = []
    for b in range(emb.shape[0]):
        chk = ms.targets.payload[b].sum() + emb[b, 1].sum()
        if ms.is_se3:
            chk = chk + (ms.feat16[b, :, :9] * h.alpha_rot).sum() \
                + emb[b, 0].sum()
        out.append(chk)
    return torch.stack(out)


def epilogue_options(ms: MatchState, cfg: RegistrationConfig) -> dict:
    """The static arguments of ``loop_epilogue_batched`` for a state."""
    return dict(variant=ms.variant, is_se3=ms.is_se3, use_cf=ms.use_cf,
                do_trim=cfg.estimated_overlap < 1.0,
                off_tr=ms.pay_off.get("tr_beta", 0),
                off_nrm=ms.pay_off.get("normals", 0),
                off_cov=ms.pay_off.get("cov", 0),
                off_conf=ms.pay_off.get("conf_t", 0))


def iteration_inputs(ms: MatchState, cfg: RegistrationConfig, T, switched,
                     done, h: Hyper):
    """Per-iteration operands of the two kernels at pose T [B,4,4]:
    ``cuda_step.step_inputs_plain`` (W [B,16,16], ph2 [B,2] int32, pf
    [B,24]) from the config and ``Hyper`` of a loop."""
    dtype, dev = ms.feat16.dtype, ms.feat16.device
    hv = _scalars([getattr(h, f) for f in cuda_step.HV], dtype, dev)
    return cuda_step.step_inputs_plain(
        T, switched, done, hv, ms.n_src.to(dtype), is_se3=ms.is_se3,
        do_trim=cfg.estimated_overlap < 1.0)


@dataclass
class LoopState:
    """What one loop step reads and writes, per pair."""

    T: torch.Tensor               # [B,4,4] pose, preprocessed frame
    it: torch.Tensor              # [B] int32 iterations
    pure_it: torch.Tensor         # [B] int32 iterations before the switch
    mse_prev: torch.Tensor        # [B]
    mse_cur: torch.Tensor         # [B]
    switched: torch.Tensor        # [B] bool: in the R3 phase
    done: torch.Tensor            # [B] bool
    hist: torch.Tensor | None     # [B,H,4,4] per-iteration poses
    # Anderson acceleration's window (``anderson_m`` >= 2): past iterates
    # and fixed-point residuals in se(3) twist coordinates, the window's
    # fill and the last residual norm
    aa_X: torch.Tensor | None = None      # [B,m,6]
    aa_F: torch.Tensor | None = None      # [B,m,6]
    aa_n: torch.Tensor | None = None      # [B] int32
    aa_fprev: torch.Tensor | None = None  # [B]
    # the next step's kernel operands (``loop_inputs``), made by the
    # step before it (``cuda_step.step_update``); None with Anderson,
    # whose step makes its own
    W: torch.Tensor | None = None         # [B,16,16]
    ph2: torch.Tensor | None = None       # [B,2] int32
    pf: torch.Tensor | None = None        # [B,24]

    def tensors(self) -> list:
        return [t for t in (self.T, self.it, self.pure_it, self.mse_prev,
                            self.mse_cur, self.switched, self.done,
                            self.hist, self.aa_X, self.aa_F, self.aa_n,
                            self.aa_fprev) if t is not None]

    def buffers(self) -> list:
        """``tensors()`` and the next step's operands: everything a step
        carries to the next."""
        return self.tensors() + [t for t in (self.W, self.ph2, self.pf)
                                 if t is not None]


@dataclass
class LoopConsts:
    """What every step of one loop reads and never writes."""

    cfg: RegistrationConfig
    h: Hyper
    max_iters: int
    hybrid: bool
    hist_len: int                 # steps at most
    stop_thresh: torch.Tensor     # [B]
    ep_kw: dict                   # ``epilogue_options``
    ar: torch.Tensor              # [B] pair indices
    hv: torch.Tensor              # [4] ``cuda_step.HV`` of ``h``
    n_src_f: torch.Tensor         # [B] valid source counts as floats


def _scalars(values, dtype, device) -> torch.Tensor:
    """[len(values)]: 0-dim tensors (views of the traced vector) and
    Python floats as one vector, by device ops and fills only."""
    return torch.cat([v.reshape(1).to(dtype) if isinstance(v, torch.Tensor)
                      else torch.full((1,), v, dtype=dtype, device=device)
                      for v in values])


def init_loop(ms: MatchState, scaling: torch.Tensor,
              cfg: RegistrationConfig, mode: str, h: Hyper, T_init=None,
              record_history: bool = False):
    """(LoopState before the first step, LoopConsts) of the loop in the
    preprocessed frame."""
    dtype, dev = ms.feat16.dtype, ms.feat16.device
    bsz = ms.feat16.shape[0]
    # --- loop limits per mode
    if mode == "icp":
        start_switched = True       # R3 NN from the start, no SE3 phase
        max_iters = cfg.max_num_iterations
        stop_thresh = h.mse
    else:
        start_switched = False
        max_iters = (cfg.max_num_se3_iterations if mode == "se3_pure"
                     else cfg.max_num_iterations)
        stop_thresh = h.mse * scaling     # uses scaling * mse
    T = (torch.eye(4, dtype=dtype, device=dev).repeat(bsz, 1, 1)
         if T_init is None else T_init.clone())
    it = torch.zeros(bsz, dtype=torch.int32, device=dev)
    mse_cur = torch.full((bsz,), _BIG, dtype=dtype, device=dev)
    # +1: in hybrid mode the loop can run max(caps)+1 iterations (the
    # done test uses the pre-switch 'switched')
    hist_len = max(cfg.max_num_iterations, cfg.max_num_se3_iterations) + 1
    state = LoopState(
        T=T, it=it, pure_it=torch.zeros_like(it), mse_prev=mse_cur.clone(),
        mse_cur=mse_cur,
        switched=torch.full((bsz,), start_switched, dtype=torch.bool,
                            device=dev),
        done=torch.zeros(bsz, dtype=torch.bool, device=dev),
        hist=(torch.zeros((bsz, hist_len, 4, 4), dtype=dtype, device=dev)
              if record_history else None))
    if cfg.anderson_m:
        m = cfg.anderson_m
        state.aa_X = torch.zeros((bsz, m, 6), dtype=dtype, device=dev)
        state.aa_F = torch.zeros_like(state.aa_X)
        state.aa_n = torch.zeros_like(it)
        state.aa_fprev = mse_cur.clone()
    if not isinstance(stop_thresh, torch.Tensor) or stop_thresh.dim() == 0:
        stop_thresh = _scalars([stop_thresh], dtype, dev).expand(bsz)
    consts = LoopConsts(
        cfg=cfg, h=h, max_iters=max_iters, hybrid=mode in ("se3", "se3_cf"),
        hist_len=hist_len, stop_thresh=stop_thresh.contiguous(),
        ep_kw=epilogue_options(ms, cfg),
        ar=torch.arange(bsz, device=dev),
        hv=_scalars([getattr(h, f) for f in cuda_step.HV], dtype, dev),
        n_src_f=ms.n_src.to(dtype).contiguous())
    if not cfg.anderson_m:
        state.W, state.ph2, state.pf = (x.contiguous() for x in
                                        loop_inputs(state, ms, consts))
    return state, consts


def loop_inputs(s: LoopState, ms: MatchState, c: LoopConsts):
    """(W, ph2, pf) of the step at ``s`` (``cuda_step.
    step_inputs_plain``)."""
    return cuda_step.step_inputs_plain(
        s.T, s.switched, s.done, c.hv, c.n_src_f, is_se3=ms.is_se3,
        do_trim=c.ep_kw["do_trim"])


def _match_and_epilogue(s: LoopState, ms: MatchState, c: LoopConsts, W,
                        ph2, pf):
    """K4 at the step's operands, then K5: (A66, b8, st)."""
    if ms.group is None:
        _, matched_T = cuda_knn.nn_match_affine(ms.feat16, W, ms.targets,
                                                ph2)
    else:   # the points route: K4 on this rank's rows, then all rows
        _, matched_T = cuda_knn.nn_match_affine(ms.feat16_rows, W,
                                                ms.targets, ph2)
        matched_T = gather_rows(matched_T, ms.group, 2)
    return cuda_loop.loop_epilogue_batched(
        ms.src_cT, matched_T, pf, ms.cov_src6, ms.conf_src, **c.ep_kw)


def loop_step(s: LoopState, ms: MatchState, c: LoopConsts) -> LoopState:
    """One iteration for every pair: match (K4), epilogue (K5), then
    ``cuda_step.step_update`` (G3): the solve, the phase switch and stop
    tests, the done-masked update and the next step's operands.  A pure
    function of tensors that reads nothing back to the host, so a step
    after every pair is done changes nothing and any number of steps can
    be captured.  On the card the kernels update the state's tensors in
    place.  With ``anderson_m`` >= 2 the step takes the route of that
    option, decided from the config: ``torch_glue_loop_step``."""
    if c.cfg.anderson_m:
        return torch_glue_loop_step(s, ms, c)
    A66, b8, st = _match_and_epilogue(s, ms, c, s.W, s.ph2, s.pf)
    state = {k: getattr(s, k) for k in cuda_step.STATE + ("hist", "W",
                                                          "ph2", "pf")}
    out = cuda_step.step_update(
        A66, b8, st, state, c.hv, c.stop_thresh, c.n_src_f,
        variant=ms.variant, is_se3=ms.is_se3, hybrid=c.hybrid,
        do_trim=c.ep_kw["do_trim"], max_iters=c.max_iters,
        max_se3_iters=c.cfg.max_num_se3_iterations)
    return LoopState(**{k: out[k] for k in cuda_step.STATE + (
        "hist", "W", "ph2", "pf")})


def torch_glue_loop_step(s: LoopState, ms: MatchState,
                         c: LoopConsts) -> LoopState:
    """The loop step with its glue as torch ops: the operands from
    ``loop_inputs``, K4, K5, then ``torch_glue_update``.  The route
    of ``anderson_m`` >= 2 (the Anderson step and its window are torch
    ops around it); without Anderson, the step as the port ran it before
    ``cuda_step`` (``chip_smoke.py`` profiles it beside ``loop_step``)."""
    A66, b8, st = _match_and_epilogue(s, ms, c, *loop_inputs(s, ms, c))
    return torch_glue_update(s, A66, b8, st, ms, c)


def torch_glue_update(s: LoopState, A66, b8, st, ms: MatchState,
                      c: LoopConsts) -> LoopState:
    """The step after K5 as torch glue: the 6x6 solve
    (``solve.solve_from_normal``) or pt2pt's
    ``solve.solve_pt2pt_from_moments``, ``T_i @ T``, with ``anderson_m``
    >= 2 ``anderson_step``, the tests and the done-masked update, the
    window's included."""
    cfg = c.cfg
    it1 = s.it + 1
    mse_val, wsum = st[:, 0], st[:, 1]
    if ms.variant == "pt2pt":
        T_i = solve.solve_pt2pt_from_moments(
            A66[:, :3, :3], b8[:, 0:3], b8[:, 3:6], wsum)
    else:
        T_i = solve.solve_from_normal(A66, b8[:, :6], wsum)

    mse_rel = (mse_val - s.mse_cur).abs()
    T_new = T_i @ s.T
    aa = None
    if cfg.anderson_m:
        T_new, aa = anderson_step(s, T_new, cfg.anderson_m)
    t_change = torch.linalg.norm((s.T - T_new).flatten(1), dim=1)

    # --- phase switch / stopping
    stop = (it1 >= c.max_iters) | (mse_rel < c.stop_thresh)
    if c.hybrid:
        hit_switch = ((it1 >= cfg.max_num_se3_iterations)
                      | (t_change < c.h.mse_switch_error))
        new_switched = s.switched | hit_switch
        new_done = s.switched & stop
    else:
        new_switched = s.switched
        new_done = stop

    # --- done-masked state update
    active = ~s.done
    T = torch.where(active[:, None, None], T_new, s.T)
    hist = s.hist
    if hist is not None:
        # per-iteration accumulated transform; finished pairs write
        # their final T past their own num_iterations
        hist = hist.index_put(
            (c.ar, (it1 - 1).clamp(max=c.hist_len - 1).to(torch.int64)), T)
    out = LoopState(
        T=T, it=torch.where(active, it1, s.it),
        pure_it=torch.where(active & ~s.switched, s.pure_it + 1, s.pure_it),
        mse_prev=torch.where(active, s.mse_cur, s.mse_prev),
        mse_cur=torch.where(active, mse_val, s.mse_cur),
        switched=torch.where(active, new_switched, s.switched),
        done=s.done | new_done, hist=hist)
    if aa is not None:
        # the window restarts when the phase switches (a new fixed point)
        aa["aa_n"] = torch.where(new_switched != s.switched,
                                 torch.zeros_like(aa["aa_n"]), aa["aa_n"])
        for name, new in aa.items():
            old = getattr(s, name)
            keep = active.view((-1,) + (1,) * (old.dim() - 1))
            setattr(out, name, torch.where(keep, new, old))
    # this route makes its operands at each step's start: a caller's
    # carried ones go through as they are
    out.W, out.ph2, out.pf = s.W, s.ph2, s.pf
    return out


def anderson_step(s: LoopState, T_new: torch.Tensor, m: int):
    """Type-II Anderson acceleration of the fixed-point iteration
    T -> G(T) in se(3) twist coordinates (AA-ICP, Pavlov et al. 2017; an
    extension beyond the reference, the JAX package's loop body): a
    Tikhonov-regularised least squares over the window's residual
    differences.  The window restarts when the residual norm grows; the
    step is taken only in the R3 phase (the SE(3) phase's map changes as
    the frames re-weight).  Returns (T_new [B,4,4], the window's new
    values by LoopState field, before the done mask)."""
    dtype, dev = T_new.dtype, T_new.device
    xi_k = se3.se3_log(s.T)                                   # [B,6]
    g_k = se3.se3_log(T_new)
    f_k = g_k - xi_k
    fnorm = torch.linalg.norm(f_k, dim=-1)
    grew = fnorm > s.aa_fprev
    n_prev = torch.where(grew, torch.zeros_like(s.aa_n), s.aa_n)
    Xb = torch.cat([s.aa_X[:, 1:], xi_k[:, None]], 1)         # [B,m,6]
    Fb = torch.cat([s.aa_F[:, 1:], f_k[:, None]], 1)
    dX = Xb[:, 1:] - Xb[:, :-1]                               # [B,m-1,6]
    dF = Fb[:, 1:] - Fb[:, :-1]
    # only the last n_prev differences belong to the window
    ok_col = (torch.arange(m - 1, device=dev)[None]
              >= (m - 1) - n_prev[:, None]).to(dtype)[..., None]
    dFm = dF * ok_col
    dXm = dX * ok_col
    A = dFm @ dFm.mT                                          # [B,m-1,m-1]
    trace = A.diagonal(dim1=-2, dim2=-1).sum(-1)
    lam = 1e-10 * torch.clamp_min(trace, 1.0)
    A = A + (lam + 1e-30)[:, None, None] * torch.eye(m - 1, dtype=dtype,
                                                      device=dev)
    # solve_ex: no check of the result on the host, so a capture holds it
    gamma = torch.linalg.solve_ex(A, dFm @ f_k[..., None])[0]  # [B,m-1,1]
    xi_aa = g_k - (gamma.mT @ (dXm + dFm))[:, 0]
    use_aa = (s.switched & (n_prev >= 1) & ~grew
              & torch.isfinite(xi_aa).all(-1))
    T_new = torch.where(use_aa[:, None, None], se3.se3_exp(xi_aa), T_new)
    return T_new, dict(aa_X=Xb, aa_F=Fb,
                       aa_n=torch.clamp_max(n_prev + 1, m - 1),
                       aa_fprev=fnorm)


def run_loop(ms: MatchState, scaling: torch.Tensor,
             cfg: RegistrationConfig, mode: str, h: Hyper, T_init=None,
             record_history: bool = False, stats: dict | None = None):
    """The eager iteration loop in the preprocessed frame: ``loop_step``
    until every pair is done, the host reading ``done.all()`` every
    ``_POLL_EVERY`` steps (the extra steps are no-ops).

    Returns (T [B,4,4], it [B], pure_it [B], hist [B,H,4,4] | None).
    ``stats`` (optional dict) receives ``loop_steps`` and ``host_syncs``.
    """
    s, c = init_loop(ms, scaling, cfg, mode, h, T_init, record_history)
    steps = syncs = 0
    while steps < c.hist_len:
        s = loop_step(s, ms, c)
        steps += 1
        if steps % _POLL_EVERY == 0 and steps < c.hist_len:
            syncs += 1
            if bool(s.done.all()):      # the loop's only host sync
                break
    if stats is not None:
        stats["loop_steps"] = stats.get("loop_steps", 0) + steps
        stats["host_syncs"] = stats.get("host_syncs", 0) + syncs
    return s.T, s.it, s.pure_it, s.hist


def to_original(T, pre: Preprocess, is_se3: bool):
    """Map [B,(H,)4,4] transforms of the preprocessed frame back to
    original coordinates."""
    if not is_se3:
        return T
    extra = (None,) * (T.dim() - 3)
    cen_s = pre.cen_s[(slice(None),) + extra]
    cen_t = pre.cen_t[(slice(None),) + extra]
    sc = pre.scaling[(slice(None),) + extra]
    # t / s - R c_s + c_t component by component, the product's sums in
    # torch's order: no batched product, whose split follows the batch
    rc = _rot_times(T, cen_s)
    t_orig = [(T[..., i, 3] / sc - rc[i]) + cen_t[..., i] for i in range(3)]
    return _with_translation(T, t_orig)


def _rot_times(T, v) -> list:
    """[R v]_i = (R_i0 v_0 + R_i1 v_1) + R_i2 v_2 for the rotation block
    of T [...,4,4] and v [...,3], as three tensors of T's batch shape."""
    return [(T[..., i, 0] * v[..., 0] + T[..., i, 1] * v[..., 1])
            + T[..., i, 2] * v[..., 2] for i in range(3)]


def _with_translation(T, t: list) -> torch.Tensor:
    """[...,4,4]: T's rotation block, the translation ``t`` (three
    tensors), the last row (0, 0, 0, 1)."""
    out = torch.zeros_like(T)
    out[..., :3, :3] = T[..., :3, :3]
    out[..., :3, 3] = torch.stack(t, -1)
    out[..., 3, 3] = 1.0
    return out


def check_supported(cfg: RegistrationConfig) -> None:
    if cfg.anderson_m == 1:
        raise ValueError("anderson_m must be 0 (off) or >= 2 (window)")


def loop_route(device, mode: str, variant: str) -> str:
    """Which loop a registration takes: ``"graph"`` -- the captured
    program of ``models/program.py``, setup and loop as one CUDA graph
    that stops on the device -- on the card, for every mode and
    estimator; ``"eager"`` (``run_loop``, polled) on the CPU."""
    if torch.device(device).type != "cuda":
        return "eager"
    return "graph"


def warm_start(initial_T, pre: Preprocess, dtype):
    """``initial_T`` [B,4,4] of original coordinates in the loop's
    preprocessed frame: the inverse of ``to_original``."""
    T0 = initial_T.to(dtype)
    rc = _rot_times(T0, pre.cen_s)
    return _with_translation(T0, [
        ((T0[:, i, 3] + rc[i]) - pre.cen_t[:, i]) * pre.scaling
        for i in range(3)])


class Dispatched:
    """A registration's results while the device may still compute them:
    ``out`` = (T, it, pure_it[, hist]) on the device.  A captured
    program also leaves ``steps``, its device count of the loop steps it
    ran, and ``per_pair``, {stats key: [B] device tensor} (FGR's counts).
    ``settle`` reads them (or takes the values a caller fetched with the
    results), puts them in ``stats`` -- ``steps`` added to
    ``loop_steps`` with no host sync, ``per_pair`` as lists -- and
    returns ``out``."""

    def __init__(self, out: tuple, steps=None, stats: dict | None = None,
                 per_pair: dict | None = None):
        self.out, self.steps, self._stats = out, steps, stats
        self.per_pair = per_pair or {}

    def settle(self, steps: int | None = None,
               per_pair: dict | None = None) -> tuple:
        if self._stats is not None:
            if self.steps is not None:
                n = int(self.steps) if steps is None else int(steps)
                self._stats["loop_steps"] = (self._stats.get("loop_steps", 0)
                                             + n)
                self._stats["host_syncs"] = self._stats.get("host_syncs", 0)
            for key, val in self.per_pair.items():
                self._stats[key] = (val.tolist() if per_pair is None
                                    else per_pair[key])
            self._stats = None
        return self.out


def register_arrays_eager(src, n_src, tgt, n_tgt, cfg: RegistrationConfig,
                          mode: str, variant: str,
                          record_history: bool = False, initial_T=None,
                          stats: dict | None = None,
                          exact_knn: bool = False, group=None):
    """``register_arrays`` on the eager route on any device: setup, then
    ``run_loop`` polling every ``_POLL_EVERY`` steps.  The CPU's route;
    on the card the reference the captured program is held against, bit
    for bit.  ``group``: the points route over that process group (every
    rank calls this with the same arguments; see the module
    docstring)."""
    check_supported(cfg)
    is_se3 = mode != "icp"
    with torch.no_grad(), knn.full_precision():
        floats, scfg = split_cfg(cfg, src.dtype, src.device)
        h = hyper(floats)
        ms, pre = setup(src, n_src, tgt, n_tgt, scfg, mode, variant, h,
                        exact_knn, group)
        T_init = (None if initial_T is None
                  else warm_start(initial_T, pre, src.dtype))
        T, it, pure_it, hist = run_loop(ms, pre.scaling, scfg, mode, h,
                                        T_init, record_history, stats)
        T = to_original(T, pre, is_se3)
        if record_history:
            return T, it, pure_it, to_original(hist, pre, is_se3)
    return T, it, pure_it


def dispatch_arrays(src, n_src, tgt, n_tgt, cfg: RegistrationConfig,
                    mode: str, variant: str, record_history: bool = False,
                    initial_T=None, stats: dict | None = None,
                    exact_knn: bool = False, group=None) -> Dispatched:
    """``register_arrays`` without waiting for the card: the route of
    ``loop_route``; the captured program reads nothing back.  ``group``:
    the points route over that process group (NCCL on the card, gloo on
    the CPU; ``check_group``)."""
    if group is not None:
        check_group(group, src.device)
    if loop_route(src.device, mode, variant) == "eager":
        return Dispatched(register_arrays_eager(
            src, n_src, tgt, n_tgt, cfg, mode, variant, record_history,
            initial_T, stats, exact_knn, group))
    check_supported(cfg)
    from se3_icp_tpu_torch.models import program
    return program.run(src, n_src, tgt, n_tgt, cfg, mode, variant,
                       exact_knn=exact_knn, initial_T=initial_T,
                       record_history=record_history, stats=stats,
                       group=group)


def register_arrays(src, n_src, tgt, n_tgt, cfg: RegistrationConfig,
                    mode: str, variant: str, record_history: bool = False,
                    initial_T=None, stats: dict | None = None,
                    exact_knn: bool = False):
    """Register a batch of padded pairs on the tensors' device.

    src [B,Ns,3] / tgt [B,Nt,3] padded clouds, n_src / n_tgt [B] integer
    valid counts.  ``initial_T`` [B,4,4]: optional warm start in
    ORIGINAL coordinates (the reference always starts at identity).
    ``exact_knn``: the exact sorted-kNN setup instead of the threshold
    route (see ``setup``).  Returns (T [B,4,4] in original coordinates,
    num_iterations [B], num_pure_se3_iterations [B]), plus the
    per-iteration history [B,H,4,4] when ``record_history`` (entries at
    index >= num_iterations are undefined).  ``stats`` (optional dict)
    receives ``loop_steps`` and ``host_syncs``.  On the card this runs
    the captured program (``loop_route``) and reads its step count back
    once, with the results.
    """
    return dispatch_arrays(src, n_src, tgt, n_tgt, cfg, mode, variant,
                           record_history, initial_T, stats,
                           exact_knn).settle()


def _bucket(n: int, quantum: int = 512) -> int:
    """Round up to a bucket size (bounds the number of distinct shapes)."""
    return max(quantum, -(-n // quantum) * quantum)


def sanitize_cloud(points) -> np.ndarray:
    """Drop non-finite rows host-side: a single NaN point would poison
    every distance-matrix row it appears in.  Returns [M,3] float64."""
    pts = np.asarray(points, dtype=np.float64).reshape(-1, 3)
    mask = np.isfinite(pts).all(axis=1)
    if mask.all():
        return pts
    return pts[mask]


def warn_shot_truncation(src: np.ndarray, tgt: np.ndarray,
                         cfg: RegistrationConfig) -> None:
    """The capped SHOT route's host check: on the centred and scaled
    clouds the engine will see, warn (``RuntimeWarning``) when a radius
    neighbourhood holds more than ``shot_max_k`` points, which the
    route truncates to the nearest ``shot_max_k``."""
    import warnings
    cen_s, cen_t = src.mean(0), tgt.mean(0)
    r = max(np.linalg.norm(src - cen_s, axis=1).max(),
            np.linalg.norm(tgt - cen_t, axis=1).max())
    s = cfg.scale_preprocessing / max(r, 1e-30)
    n_tr = (lrf.shot_truncated_count((src - cen_s) * s, cfg.lrf_radius,
                                     cfg.shot_max_k)
            + lrf.shot_truncated_count((tgt - cen_t) * s, cfg.lrf_radius,
                                       cfg.shot_max_k))
    if n_tr:
        warnings.warn(
            f"SHOT LRF: {n_tr} points have more than "
            f"shot_max_k={cfg.shot_max_k} neighbors within "
            f"lrf_radius={cfg.lrf_radius}; their neighborhoods are "
            "truncated to the nearest max_k (diverges from the "
            "reference's radius semantics). Raise cfg.shot_max_k "
            "or lower cfg.lrf_radius.", RuntimeWarning)


def register_pair(source_points, target_points,
                  algorithm: str = "se3_pt2pl",
                  cfg: RegistrationConfig | None = None,
                  dtype=torch.float32, record_history: bool = False,
                  initial_T=None, device="cuda",
                  exact_knn: bool = False) -> RegistrationResult:
    """Host-facing entry point over the reference's algorithm-name
    surface (pt2pt/pt2pl/gicp, se3_*, se3_gicp_with_cf, se3_pure_*).

    Runs on the card unless ``device='cpu'``.  ``initial_T``: optional
    [4,4] warm start in original coordinates.  ``exact_knn``: the exact
    sorted-kNN setup instead of the threshold route."""
    dev = resolve_device(device)
    mode, variant = parse_algorithm(algorithm)
    cfg = cfg or RegistrationConfig()
    src = sanitize_cloud(source_points)
    tgt = sanitize_cloud(target_points)
    if cfg.lrf_method == "shot" and mode != "icp" and not cfg.shot_exact:
        warn_shot_truncation(src, tgt, cfg)
    ns, nt = len(src), len(tgt)
    src_p = np.zeros((1, _bucket(ns), 3), np.float64)
    src_p[0, :ns] = src
    tgt_p = np.zeros((1, _bucket(nt), 3), np.float64)
    tgt_p[0, :nt] = tgt
    T0 = None
    if initial_T is not None:
        T0 = torch.as_tensor(np.asarray(initial_T, np.float64)[None],
                             dtype=dtype, device=dev)
    out = register_arrays(
        torch.as_tensor(src_p, dtype=dtype, device=dev),
        torch.tensor([ns], dtype=torch.int32, device=dev),
        torch.as_tensor(tgt_p, dtype=dtype, device=dev),
        torch.tensor([nt], dtype=torch.int32, device=dev),
        cfg, mode, variant, record_history=record_history, initial_T=T0,
        exact_knn=exact_knn)
    n_it = int(out[1][0])
    history = None
    if record_history:
        history = out[3][0, :n_it].double().cpu().numpy()
    return RegistrationResult(
        transformation=out[0][0].double().cpu().numpy(),
        num_iterations=n_it,
        num_pure_se3_iterations=int(out[2][0]),
        history=history)
