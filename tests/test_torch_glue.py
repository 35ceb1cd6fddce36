"""The glue the port now runs as kernels, on the CPU (their plain
versions), against the JAX package and against the torch glue it
replaced.

  * The loop step's 6x6 solve (``ops/solve.solve6_c``: Gaussian
    elimination with partial pivoting, component-wise) and its Euler-ZYX
    retraction, through the step's own transform
    (``cuda_step._step_transform``), against the JAX package's
    ``solve_normal_equations`` (``jnp.linalg.solve``, LAPACK's LU with
    partial pivoting), on seed-made J^T J.  Well conditioned: 1e-12 of
    1 + |T| in float64.  Nearly singular (condition kappa ~1e8-1e12):
    both solvers are backward stable, so they agree to eps * kappa:
    1e-14 * kappa of 1 + |T| in float64.  Exactly singular (a direction
    no row constrains) and non-finite: the identity in both, through
    ``ok``.  float32: 1e-5 of 1 + |T| well conditioned, 1e-6 * kappa
    nearly singular (kappa ~1e3-1e6 there); the same identities.
  * The component-wise step (``cuda_step.step_update_plain``) against
    the decomposed torch glue it replaced (``torch.linalg.solve_ex``,
    ``kabsch3`` through 4x4 products, ``T_i @ T``, ``linalg.norm``,
    ``iteration_inputs``), step after step of real loops (pt2pl, GICP,
    pt2pt; SE(3) hybrid and icp; trimmed), in float64: every integer,
    flag and phase equal, every float within 1e-10 of 1 + its size.
  * The setup glue's plain entries, G1 (``cuda_frames.frame_inputs_plain``,
    ``ball_normals_plain``) and G2 (``frame_assembly_plain``), composed
    with K2 and K3's plain versions, against the JAX package's
    ``toldi_frames_thr_t`` / ``toldi_frames_normals_thr_t`` /
    ``normals_thr_t`` / ``gicp_covariances_thr_t`` (its Pallas kernels
    through the callback-free interpret gate, as its own tests run them)
    on a 300-point cloud, at the tolerances of ``test_torch_moments.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from se3_icp_tpu.ops import lrf as j_lrf
from se3_icp_tpu.ops import solve as j_solve

import torch_port_cases as cases
from se3_icp_tpu_torch.datasets import fixtures
from se3_icp_tpu_torch.models import registration as reg
from se3_icp_tpu_torch.ops import cuda_frames, cuda_loop, cuda_moments
from se3_icp_tpu_torch.ops import cuda_step, solve
from se3_icp_tpu_torch.parallel import pairs
from se3_icp_tpu_torch.utils.config import GOLDEN, parse_algorithm

torch.set_num_threads(1)

N_SYS = 16
# how near the nearly singular systems' two columns are: condition
# numbers ~1e8-1e12 in float64, ~1e3-1e6 in float32 (whose own rounding
# of the matrix leaves nothing to compare beyond 1 / eps)
NEAR = {np.float64: 1e-4, np.float32: 3e-2}
KAPPA = {np.float64: (1e7, 1e12), np.float32: (1e2, 1e6)}


def _systems(kind: str, dtype, seed: int = 3):
    """(JtJ [B,6,6], Jtr [B,6]) of N_SYS seed-made least-squares problems
    with the port's small steps (|xi| ~ 0.1)."""
    rng = np.random.default_rng(seed)
    A, b = [], []
    for _ in range(N_SYS):
        J = rng.normal(size=(200, 6)) * rng.uniform(0.3, 3.0, 6)
        if kind == "near":         # two columns nearly the same
            J[:, 5] = J[:, 4] + NEAR[dtype] * rng.normal(size=200)
        elif kind == "singular":   # nothing constrains the last direction
            J[:, 5] = 0.0
        xi = 0.1 * rng.normal(size=6)
        r = -(J @ xi) + 1e-3 * rng.normal(size=200)
        A.append(J.T @ J)
        b.append(J.T @ r)
    A, b = np.stack(A), np.stack(b)
    if kind == "nonfinite":
        A[0, 1, 2] = np.nan
        A[1, 4, 4] = np.inf
        b[2, 3] = np.nan
    return A.astype(dtype), b.astype(dtype)


def _port_T(A, b):
    st = torch.zeros((A.shape[0], 8), dtype=torch.from_numpy(A).dtype)
    st[:, 1] = 100.0                       # enough kept points
    R, t = cuda_step._step_transform(torch.from_numpy(A), torch.from_numpy(
        np.concatenate([b, np.zeros_like(b[:, :2])], 1)), st, "pt2pl")
    T = np.zeros((A.shape[0], 4, 4), A.dtype)
    for i in range(3):
        for j in range(3):
            T[:, i, j] = R[i][j].numpy()
        T[:, i, 3] = t[i].numpy()
    T[:, 3, 3] = 1.0
    return T


def _jax_T(A, b):
    return np.asarray(jax.vmap(j_solve.solve_normal_equations)(
        jnp.asarray(A), jnp.asarray(b)))


@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["float64", "float32"])
@pytest.mark.parametrize("kind", ["well", "near", "singular", "nonfinite"])
def test_the_componentwise_solve_gives_jaxs_transform(kind, dtype):
    A, b = _systems(kind, dtype)
    got = _port_T(A, b)
    eye = np.eye(4, dtype=dtype)
    if kind in ("singular", "nonfinite"):
        bad = range(N_SYS) if kind == "singular" else range(3)
        for i in bad:
            assert np.array_equal(got[i], eye), i
        if kind == "singular":
            want = _jax_T(A, b)
            assert all(np.array_equal(want[i], eye) for i in bad)
            return
        A, b, got = A[3:], b[3:], got[3:]
    want = _jax_T(A, b)
    scale = 1.0 + np.abs(want).max((1, 2))
    err = np.abs(got - want).max((1, 2))
    kappa = np.linalg.cond(A.astype(np.float64))
    if kind == "near":
        lo, hi = KAPPA[dtype]
        assert (kappa > lo).all() and (kappa < hi).all(), kappa
    if dtype == np.float32:
        limit = 1e-5 if kind == "well" else 1e-6 * kappa
    else:
        limit = 1e-12 if kind == "well" else 1e-14 * kappa
    assert (err <= limit * scale).all(), (err / scale).max()


def _old_glue(A, b, st, s, h, c, ms, cfg):
    """The loop step after K5 as the port ran it before: the decomposed
    torch glue (``solve.solve_from_normal`` / ``solve_pt2pt_from_moments``
    on 4x4 products, ``T_i @ T``, ``linalg.norm``, ``iteration_inputs``)."""
    it1 = s["it"] + 1
    mse_val, wsum = st[:, 0], st[:, 1]
    if ms.variant == "pt2pt":
        H = A[:, :3, :3]
        ok = (wsum > 2.5) & torch.isfinite(H).flatten(1).all(-1)
        # kabsch3 as it was: 4x4 products
        (xx, yx, zx), (xy, yy, zy), (xz, yz, zz) = (
            [H[:, i, j] for j in range(3)] for i in range(3))
        a_, b_, c_ = yz - zy, zx - xz, xy - yx
        N = torch.stack([xx + yy + zz, a_, b_, c_, a_, xx - yy - zz, xy + yx,
                         zx + xz, b_, xy + yx, yy - xx - zz, yz + zy, c_,
                         zx + xz, yz + zy, zz - xx - yy], -1).view(-1, 4, 4)
        M = N + torch.diag_embed(torch.sqrt((H * H).sum((1, 2)))[:, None]
                                 .expand(-1, 4))
        tiny = torch.finfo(A.dtype).tiny
        for k in range(solve._SQUARINGS[A.dtype]):
            if k % 4 == 0:
                M = M / M.diagonal(dim1=1, dim2=2).sum(-1).clamp_min(
                    tiny)[:, None, None]
            M = M @ M
        j = M.diagonal(dim1=1, dim2=2).argmax(-1)
        q = M.gather(2, j[:, None, None].expand(-1, 4, 1))[..., 0]
        q = q / torch.sqrt((q * q).sum(-1, keepdim=True))
        w, v = q[:, :1, None], q[:, 1:]
        from se3_icp_tpu_torch.utils import se3
        R = torch.diag_embed((2.0 * w * w - 1.0)[:, 0].expand(-1, 3)) \
            + 2.0 * (v[:, :, None] * v[:, None, :] + w * se3.skew(v))
        t = b[:, 3:6] - (R @ b[:, 0:3, None])[..., 0]
        T_i = solve._safe_transform(se3.rt_to_T(R, t), ok)
    else:
        T_i = solve.solve_from_normal(A, b[:, :6], wsum)
    mse_rel = (mse_val - s["mse_cur"]).abs()
    T_new = T_i @ s["T"]
    t_change = torch.linalg.norm((s["T"] - T_new).flatten(1), dim=1)
    stop = (it1 >= c.max_iters) | (mse_rel < c.stop_thresh)
    if c.hybrid:
        new_sw = s["switched"] | (it1 >= cfg.max_num_se3_iterations) | (
            t_change < h.mse_switch_error)
        new_done = s["switched"] & stop
    else:
        new_sw, new_done = s["switched"], stop
    active = ~s["done"]
    T = torch.where(active[:, None, None], T_new, s["T"])
    out = dict(T=T, it=torch.where(active, it1, s["it"]),
               pure_it=torch.where(active & ~s["switched"], s["pure_it"] + 1,
                                   s["pure_it"]),
               mse_prev=torch.where(active, s["mse_cur"], s["mse_prev"]),
               mse_cur=torch.where(active, mse_val, s["mse_cur"]),
               switched=torch.where(active, new_sw, s["switched"]),
               done=s["done"] | new_done)
    out["W"], out["ph2"], out["pf"] = reg.iteration_inputs(
        ms, cfg, T, out["switched"], out["done"], h)
    return out


@pytest.mark.parametrize("alg,overlap", [
    ("se3_pt2pl", 1.0), ("se3_gicp", 0.75), ("se3_pt2pt", 1.0),
    ("pt2pl", 0.75)])
def test_the_componentwise_step_gives_the_old_glues_step(alg, overlap):
    probs = [fixtures.golden_shape_problem(seed=s, n=260 + 40 * s)
             for s in (1, 2, 3)]
    src, n_src, tgt, n_tgt = (torch.as_tensor(a) for a in pairs.pack_pairs(
        [(p.source, p.target) for p in probs], dtype=np.float64))
    cfg = GOLDEN.replace(estimated_overlap=overlap, mse=1e-7)
    mode, variant = parse_algorithm(alg)
    floats, scfg = reg.split_cfg(cfg, src.dtype, src.device)
    h = reg.hyper(floats)
    keys = cuda_step.STATE + ("W", "ph2", "pf")
    with torch.no_grad():
        ms, pre = reg.setup(src, n_src, tgt, n_tgt, scfg, mode, variant, h,
                            exact_knn=True)
        s, c = reg.init_loop(ms, pre.scaling, scfg, mode, h)
        for step in range(14):
            A, b, st = reg._match_and_epilogue(s, ms, c, s.W, s.ph2, s.pf)
            state = {k: getattr(s, k) for k in keys}
            new = cuda_step.step_update(
                A, b, st, dict(state, hist=None), c.hv, c.stop_thresh,
                c.n_src_f, variant=ms.variant, is_se3=ms.is_se3,
                hybrid=c.hybrid, do_trim=c.ep_kw["do_trim"],
                max_iters=c.max_iters,
                max_se3_iters=scfg.max_num_se3_iterations)
            old = _old_glue(A, b, st, state, h, c, ms, scfg)
            for k in keys:
                x, y = new[k], old[k]
                assert x.dtype == y.dtype, k
                if x.is_floating_point():
                    tol = 1e-10 * (1.0 + float(y.abs().max()))
                    assert float((x - y).abs().max()) <= tol, (step, k)
                else:
                    assert torch.equal(x, y), (step, k)
            s = reg.LoopState(**{k: new[k] for k in keys}, hist=None)
    assert bool(s.it.min() > 1)


@pytest.fixture()
def interpret(monkeypatch):
    monkeypatch.setenv("SE3_ICP_TPU_PALLAS_INTERPRET", "1")


def _angles_deg(Ra, Rb):
    rel = np.einsum("nij,nkj->nik", Ra, Rb)
    tr = np.clip((np.trace(rel, axis1=1, axis2=2) - 1) / 2, -1, 1)
    return np.degrees(np.arccos(tr))


def test_the_setup_glues_plain_entries_give_jaxs_frames(interpret):
    k, n_valid = 90, 300
    pts = np.zeros((1, 512, 3), np.float32)
    pts[0, :n_valid] = fixtures.golden_shape_problem(seed=4,
                                                     n=n_valid).source
    nv = np.asarray([n_valid], np.int32)
    thr = cases.midpoint_thresholds(pts, nv, [k // 3, k // 3 + 1, k, 20])
    tp, tnv = torch.from_numpy(pts), torch.from_numpy(nv)
    th = torch.from_numpy(thr)
    cloud = cuda_moments.setup_cloud(tp, tnv)
    raw = cuda_moments.moments_raw(tp, tnv, (th[:, 0], th[:, 1], th[:, 2]),
                                   cloud)
    normal_t, aux, fused = cuda_frames.frame_inputs_plain(
        raw, tp, cloud.tn, th[:, 2], k // 3, k // 3)
    w = cuda_moments.axis_sums_aux(tp, tnv, normal_t, aux, cloud)
    out_t, frames = cuda_frames.frame_assembly_plain(raw, tp, normal_t, w,
                                                     fused)
    assert out_t.shape == (1, 12, 512) and frames.shape == (1, 512, 9)
    assert torch.equal(frames, out_t[:, :9].mT)
    j = np.asarray(j_lrf.toldi_frames_normals_thr_t(
        jnp.asarray(pts[0]), jnp.asarray(thr[0, 0]), jnp.asarray(thr[0, 1]),
        jnp.asarray(thr[0, 2]), k, k // 3, n_valid))
    rot = frames[0, :n_valid].reshape(-1, 3, 3).transpose(1, 2).numpy()
    jrot = j[:9, :n_valid].T.reshape(-1, 3, 3).transpose(0, 2, 1)
    ang = _angles_deg(rot, jrot)
    assert np.median(ang) < 1e-3 and np.mean(ang < 0.05) >= 0.99
    dots = np.abs((out_t[0, 9:, :n_valid].numpy() * j[9:, :n_valid]).sum(0))
    assert np.median(dots) > 0.99999
    # the one-ball modes: PCA normals and GICP covariances of count 20
    one = cuda_moments.moments_raw(tp, tnv, (th[:, 3],), cloud)
    nrm = cuda_frames.ball_normals_plain(one, tp, 20)
    cov6 = cuda_frames.ball_normals_plain(one, tp, 20, gicp_epsilon=1e-3)
    jn = np.asarray(j_lrf.normals_thr_t(jnp.asarray(pts[0]),
                                        jnp.asarray(thr[0, 3]), 20, n_valid))
    jc = np.asarray(j_lrf.gicp_covariances_thr_t(
        jnp.asarray(pts[0]), jnp.asarray(thr[0, 3]), 20, 1e-3, n_valid))
    dots = np.abs((nrm[0, :, :n_valid].numpy() * jn[:, :n_valid]).sum(0))
    assert np.median(dots) > 0.99999
    assert np.median(np.abs(cov6[0, :, :n_valid].numpy()
                            - jc[:, :n_valid])) < 1e-4
    # the kernels' operands: K3's aux as its wrapper builds it
    assert torch.equal(aux[:, 0], th[:, 2] - cloud.tn)
    assert aux.dtype == torch.float32 and cuda_loop.PF_WIDTH == 24
