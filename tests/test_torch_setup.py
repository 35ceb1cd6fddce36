"""Setup-side modules of the PyTorch port against the JAX package, on
the CPU: the same numpy arrays (seed-made "room" scenes, padded with
n_valid < N) go through the JAX function and its counterpart.

Tolerances: float64 on both sides, so the two differ only by the order
of a few additions -- 1e-9 absolute unless a test says otherwise.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from se3_icp_tpu.ops import eigh3 as j_eigh3
from se3_icp_tpu.ops import knn as j_knn
from se3_icp_tpu.ops import lrf as j_lrf
from se3_icp_tpu.ops import solve as j_solve
from se3_icp_tpu.ops import trim as j_trim
from se3_icp_tpu.utils import se3 as j_se3

from se3_icp_tpu_torch.datasets import fixtures
from se3_icp_tpu_torch.ops import eigh3, knn, lrf, solve, trim
from se3_icp_tpu_torch.utils import se3

# the suite runs several worker processes side by side: keep each
# one's torch thread pool small
torch.set_num_threads(1)

N_PAD = 512
N_VALID = (470, 512)


def _clouds(seed=0):
    """Two padded room clouds [2,512,3] float64 with 470 / 512 valid
    rows (padding rows are zero, as the engine makes them)."""
    rng = np.random.default_rng(seed)
    pts = np.zeros((2, N_PAD, 3))
    for b, n in enumerate(N_VALID):
        pts[b, :n] = fixtures._scene(rng, n, "room")
    return pts, np.asarray(N_VALID, np.int32)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def test_pairwise_d2_and_knn_self_match_jax():
    pts, nv = _clouds()
    k = 31
    idx, d2 = knn.knn_self(_t(pts), k, _t(nv))
    for b in range(2):
        ji, jd = j_knn.knn_self(jnp.asarray(pts[b]), k, int(nv[b]),
                                method="exact")
        np.testing.assert_allclose(d2[b].numpy(), np.asarray(jd),
                                   atol=1e-12)
        # no duplicate points: ranks are unambiguous on valid rows
        n = int(nv[b])
        np.testing.assert_array_equal(idx[b, :n].numpy(),
                                      np.asarray(ji)[:n])
        assert (idx[b, :n] < n).all()


def test_nn_argmin_ties_go_to_lowest_index():
    t = np.zeros((1, 6, 3))
    t[0, :, 0] = [5.0, 1.0, 1.0, 3.0, 1.0, 9.0]
    q = np.zeros((1, 2, 3))
    q[0, 1, 0] = 9.0
    idx, d2 = knn.nn_argmin(_t(q), _t(t), _t(np.asarray([5])))
    ji, jd = j_knn.nn_argmin_xla(jnp.asarray(q[0]), jnp.asarray(t[0]), 5)
    np.testing.assert_array_equal(idx[0].numpy(), np.asarray(ji))
    assert idx[0].tolist() == [1, 0]       # target 5 is masked out
    np.testing.assert_allclose(d2[0].numpy(), np.asarray(jd), atol=1e-12)
    _, _, matched = knn.nn_match(_t(q), _t(t), _t(t * 2.0),
                                 _t(np.asarray([5])))
    np.testing.assert_array_equal(matched[0].numpy(), 2.0 * t[0, [1, 0]])


@pytest.mark.parametrize("exact_centroid", [False, True])
def test_toldi_frames_dense_match_jax(exact_centroid):
    pts, nv = _clouds(1)
    k = 45
    _, d2 = knn.knn_self(_t(pts), k + 1, _t(nv))
    rot = lrf.toldi_frames_dense(_t(pts), d2[..., :k], _t(nv),
                                 exact_centroid=exact_centroid)
    for b in range(2):
        _, jd = j_knn.knn_self(jnp.asarray(pts[b]), k + 1, int(nv[b]),
                               method="exact")
        jrot, _ = j_lrf.toldi_frames_dense(
            jnp.asarray(pts[b]), jd[:, :k], int(nv[b]),
            exact_centroid=exact_centroid)
        n = int(nv[b])
        np.testing.assert_allclose(rot[b, :n].numpy(),
                                   np.asarray(jrot)[:n], atol=1e-8)
        R = rot[b, :n].numpy()
        np.testing.assert_allclose(R.transpose(0, 2, 1) @ R,
                                   np.broadcast_to(np.eye(3), R.shape),
                                   atol=1e-9)


def test_toldi_small_cloud_radius_clamp_matches_jax():
    """k exceeds the valid count: the radius clamps to the last VALID
    neighbour instead of the masked-kNN sentinel."""
    rng = np.random.default_rng(5)
    pts = np.zeros((1, 128, 3))
    pts[0, :20] = fixtures._scene(rng, 20, "room")
    nv = np.asarray([20], np.int32)
    k = 30
    _, d2 = knn.knn_self(_t(pts), k + 1, _t(nv))
    rot = lrf.toldi_frames_dense(_t(pts), d2[..., :k], _t(nv))
    _, jd = j_knn.knn_self(jnp.asarray(pts[0]), k + 1, 20, method="exact")
    jrot, _ = j_lrf.toldi_frames_dense(jnp.asarray(pts[0]), jd[:, :k], 20)
    assert torch.isfinite(rot[0, :20]).all()
    np.testing.assert_allclose(rot[0, :20].numpy(), np.asarray(jrot)[:20],
                               atol=1e-8)


def test_normals_and_gicp_covariances_dense_match_jax():
    pts, nv = _clouds(2)
    k_use, eps = 20, 1e-3
    _, d2 = knn.knn_self(_t(pts), 31, _t(nv))
    nrm = lrf.normals_dense(_t(pts), d2, k_use, _t(nv))
    cov = lrf.gicp_covariances_dense(_t(pts), d2, k_use, eps, _t(nv))
    cov6 = lrf._sym_to_6(cov)
    # the 6-component form keeps the upper triangle; Rx C Rx^T is
    # symmetric up to rounding
    np.testing.assert_allclose(lrf._cov6_to_mat(cov6).numpy(), cov.numpy(),
                               atol=1e-15)
    for b in range(2):
        n = int(nv[b])
        _, jd = j_knn.knn_self(jnp.asarray(pts[b]), 31, n, method="exact")
        jn = np.asarray(j_lrf.normals_dense(jnp.asarray(pts[b]), jd, k_use,
                                            n))
        jc = np.asarray(j_lrf.gicp_covariances_dense(
            jnp.asarray(pts[b]), jd, k_use, eps, n))
        # the component form and the JAX matrix form of the closed-form
        # eigensolver agree in sign too; the covariance is sign-free
        np.testing.assert_allclose(nrm[b, :n].numpy(), jn[:n], atol=1e-7)
        np.testing.assert_allclose(cov[b, :n].numpy(), jc[:n], atol=1e-7)
    with pytest.raises(ValueError):
        lrf.normals_dense(_t(pts), d2[..., :k_use], k_use, _t(nv))


def test_rotation_from_e1_to_x_quirk_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(64, 3))
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    x[0] = (-1.0, 0.0, 0.0)                 # c < -0.99 -> identity
    x[1] = (-0.995, 0.0998749, 0.0)
    R = lrf.rotation_from_e1_to_x(_t(x)).numpy()
    np.testing.assert_allclose(
        R, np.asarray(j_lrf.rotation_from_e1_to_x(jnp.asarray(x))),
        atol=1e-12)
    np.testing.assert_array_equal(R[0], np.eye(3))
    np.testing.assert_array_equal(R[1], np.eye(3))


def _sym(rng, n):
    a = rng.normal(size=(n, 3, 3))
    return a @ a.transpose(0, 2, 1) + 0.05 * np.eye(3)


def test_eigh3_matches_jax_and_lapack():
    rng = np.random.default_rng(4)
    A = _sym(rng, 300)
    A[0] = np.diag([2.0, 2.0, 5.0])          # repeated eigenvalue
    A[1] = 3.0 * np.eye(3)                   # p == 0 branch
    vals, vecs = eigh3.eigh3(_t(A))
    jv, jw = j_eigh3.eigh3(jnp.asarray(A))
    np.testing.assert_allclose(vals.numpy(), np.asarray(jv), atol=1e-10)
    np.testing.assert_allclose(vals.numpy(), np.linalg.eigvalsh(A),
                               atol=1e-10)
    rec = (vecs.numpy() * vals.numpy()[:, None, :]) @ vecs.numpy() \
        .transpose(0, 2, 1)
    np.testing.assert_allclose(rec, A, atol=1e-9)
    np.testing.assert_allclose(vecs[2:].numpy(), np.asarray(jw)[2:],
                               atol=1e-7)
    np.testing.assert_allclose(
        eigh3.smallest_eigvec3(_t(A))[2:].numpy(),
        np.asarray(j_eigh3.smallest_eigvec3(jnp.asarray(A)))[2:], atol=1e-7)
    W = eigh3.inv_sqrt_sym3(_t(A)).numpy()
    np.testing.assert_allclose(
        W, np.asarray(j_eigh3.inv_sqrt_sym3(jnp.asarray(A))), atol=1e-9)
    np.testing.assert_allclose(W @ W @ A, np.broadcast_to(np.eye(3), A.shape),
                               atol=1e-8)


def test_eigh3_float32_components_match_jax():
    """float32, component-major: what the loop's gicp whitening runs."""
    rng = np.random.default_rng(6)
    A = _sym(rng, 400).astype(np.float32)
    comps = [A[:, 0, 0], A[:, 0, 1], A[:, 0, 2], A[:, 1, 1], A[:, 1, 2],
             A[:, 2, 2]]
    w = eigh3.inv_sqrt_sym3_c(*[_t(c) for c in comps])
    jw = j_eigh3.inv_sqrt_sym3_c(*[jnp.asarray(c) for c in comps])
    for a, b in zip(w, jw):
        assert a.dtype == torch.float32
        # float32 acos/cos differ between the two libraries in the last
        # ulps; M^(-1/2) amplifies that by its conditioning (<= ~20 here)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4,
                                   atol=2e-4)


def test_se3_utils_match_jax():
    rng = np.random.default_rng(7)
    xi = rng.normal(size=(5, 6)) * 0.3
    T = se3.euler_zyx_retract(_t(xi))
    np.testing.assert_allclose(
        T.numpy(), np.asarray(j_se3.euler_zyx_retract(jnp.asarray(xi))),
        atol=1e-12)
    np.testing.assert_allclose(
        se3.rot_3d(np.pi / 9, np.pi / 8, -np.pi / 7).numpy(),
        np.asarray(j_se3.rot_3d(np.pi / 9, np.pi / 8, -np.pi / 7)),
        atol=1e-12)
    np.testing.assert_allclose(
        fixtures.rot_3d(np.pi / 9, np.pi / 8, -np.pi / 7),
        np.asarray(j_se3.rot_3d(np.pi / 9, np.pi / 8, -np.pi / 7)),
        atol=1e-12)
    pts = rng.normal(size=(5, 7, 3))
    np.testing.assert_allclose(
        se3.transform_points(T, _t(pts)).numpy(),
        np.asarray(j_se3.transform_points(jnp.asarray(T.numpy()),
                                          jnp.asarray(pts))), atol=1e-12)
    np.testing.assert_allclose(
        (se3.T_inverse(T) @ T).numpy(),
        np.broadcast_to(np.eye(4), (5, 4, 4)), atol=1e-12)
    np.testing.assert_allclose(
        se3.skew(_t(xi[:, :3])).numpy(),
        np.asarray(j_se3.skew(jnp.asarray(xi[:, :3]))), atol=0)


def _solve_problem(rng, b=3, n=300):
    src = rng.normal(size=(b, 3, n))
    R = np.asarray(j_se3.rot_3d(0.1, -0.05, 0.08))
    tgt = R @ src + rng.normal(size=(b, 3, 1)) * 0.1 \
        + 0.002 * rng.normal(size=(b, 3, n))
    w = (rng.uniform(size=(b, n)) > 0.3).astype(np.float64)
    return src, tgt, w


@pytest.mark.parametrize("variant", ["pt2pt", "pt2pl", "gicp", "gicp_cf"])
def test_solve_estimators_match_jax(variant):
    rng = np.random.default_rng(8)
    src, tgt, w = _solve_problem(rng)
    b, _, n = src.shape
    nrm = rng.normal(size=(b, 3, n))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)

    def spd6(a):
        return np.stack([a[:, 0] ** 2 + 0.5, a[:, 0] * a[:, 1] * .1,
                         a[:, 0] * a[:, 2] * .1, a[:, 1] ** 2 + 0.7,
                         a[:, 1] * a[:, 2] * .1, a[:, 2] ** 2 + 0.9], 1)

    cs, ct = spd6(rng.normal(size=(b, 3, n))), spd6(rng.normal(size=(b, 3, n)))
    conf = rng.uniform(0.2, 1.0, size=(b, n))
    if variant == "pt2pt":
        T = solve.solve_pt2pt_T(_t(src), _t(tgt), _t(w))
        ref = [j_solve.solve_pt2pt_T(jnp.asarray(src[i]), jnp.asarray(tgt[i]),
                                     jnp.asarray(w[i])) for i in range(b)]
    elif variant == "pt2pl":
        T = solve.solve_pt2pl_T(_t(src), _t(tgt), _t(nrm), _t(w))
        ref = [j_solve.solve_pt2pl_T(jnp.asarray(src[i]), jnp.asarray(tgt[i]),
                                     jnp.asarray(nrm[i]), jnp.asarray(w[i]))
               for i in range(b)]
    else:
        c = conf if variant == "gicp_cf" else None
        T = solve.solve_gicp_T(_t(src), _t(tgt), _t(cs), _t(ct), _t(w),
                               None if c is None else _t(c))
        ref = [j_solve.solve_gicp_T(
            jnp.asarray(src[i]), jnp.asarray(tgt[i]), jnp.asarray(cs[i]),
            jnp.asarray(ct[i]), jnp.asarray(w[i]),
            None if c is None else jnp.asarray(c[i])) for i in range(b)]
    np.testing.assert_allclose(T.numpy(), np.stack([np.asarray(r)
                                                    for r in ref]),
                               atol=1e-9)


def test_rotate_sym3_T_matches_jax():
    rng = np.random.default_rng(9)
    R = np.stack([np.asarray(j_se3.rot_3d(*rng.uniform(-1, 1, 3)))
                  for _ in range(2)])
    c6 = rng.normal(size=(2, 6, 50))
    out = solve.rotate_sym3_T(_t(R), _t(c6)).numpy()
    for i in range(2):
        np.testing.assert_allclose(
            out[i], np.asarray(j_solve.rotate_sym3_T(jnp.asarray(R[i]),
                                                     jnp.asarray(c6[i]))),
            atol=1e-12)


def test_solve_degenerate_inputs_give_identity():
    """Singular normal equations, too few points and non-finite sums all
    degrade to identity, per pair, without touching the other pairs."""
    eye = np.eye(4)
    A = torch.zeros((3, 6, 6), dtype=torch.float64)
    A[1] = torch.eye(6, dtype=torch.float64)
    b = torch.ones((3, 6), dtype=torch.float64) * 0.01
    A[2] = float("nan")
    T = solve.solve_from_normal(A, b, torch.tensor([100.0, 100.0, 100.0],
                                                   dtype=torch.float64))
    np.testing.assert_array_equal(T[0].numpy(), eye)
    np.testing.assert_array_equal(T[2].numpy(), eye)
    ref = np.asarray(j_solve.solve_from_normal(
        jnp.eye(6), jnp.full(6, 0.01), jnp.asarray(100.0)))
    np.testing.assert_allclose(T[1].numpy(), ref, atol=1e-12)
    T = solve.solve_from_normal(A[1:2], b[1:2],
                                torch.tensor([5.0], dtype=torch.float64))
    np.testing.assert_array_equal(T[0].numpy(), eye)      # < 6 points
    H = torch.zeros((2, 3, 3), dtype=torch.float64)
    H[0] = float("inf")
    H[1] = torch.eye(3, dtype=torch.float64)
    mu = torch.zeros((2, 3), dtype=torch.float64)
    T = solve.solve_pt2pt_from_moments(H, mu, mu + 1.0,
                                       torch.tensor([50.0, 50.0],
                                                    dtype=torch.float64))
    np.testing.assert_array_equal(T[0].numpy(), eye)
    np.testing.assert_allclose(T[1, :3, 3].numpy(), np.ones(3), atol=1e-12)


@pytest.mark.parametrize("overlap", [0.5, 0.75, 1.0])
def test_trim_mask_matches_jax(overlap, monkeypatch):
    """Same kept set as the JAX bisection (the route its fused loop
    takes) and as its stable-sort route, ties included."""
    rng = np.random.default_rng(10)
    n = 400
    d = rng.uniform(0.0, 2.0, size=(2, n))
    d[0, 50:90] = d[0, 10]                 # a run of exact ties
    d[1, ::7] = 0.0
    nv = np.asarray([n, 333])
    valid = np.arange(n)[None, :] < nv[:, None]
    kept = trim.trim_mask(_t(d), _t(valid), overlap,
                          _t(nv.astype(np.float64))).numpy()
    for i in range(2):
        sort_route = np.asarray(j_trim.trim_mask(
            jnp.asarray(d[i]), jnp.asarray(valid[i]), overlap, int(nv[i])))
        np.testing.assert_array_equal(kept[i], sort_route)
        if overlap < 1.0:
            bis = np.asarray(j_trim._trim_mask_bisect(
                jnp.asarray(d[i]), jnp.asarray(valid[i]),
                jnp.asarray(int(np.floor(overlap * nv[i])), jnp.int32)))
            np.testing.assert_array_equal(kept[i], bis)
            assert kept[i].sum() == int(np.floor(overlap * nv[i]))
    m = trim.masked_mean(_t(d), _t(kept)).numpy()
    for i in range(2):
        np.testing.assert_allclose(
            m[i], float(j_trim.masked_mean(jnp.asarray(d[i]),
                                           jnp.asarray(kept[i]))),
            rtol=1e-12)
