"""K2 and K3 of the PyTorch port (``ops/cuda_moments.moments_batched``
/ ``axis_sums_batched``, plain versions on the CPU) and the glue that
turns their sums into TOLDI frames, PCA normals and GICP covariances
(``ops/lrf.py``, threshold route), against the JAX package's
``pallas_moments`` kernels through the callback-free interpret gate
(``SE3_ICP_TPU_PALLAS_INTERPRET=1``) and its ``lrf.*_thr_t`` glue.

Both sides get the same thresholds, taken halfway between consecutive
sorted float64 distances, so no member lies within rounding of a ball's
boundary: the balls are the same and the member counts must be equal.
The sums are float32 in another order (sequential here, limb-split
matrix products there): K2 within 1e-5 of each row's largest entry, K3
within 1e-4 (its weights are products of four rounded factors, and the
JAX kernel splits them into two bf16 limbs, ~2^-17 relative).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from se3_icp_tpu.ops import lrf as j_lrf
from se3_icp_tpu.ops import pallas_moments as pm

import torch_port_cases as cases
from se3_icp_tpu_torch.datasets import fixtures
from se3_icp_tpu_torch.ops import cuda_moments as cm
from se3_icp_tpu_torch.ops import lrf

# the suite runs several worker processes side by side: keep each
# one's torch thread pool small
torch.set_num_threads(1)

N_VALID = (480, 420)
K = 90                                   # TOLDI k; balls k//3, k//3+1, k


def _surface():
    """Two padded "bumpy" surface clouds [2,512,3] float32 (the engine's
    gate fixture), n_valid 480 / 420."""
    pts = np.zeros((2, 512, 3), np.float32)
    for b, n in enumerate(N_VALID):
        pts[b, :n] = fixtures.golden_shape_problem(seed=b + 1, n=n).source
    return pts, np.asarray(N_VALID, np.int32)


@pytest.fixture()
def interpret(monkeypatch):
    monkeypatch.setenv("SE3_ICP_TPU_PALLAS_INTERPRET", "1")


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _row_rel_err(got, ref, nv):
    """max over (pair, component row) of max |got - ref| / max |ref|,
    over the valid queries; [B,C,N] or [B,N]."""
    worst = 0.0
    for b, n in enumerate(nv):
        g = np.asarray(got[b])[..., :n].reshape(-1, n)
        r = np.asarray(ref[b])[..., :n].reshape(-1, n)
        scale = np.maximum(np.abs(r).max(1), 1e-30)
        worst = max(worst, float((np.abs(g - r).max(1) / scale).max()))
    return worst


def test_moments_match_jax(interpret):
    pts, nv = _surface()
    thr = cases.midpoint_thresholds(pts, nv, [K // 3, K // 3 + 1, K])
    mom = cm.moments_batched(_t(pts), _t(nv), _t(thr[:, 0]), _t(thr[:, 1]),
                             _t(thr[:, 2]))
    jmom = pm.moments_batched(jnp.asarray(pts), jnp.asarray(nv),
                              *(jnp.asarray(thr[:, i]) for i in range(3)))
    assert set(mom) == set(jmom)
    for key in ("cen_cnt", "cov_cnt", "all_cnt"):
        for b, n in enumerate(nv):
            np.testing.assert_array_equal(mom[key][b, :n].numpy(),
                                          np.asarray(jmom[key])[b, :n])
    for b, n in enumerate(nv):
        # the midpoint balls hold exactly c points, self included
        np.testing.assert_array_equal(mom["all_cnt"][b, :n].numpy(), K - 1)
    for key in ("cen_sum", "cen_p9", "cov_sum", "cov_p9", "all_sum", "q_t"):
        assert mom[key].shape == jmom[key].shape
        assert _row_rel_err(mom[key], jmom[key], nv) <= 1e-5, key


def test_axis_sums_match_jax(interpret):
    """K3 at JAX's own normals (its TOLDI z-axis before the sign fix) and
    the radius of the k-ball."""
    pts, nv = _surface()
    thr = cases.midpoint_thresholds(pts, nv, [K // 3, K // 3 + 1, K])
    nrm = np.stack([np.asarray(j_lrf.normals_thr_t(
        jnp.asarray(pts[b]), jnp.asarray(thr[b, 1]), K // 3 + 1, int(n)))
        for b, n in enumerate(nv)])                           # [B,3,N]
    q_t = pts.transpose(0, 2, 1)
    ndotq = (nrm * q_t).sum(1).astype(np.float32)
    radius = np.sqrt(np.maximum(thr[:, 2], 0.0))
    w_p, w_sum = cm.axis_sums_batched(_t(pts), _t(nv), _t(nrm), _t(ndotq),
                                      _t(radius), _t(thr[:, 2]))
    jw_p, jw_sum = pm.axis_sums_batched(
        jnp.asarray(pts), jnp.asarray(nv), jnp.asarray(nrm),
        jnp.asarray(ndotq), jnp.asarray(radius), jnp.asarray(thr[:, 2]))
    assert w_p.shape == (2, 3, 512) and w_sum.shape == (2, 512)
    assert _row_rel_err(w_p, jw_p, nv) <= 1e-4
    assert _row_rel_err(w_sum, jw_sum, nv) <= 1e-4
    pw_p, pw_sum = cm.axis_sums_plain(_t(pts), _t(nv), _t(nrm), _t(ndotq),
                                      _t(radius), _t(thr[:, 2]))
    torch.testing.assert_close(pw_p, w_p, rtol=0, atol=0)
    torch.testing.assert_close(pw_sum, w_sum, rtol=0, atol=0)


def _angles_deg(Ra, Rb):
    rel = np.einsum("nij,nkj->nik", Ra, Rb)
    tr = np.clip((np.trace(rel, axis1=1, axis2=2) - 1) / 2, -1, 1)
    return np.degrees(np.arccos(tr))


def _t9_to_rot(r9):
    """[9,N] transposed frame rows -> [N,3,3] with axis j in column j."""
    return r9.T.reshape(-1, 3, 3).transpose(0, 2, 1)


@pytest.mark.parametrize("fused_normals", [False, True])
def test_toldi_frames_from_thresholds_match_jax(fused_normals, interpret):
    """Frames within 1e-3 deg in the median and 0.05 deg for 99% of the
    rows (a few rows whose smallest eigenvalues nearly tie carry the
    float32 noise further); the normals fused into the frames' pass
    (normals_k == k//3, the GOLDEN configuration) as ``normals_thr_t``
    gives them."""
    pts, nv = _surface()
    thr = cases.midpoint_thresholds(pts, nv, [K // 3, K // 3 + 1, K])
    nk = K // 3 if fused_normals else None
    out = lrf.toldi_frames_thr_t(_t(pts), _t(thr[:, 0]), _t(thr[:, 1]),
                                 _t(thr[:, 2]), K, _t(nv), normals_k=nk)
    assert out.shape == (2, 12 if fused_normals else 9, 512)
    rot = lrf.rot_t9_to_rot(out[:, :9]).numpy()
    for b, n in enumerate(nv):
        args = (jnp.asarray(pts[b]), jnp.asarray(thr[b, 0]),
                jnp.asarray(thr[b, 1]), jnp.asarray(thr[b, 2]), K)
        if fused_normals:
            j = np.asarray(j_lrf.toldi_frames_normals_thr_t(*args, K // 3,
                                                            int(n)))
        else:
            j = np.asarray(j_lrf.toldi_frames_thr_t(*args, int(n)))
        ang = _angles_deg(rot[b, :n], _t9_to_rot(j[:9])[:n])
        assert np.median(ang) < 1e-3, np.median(ang)
        assert np.mean(ang < 0.05) >= 0.99, np.sort(ang)[-10:]
        R = rot[b, :n]                     # float32: orthonormal to 1e-4
        np.testing.assert_allclose(R.transpose(0, 2, 1) @ R,
                                   np.broadcast_to(np.eye(3), R.shape),
                                   atol=1e-4)
        if fused_normals:
            dots = np.abs((out[b, 9:, :n].numpy() * j[9:, :n]).sum(0))
            assert np.median(dots) > 0.99999
            alone = lrf.normals_thr_t(_t(pts), _t(thr[:, 0]), K // 3,
                                      _t(nv))
            torch.testing.assert_close(out[:, 9:], alone, rtol=0,
                                       atol=1e-6)


def test_normals_and_gicp_covariances_from_thresholds_match_jax(interpret):
    pts, nv = _surface()
    k_use, eps = 20, 1e-3
    thr = cases.midpoint_thresholds(pts, nv, [k_use])[:, 0]
    nrm = lrf.normals_thr_t(_t(pts), _t(thr), k_use, _t(nv))
    cov6 = lrf.gicp_covariances_thr_t(_t(pts), _t(thr), k_use, eps, _t(nv))
    assert nrm.shape == (2, 3, 512) and cov6.shape == (2, 6, 512)
    for b, n in enumerate(nv):
        jn = np.asarray(j_lrf.normals_thr_t(jnp.asarray(pts[b]),
                                            jnp.asarray(thr[b]), k_use,
                                            int(n)))
        jc = np.asarray(j_lrf.gicp_covariances_thr_t(
            jnp.asarray(pts[b]), jnp.asarray(thr[b]), k_use, eps, int(n)))
        dots = np.abs((nrm[b, :, :n].numpy() * jn[:, :n]).sum(0))
        assert np.median(dots) > 0.99999
        assert np.median(np.abs(cov6[b, :, :n].numpy() - jc[:, :n])) < 1e-4


def test_gicp_cov6_closed_form_and_quirk_match_jax():
    rng = np.random.default_rng(7)
    n = rng.normal(size=(2, 3, 64))
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    n[0, :, 0] = (-1.0, 0.0, 0.0)             # c < -0.99: identity quirk
    n[0, :, 1] = (-0.995, 0.0998749, 0.0)
    got = lrf.gicp_cov6_from_normals_t(_t(n), 1e-3).numpy()
    for b in range(2):
        np.testing.assert_allclose(
            got[b], np.asarray(j_lrf.gicp_cov6_from_normals_t(
                jnp.asarray(n[b]), 1e-3)), atol=1e-12)
    np.testing.assert_allclose(got[0, :, 0], [1e-3, 0, 0, 1, 0, 1],
                               atol=0)
    # the closed form is the rotation form of the exact route
    mats = lrf._cov6_to_mat(_t(got[1])[None])[0].numpy()
    Rx = lrf.rotation_from_e1_to_x(_t(n[1].T)).numpy()
    want = Rx @ np.diag([1e-3, 1.0, 1.0]) @ Rx.transpose(0, 2, 1)
    np.testing.assert_allclose(mats, want, atol=1e-12)
