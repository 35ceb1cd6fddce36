"""The port's metrics (``utils/metrics.py``) and cross-route LRF
evaluation (``utils/lrf_eval.py``) against the JAX package's, on the CPU.

The rotation and transform metrics run in float64 on both sides and
agree to 1e-9.  The 1-NN metrics search in float32 (K9's plain version
here; the JAX package's unbatched 1-NN is its XLA search off the TPU):
squared distances agree to 1e-5 of |q|^2 + max |t|^2 and an index may
differ only between targets within that of each other (checked in
float64).  The LRF evaluation: the exact-route frames agree to 1e-3 deg
at the median (measured 8e-5, worst 5.6e-3); the threshold route's K1
rounds its distances otherwise than the JAX package's limb-packed one and
~1% of the balls hold one member more or less
(``test_torch_thresholds.py``), so those frames are held at the median
(measured 1.9e-4 deg) and by the share of points more than 1 deg off (at
most 3%; measured 1.2%, the worst 38 deg: an x-axis that a changed
member turns).  The cross-cloud errors keep the same correspondences and
their medians agree to 5% (measured: 24.857 / 24.855 deg threshold
route, 24.821 / 24.821 exact).
"""

import numpy as np
import pytest
import torch

from se3_icp_tpu.utils import lrf_eval as j_lrf_eval
from se3_icp_tpu.utils import metrics as j_metrics

from se3_icp_tpu_torch.datasets import fixtures
from se3_icp_tpu_torch.utils import lrf_eval, metrics

# the suite runs several worker processes side by side: keep each
# one's torch thread pool small
torch.set_num_threads(1)

CPU = dict(device="cpu")


def _rotations(rng, n):
    q, _ = np.linalg.qr(rng.normal(size=(n, 3, 3)))
    q[:, :, 0] *= np.sign(np.linalg.det(q))[:, None]
    return q


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_rotation_and_transform_metrics_match_jax():
    rng = np.random.default_rng(0)
    R1, R2 = _rotations(rng, 64), _rotations(rng, 64)
    R2[0] = R1[0]                                        # zero error
    # a half-turn apart, and near it (the log's near-pi branch)
    flip = fixtures.rot_3d(np.pi, 0.0, 0.0)
    R2[1] = R1[1] @ flip
    R2[2] = R1[2] @ fixtures.rot_3d(np.pi - 5e-4, 0.0, 0.0)
    # the euler singularity (m10 beyond +-0.998)
    R1[3] = fixtures.rot_3d(0.1, 0.2, np.pi / 2)
    t1, t2 = rng.normal(size=(2, 64, 3))
    for name in ("angular_error_so3", "angular_error_so3_alt",
                 "rotation_frobenius_error", "avg_euler_error"):
        np.testing.assert_allclose(
            _np(getattr(metrics, name)(R1, R2, **CPU)),
            np.asarray(getattr(j_metrics, name)(R1, R2)), atol=1e-9,
            err_msg=name)
    np.testing.assert_allclose(_np(metrics.rot2euler_yzx(R1, **CPU)),
                               np.asarray(j_metrics.rot2euler_yzx(R1)),
                               atol=1e-12)
    np.testing.assert_allclose(_np(metrics.translation_error(t1, t2, **CPU)),
                               np.asarray(j_metrics.translation_error(t1, t2)),
                               atol=1e-12)
    T1 = np.tile(np.eye(4), (64, 1, 1))
    T2 = T1.copy()
    T1[:, :3, :3], T1[:, :3, 3] = R1, t1
    T2[:, :3, :3], T2[:, :3, 3] = R1 @ fixtures.rot_3d(0.01, 0, 0), \
        t1 + 0.1 * t2
    assert _np(metrics.success(T1, T2, **CPU)).tolist() == np.asarray(
        j_metrics.success(T1, T2)).tolist()
    pts = rng.normal(size=(300, 3))
    np.testing.assert_allclose(
        _np(metrics.error_filterreg(pts, T1[5], T2[5], **CPU)),
        np.asarray(j_metrics.error_filterreg(pts, T1[5], T2[5])), atol=1e-12)
    want = j_metrics.evaluate_trajectory_quality(T1, T2)
    got = metrics.evaluate_trajectory_quality(T1, T2, **CPU)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-9), k


def _pair(seed, n, **kw):
    p = fixtures.golden_shape_problem(seed=seed, n=n, **kw)
    return (p.source.astype(np.float32), p.target.astype(np.float32),
            p.T_gt)


def _held_indices(q, t, got, want, tol=1e-5):
    q = q.astype(np.float64)
    t = t.astype(np.float64)
    differ = got != want
    assert differ.mean() <= 0.01
    scale = (q[differ] ** 2).sum(-1) + (t ** 2).sum(-1).max() + 1.0
    dg = ((q[differ] - t[got[differ]]) ** 2).sum(-1)
    dw = ((q[differ] - t[want[differ]]) ** 2).sum(-1)
    assert (np.abs(dg - dw) <= 2 * tol * scale).all()


def test_nearest_neighbour_metrics_match_jax():
    src, tgt, T = _pair(3, 450, noise_std=0.01, resample=True)
    moved = (src @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
    # padded clouds with valid masks, as the benchmark protocols pass them
    pad = lambda x: np.concatenate([x, np.full((62, 3), 7.0, np.float32)])
    sv = np.arange(512) < 450
    got = metrics.chamfer_distance_sq(pad(moved), pad(tgt), sv, sv, **CPU)
    want = j_metrics.chamfer_distance_sq(pad(moved), pad(tgt), sv, sv)
    assert float(got) == pytest.approx(float(want), rel=1e-4, abs=1e-6)
    assert float(got) == pytest.approx(float(
        metrics.chamfer_distance_sq(moved, tgt, **CPU)), rel=1e-6)
    c_got = _np(metrics.compute_corrs_with_gt(src, pad(tgt), T, sv, **CPU))
    c_want = np.asarray(j_metrics.compute_corrs_with_gt(src, pad(tgt),
                                                        T.astype(np.float32),
                                                        sv))
    assert c_got.dtype == np.int32 and c_got.shape == (450, 2)
    np.testing.assert_array_equal(c_got[:, 0], np.arange(450))
    _held_indices(moved, tgt, c_got[:, 1], c_want[:, 1])
    n_got = _np(metrics.compute_nearest_neighbor_correspondences(
        src, tgt, **CPU))
    n_want = np.asarray(j_metrics.compute_nearest_neighbor_correspondences(
        src, tgt))
    _held_indices(src, tgt, n_got[:, 1], n_want[:, 1])


def test_evaluate_lrf_quality_matches_jax():
    rng = np.random.default_rng(4)
    fs, ft = _rotations(rng, 200), _rotations(rng, 200)
    T = np.eye(4)
    T[:3, :3] = _rotations(rng, 1)[0]
    corr = np.stack([rng.permutation(200), rng.permutation(200)], 1)
    got = metrics.evaluate_lrf_quality(fs, ft, T, corr, **CPU)
    want = j_metrics.evaluate_lrf_quality(fs, ft, T, corr)
    assert float(got) == pytest.approx(float(want), abs=1e-9)


def test_lrf_eval_routes_match_jax(monkeypatch):
    monkeypatch.setenv("SE3_ICP_TPU_FORCE_PALLAS", "1")
    monkeypatch.setenv("SE3_ICP_TPU_PALLAS_INTERPRET", "1")
    pts = fixtures.golden_shape_problem(seed=2, n=420).source
    k = 90
    ex = _np(lrf_eval.toldi_frames_exact_route(pts, k, **CPU))
    ex_j = j_lrf_eval.toldi_frames_exact_route(pts, k)
    th = _np(lrf_eval.toldi_frames_thr_route(pts, k, **CPU))
    th_j = j_lrf_eval.toldi_frames_thr_route(pts, k)
    assert ex.shape == th.shape == (420, 3, 3)
    # the log-map error: trace-acos is float32 noise (~1e-2 deg) near 0
    ang = lambda a, b: _np(metrics.angular_error_so3(
        torch.as_tensor(np.array(a), dtype=torch.float64),
        torch.as_tensor(np.array(b), dtype=torch.float64), **CPU))
    assert np.median(ang(ex, ex_j)) < 1e-3
    e = ang(th, th_j)
    assert np.median(e) < 1e-3 and (e > 1.0).mean() <= 0.03


def test_cross_cloud_lrf_errors_match_jax(monkeypatch):
    """Both routes on a noisy, independently resampled pair, against the
    JAX package's evaluation (its GT correspondences from scipy's k-d
    tree in float64, the port's from its float32 1-NN)."""
    monkeypatch.setenv("SE3_ICP_TPU_FORCE_PALLAS", "1")
    monkeypatch.setenv("SE3_ICP_TPU_PALLAS_INTERPRET", "1")
    p = fixtures.golden_shape_problem(seed=5, n=420, noise_std=0.01,
                                      resample=True)
    got = lrf_eval.cross_cloud_lrf_errors(p.source, p.target, p.T_gt,
                                          inlier=0.1, **CPU)
    want = j_lrf_eval.cross_cloud_lrf_errors(p.source, p.target, p.T_gt,
                                             inlier=0.1)
    for name in ("thr", "exact"):
        assert len(got[name]) == len(want[name]) > 100, name
        assert np.median(got[name]) == pytest.approx(
            np.median(want[name]), rel=0.05), name


def test_metrics_run_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    R = np.eye(3)
    with pytest.raises(RuntimeError, match="CUDA"):
        metrics.angular_error_so3(R, R)
    with pytest.raises(RuntimeError, match="CUDA"):
        lrf_eval.toldi_frames_exact_route(np.zeros((10, 3)), 9)
    assert float(metrics.angular_error_so3(R, R, **CPU)) == 0.0
