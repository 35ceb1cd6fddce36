"""SHOT frames in the port (``ops/lrf.py``: ``shot_frames_dense``,
``shot_frames``, ``shot_truncated_count``) and the engine's SHOT route,
against the JAX package and the literal reference transcription
(``tests/oracles.shot_frame_oracle``), on the CPU.

The frames, at float64, on seed-made clouds (the JAX package's own
tests in ``tests/test_lrf.py`` read the absent bunny): the dense route
equals both the JAX package's and the oracle's to 1e-7, also where a
neighbourhood holds more points than the capped route's top-k and with
padded rows; the capped route equals the JAX package's.  The host check
of the capped route counts and warns as the JAX package's does.

The engine: ``lrf_method="shot"`` takes the exact route (sorted-kNN
normals and covariances), whatever ``exact_knn`` says, as the JAX
package turns its threshold route off for it.  Against the JAX CPU
route, per pair: equal iteration counts and 1e-9 deg at float64, equal
counts and 1e-3 deg at float32.  The radius is 1.0 in the scaled frame,
where every neighbourhood of these 420-480-point clouds holds at least 3
points: a neighbourhood of one or two points has a rank-deficient
covariance whose axes follow rounding, in either package.

On the card, SHOT at both ``shot_exact`` values on the captured program
gives the eager loop's bits with no host sync
(``tests/test_torch_gpu_program.py``).
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from se3_icp_tpu.models import registration as j_reg
from se3_icp_tpu.ops import lrf as j_lrf
from se3_icp_tpu.parallel import pairs as j_pairs

import oracles
import torch_port_cases as cases
from se3_icp_tpu_torch.datasets import fixtures
from se3_icp_tpu_torch.models import registration as reg
from se3_icp_tpu_torch.ops import lrf
from se3_icp_tpu_torch.parallel import pairs
from se3_icp_tpu_torch.utils.config import RegistrationConfig

torch.set_num_threads(2)

FRAME_TOL = 1e-7


def _surface(n, seed):
    return fixtures._bumpy_surface(np.random.default_rng(seed), n)


def _radius(pts, k=30):
    d, _ = cKDTree(pts).query(pts, k=k)
    return float(np.median(d[:, -1]))


def _dense(pts, radius, n_valid=None):
    """The port's dense frames of one cloud [N,3] (float64)."""
    n_valid = len(pts) if n_valid is None else n_valid
    return lrf.shot_frames_dense(torch.tensor(pts)[None], radius,
                                 torch.tensor([n_valid]))[0].numpy()


@pytest.mark.parametrize("cloud", ["surface", "beyond_cap"])
def test_dense_frames_match_jax_and_the_oracle(cloud):
    if cloud == "surface":
        pts = _surface(300, 7)
        radius = _radius(pts)
    else:
        # neighbourhoods denser than the capped route's 128
        pts = np.random.default_rng(8).normal(size=(400, 3))
        radius = 2.0
        assert lrf.shot_truncated_count(pts, radius, 128) > 0
    rot = _dense(pts, radius)
    theirs = np.asarray(j_lrf.shot_frames_dense(jnp.asarray(pts),
                                                radius)[0])
    ref = np.stack([oracles.shot_frame_oracle(pts, i, radius)
                    for i in range(len(pts))])
    np.testing.assert_allclose(rot, theirs, rtol=0, atol=FRAME_TOL)
    np.testing.assert_allclose(rot, ref, rtol=0, atol=FRAME_TOL)
    np.testing.assert_allclose(rot.transpose(0, 2, 1) @ rot,
                               np.broadcast_to(np.eye(3), rot.shape),
                               atol=1e-12)
    assert np.allclose(np.linalg.det(rot), 1.0)


def test_dense_frames_mask_padded_rows_per_pair():
    a, b = _surface(200, 9), _surface(240, 10)
    radius = _radius(a)
    batch = np.zeros((2, 256, 3))
    batch[0, :200], batch[1, :240] = a, b
    rot = lrf.shot_frames_dense(torch.tensor(batch), radius,
                                torch.tensor([200, 240])).numpy()
    np.testing.assert_allclose(rot[0, :200], _dense(a, radius), atol=1e-10)
    np.testing.assert_allclose(rot[1, :240], _dense(b, radius), atol=1e-10)
    for i, nv in ((0, 200), (1, 240)):
        theirs = np.asarray(j_lrf.shot_frames_dense(
            jnp.asarray(batch[i]), radius, n_valid=nv)[0])
        np.testing.assert_allclose(rot[i, :nv], theirs[:nv], rtol=0,
                                   atol=FRAME_TOL)


def test_capped_frames_match_jax():
    pts = _surface(300, 11)
    padded = np.concatenate([pts, np.zeros((20, 3))])
    radius = _radius(pts)
    for max_k in (16, 64):
        rot = lrf.shot_frames(torch.tensor(padded)[None], radius,
                              torch.tensor([300]), max_k=max_k)[0].numpy()
        theirs = np.asarray(j_lrf.shot_frames(
            jnp.asarray(padded), radius, max_k=max_k, n_valid=300)[0])
        np.testing.assert_allclose(rot[:300], theirs[:300], rtol=0,
                                   atol=FRAME_TOL)
    # with a cap no neighbourhood reaches, the capped route is the dense
    # one (the dense route's bisection band and the capped ranks agree)
    big = lrf.shot_frames(torch.tensor(pts)[None], radius,
                          torch.tensor([300]), max_k=299)[0].numpy()
    assert lrf.shot_truncated_count(pts, radius, 299) == 0
    np.testing.assert_allclose(big, _dense(pts, radius), atol=FRAME_TOL)


def _warned(fn):
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        fn()
    return [str(w.message) for w in got
            if issubclass(w.category, RuntimeWarning)]


def test_capped_route_counts_and_warns_as_jax():
    pts = _surface(300, 6)
    tgt = pts + np.float64([0.01, 0.0, 0.0])
    for r, k in ((1e3, 8), (1e-9, 8), (0.5, 8), (0.5, 40)):
        assert lrf.shot_truncated_count(pts, r, k) == \
            j_lrf.shot_truncated_count(pts, r, k)
    assert lrf.shot_truncated_count(pts, 1e3, 8) == 300
    assert lrf.shot_truncated_count(pts, 1e-9, 8) == 0
    kw = dict(lrf_method="shot", lrf_radius=10.0, shot_max_k=8,
              max_num_iterations=1, max_num_se3_iterations=1)
    for exact in (False, True):
        cfg = RegistrationConfig(shot_exact=exact, **kw)
        mine = _warned(lambda: reg.register_pair(
            pts, tgt, "se3_pt2pt", cfg, dtype=torch.float64, device="cpu"))
        theirs = _warned(lambda: j_reg.register_pair(
            pts, tgt, "se3_pt2pt", cases.JaxConfig(shot_exact=exact, **kw),
            dtype=jnp.float64))
        assert mine == theirs
        assert bool(mine) == (not exact)
        if mine:
            assert "shot_max_k=8" in mine[0]


ENGINE = [
    # (id, algorithm, config overrides, float64 cap, float32 cap)
    ("exact_pt2pl", "se3_pt2pl", {}, 601, 611),
    ("exact_gicp", "se3_gicp", {}, 602, 612),
    ("capped_pt2pl", "se3_pt2pl", {"shot_exact": False, "shot_max_k": 16},
     603, 613),
]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("case", ENGINE, ids=[c[0] for c in ENGINE])
def test_engine_with_shot_frames_matches_jax(case, dtype):
    _, alg, ckw, cap64, cap32 = case
    probs = cases.problems("bumpy", {})
    pair_list = [(p.source, p.target) for p in probs]
    jcfg, cfg = cases.configs(
        {"lrf_method": "shot", "lrf_radius": 1.0, **ckw},
        cap64 if dtype == "float64" else cap32)
    dt = np.dtype(dtype)
    j_res = j_pairs.register_pairs(pair_list, alg, jcfg, mesh=None,
                                   dtype=dt)
    t_res = pairs.register_pairs(pair_list, alg, cfg, dtype=dt,
                                 device="cpu")
    tol = (1e-9, 1e-10) if dtype == "float64" else (1e-3, 1e-4)
    cases.hold(probs, j_res, t_res, *tol)
    if dtype == "float64":
        # the SHOT route is the exact route whatever exact_knn says
        again = pairs.register_pairs(pair_list, alg, cfg, dtype=dt,
                                     device="cpu", exact_knn=True)
        for a, b in zip(t_res, again):
            np.testing.assert_array_equal(a.transformation,
                                          b.transformation)
