"""The pt2pt step's rotation without an SVD (``ops/solve.kabsch3``, Horn's
quaternion form), held on the CPU against the JAX package's
``solve_pt2pt_from_moments``, whose rotation is LAPACK's SVD with
Kabsch's reflection fix.

The moments come from seed-made correspondence sets, the targets a
rotated (or reflected) and shifted copy of the sources plus noise:
3-D clouds (full-rank H), planar ones (rank 2), collinear ones (rank 1),
reflected ones (det H < 0), and an H of zeros or with a non-finite entry.
Where the rotation is unique (rank H >= 2; det H < 0 with a simple
smallest singular value) the two transforms agree to rounding: 1e-12 rad
and 1e-12 in translation (scaled by 1 + |t|) in float64; 1e-5 rad and
1e-5 in float32, where on these sets the two rotations differ by at
most 4.6e-6 rad, each within 3.7e-6 rad of the float64 answer (the
float32 SVD's own rounding is of that size).  A rank-1 H has a circle
of optimal rotations: the port's must be a rotation with the same
objective tr(R^T H).  An H of
zeros gives R = I, as LAPACK's; a non-finite H or too few weights give
the identity transform through ``ok`` (the JAX function is not run on a
non-finite H: LAPACK may not return on one).  No ``torch.linalg``
function runs.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se3_icp_tpu.ops import solve as j_solve
from se3_icp_tpu_torch.ops import solve

torch.set_num_threads(1)

TOL = {np.float64: 1e-12, np.float32: 1e-5}
N_SETS = 64


def _rotation(rng) -> np.ndarray:
    q = rng.normal(size=4)
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def _moments(kind: str, seed: int, dtype):
    """(H [B,3,3], mu_s [B,3], mu_t [B,3], wsum [B]) of N_SETS weighted
    correspondence sets of one kind."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(N_SETS):
        n = 200
        s = rng.normal(size=(n, 3)) * rng.uniform(0.2, 3.0, 3)
        if kind == "planar":
            s[:, 2] = 0.0
        elif kind == "collinear":
            s = rng.normal(size=(n, 1)) * rng.normal(size=(1, 3))
        s = s @ _rotation(rng).T + rng.normal(size=3)
        M = _rotation(rng)
        if kind == "reflected":
            M = M @ np.diag([1.0, 1.0, -1.0])
        t = s @ M.T + rng.normal(size=3) + 0.01 * rng.normal(size=(n, 3))
        w = (rng.uniform(size=n) < 0.8).astype(np.float64)
        mu_s = (w[:, None] * s).sum(0) / w.sum()
        mu_t = (w[:, None] * t).sum(0) / w.sum()
        H = ((t - mu_t) * w[:, None]).T @ (s - mu_s)
        out.append((H, mu_s, mu_t, w.sum()))
    return tuple(np.stack(x).astype(dtype) for x in zip(*out))


def _jax(H, mu_s, mu_t, wsum):
    f = jax.vmap(j_solve.solve_pt2pt_from_moments)
    return np.asarray(f(jnp.asarray(H), jnp.asarray(mu_s),
                        jnp.asarray(mu_t), jnp.asarray(wsum)))


def _port(H, mu_s, mu_t, wsum, monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("a torch.linalg function ran")
    for name in ("svd", "det", "eigh", "qr", "svdvals"):
        monkeypatch.setattr(torch.linalg, name, refuse)
    T = solve.solve_pt2pt_from_moments(*(torch.from_numpy(x) for x in
                                         (H, mu_s, mu_t, wsum)))
    monkeypatch.undo()
    return T.numpy()


def _angles(Ra, Rb) -> np.ndarray:
    """Rotation angles of Ra^T Rb, [B] (atan2 form: exact near 0)."""
    M = np.swapaxes(Ra, -1, -2).astype(np.float64) @ Rb.astype(np.float64)
    skew = np.stack([M[:, 2, 1] - M[:, 1, 2], M[:, 0, 2] - M[:, 2, 0],
                     M[:, 1, 0] - M[:, 0, 1]], -1)
    cos = (np.trace(M, axis1=1, axis2=2) - 1.0) / 2.0
    return np.arctan2(np.linalg.norm(skew, axis=-1) / 2.0, cos)


@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["float64", "float32"])
@pytest.mark.parametrize("kind", ["full", "planar", "reflected"])
def test_kabsch3_gives_the_svd_rotation(kind, dtype, monkeypatch):
    H, mu_s, mu_t, wsum = _moments(kind, 7, dtype)
    if kind == "planar":
        rank_tol = 1e-9 if dtype == np.float64 else 1e-6
        assert (np.linalg.svd(H.astype(np.float64))[1][:, 2]
                < rank_tol * np.abs(H).max()).all()
    if kind == "reflected":
        assert (np.linalg.det(H.astype(np.float64)) < 0).all()
    want = _jax(H, mu_s, mu_t, wsum)
    got = _port(H, mu_s, mu_t, wsum, monkeypatch)
    assert got.dtype == want.dtype == dtype
    tol = TOL[dtype]
    assert _angles(want[:, :3, :3], got[:, :3, :3]).max() <= tol
    scale = 1.0 + np.abs(want[:, :3, 3]).max()
    assert np.abs(got[:, :3, 3] - want[:, :3, 3]).max() <= tol * scale
    assert (got[:, 3] == np.array([0, 0, 0, 1], dtype)).all()


@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["float64", "float32"])
def test_kabsch3_rank_one_gives_an_optimal_rotation(dtype, monkeypatch):
    H, mu_s, mu_t, wsum = _moments("collinear", 11, dtype)
    want = _jax(H, mu_s, mu_t, wsum)
    got = _port(H, mu_s, mu_t, wsum, monkeypatch)
    R = got[:, :3, :3].astype(np.float64)
    eye = np.eye(3)
    assert np.abs(np.swapaxes(R, 1, 2) @ R - eye).max() <= 10 * TOL[dtype]
    assert np.abs(np.linalg.det(R) - 1.0).max() <= 10 * TOL[dtype]

    def objective(Rs):
        return np.einsum("bij,bij->b", Rs.astype(np.float64),
                         H.astype(np.float64))
    top = np.linalg.svd(H.astype(np.float64))[1][:, 0]
    assert np.abs(objective(R) - objective(want[:, :3, :3])).max() \
        <= 10 * TOL[dtype] * top.max()
    # the translation follows the rotation: mu_t = R mu_s + t
    res = mu_t - np.einsum("bij,bj->bi", R, mu_s) - got[:, :3, 3]
    assert np.abs(res).max() <= 10 * TOL[dtype] * (1 + np.abs(mu_t).max())


@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["float64", "float32"])
def test_kabsch3_degenerate_moments(dtype, monkeypatch):
    H, mu_s, mu_t, wsum = _moments("full", 13, dtype)
    H, mu_s, mu_t, wsum = H[:5].copy(), mu_s[:5], mu_t[:5], wsum[:5].copy()
    H[0] = 0.0                   # zero moments, enough weights: R = I
    H[1, 1, 2] = np.nan          # non-finite: identity through ok
    H[2, 0, 0] = np.inf
    wsum[3] = 2.0                # too few weights: identity through ok
    got = _port(H, mu_s, mu_t, wsum, monkeypatch)
    fin = [0, 3, 4]
    want = _jax(H[fin], mu_s[fin], mu_t[fin], wsum[fin])
    eye = np.eye(4, dtype=dtype)
    assert np.array_equal(got[0, :3, :3], eye[:3, :3])
    assert np.abs(got[0, :3, 3] - (mu_t[0] - mu_s[0])).max() \
        <= TOL[dtype] * (1 + np.abs(mu_t[0]).max())
    assert np.abs(got[0] - want[0]).max() \
        <= TOL[dtype] * (1 + np.abs(mu_t[0]).max())
    for b in (1, 2, 3):
        assert np.array_equal(got[b], eye)
    assert np.array_equal(want[1], eye)
    assert _angles(want[2:, :3, :3], got[4:, :3, :3]).max() <= TOL[dtype]


def test_kabsch3_squarings_suffice_for_thin_sets():
    """A correspondence set with sigma2 / sigma1 = 1e-6 (nearly
    collinear): the float64 squarings still reach the SVD's rotation to
    the conditioning's rounding (eps * sigma1 / sigma2)."""
    rng = np.random.default_rng(5)
    Hs = []
    for _ in range(N_SETS):
        U, V = _rotation(rng), _rotation(rng)
        Hs.append(U @ np.diag([1.0, 1e-6, 0.0]) @ V.T)
    H = torch.from_numpy(np.stack(Hs))
    U, _, Vt = np.linalg.svd(np.stack(Hs))
    d = np.sign(np.linalg.det(U) * np.linalg.det(Vt))
    want = U @ (np.eye(3) * np.stack([np.ones_like(d), np.ones_like(d), d],
                                     -1)[:, None]) @ Vt
    got = solve.kabsch3(H).numpy()
    assert _angles(want, got).max() <= 1e-16 / 1e-6 * 100
    assert math.isclose(np.linalg.det(got).min(), 1.0, abs_tol=1e-12)
