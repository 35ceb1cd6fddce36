"""The 1-NN kernels' plain versions (``ops/cuda_nn.py``: K6 batched,
K9 one cloud, K7 with the matched payload row, K8 against the packed
dual-phase targets -- the CUDA kernels need the card) against the JAX
package's Pallas kernels ``pallas_knn._kernel_batched``, ``_kernel``,
``_kernel_match`` and ``_kernel_match_packed`` run through the
callback-free interpret gate (``SE3_ICP_TPU_PALLAS_INTERPRET=1``) on the
CPU, at the widths their paths use: D = 3 (multistart scoring, the
metrics), 12 (the engine's embedding) and 33 (FGR's FPFH features).
Targets are padded (n_targets < Nt) and the padded rows hold garbage.

Tolerances.  Both sides compute the shifted distance |t|^2 - 2 q.t and
add |q|^2 back, in float32-exact products (plain float32 here,
limb-packed bf16 there) summed in other orders: d2 agrees to 1e-5 of
|q|^2 + max |t|^2, the terms the form cancels.  An index may differ
only where the two targets' float64 distances are within twice that, at
most 1% of the rows; a matched payload row is a copy of the indexed
target's row, bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from se3_icp_tpu.ops import knn as j_knn
from se3_icp_tpu.ops import pallas_knn as pk

from se3_icp_tpu_torch.datasets import fixtures
from se3_icp_tpu_torch.models import fgr
from se3_icp_tpu_torch.ops import _build, cuda_knn, cuda_nn, knn

# the suite runs several worker processes side by side: keep each
# one's torch thread pool small
torch.set_num_threads(1)

pytestmark = pytest.mark.usefixtures("interpret_mode")

D2_REL = 1e-5
FLIP_SHARE = 0.01
NT, N_TGT = 512, (470, 401)


@pytest.fixture()
def interpret_mode(monkeypatch):
    """The package's own interpret gate (plain ``interpret=True``
    evaluation of every pallas_call): no host callbacks."""
    monkeypatch.setenv("SE3_ICP_TPU_FORCE_PALLAS", "1")
    monkeypatch.setenv("SE3_ICP_TPU_PALLAS_INTERPRET", "1")


def _clouds(d, seed=0):
    """(queries [2,Nq,d], targets [2,NT,d], n_targets [2]) float32 at
    width d, padded target rows filled with noise."""
    rng = np.random.default_rng(seed)
    probs = [fixtures.golden_shape_problem(seed=seed + b + 1, n=n)
             for b, n in enumerate(N_TGT)]
    q = np.zeros((2, NT, 3))
    t = rng.normal(size=(2, NT, 3)) * 50.0           # garbage padding
    for b, p in enumerate(probs):
        n = len(p.source)
        tilt = fixtures.rot_3d(*rng.normal(size=3) * 0.02)
        q[b, :n] = p.source @ (p.T_gt[:3, :3] @ tilt).T + p.T_gt[:3, 3]
        q[b, n:] = rng.normal(size=(NT - n, 3))
        t[b, :n] = p.target
    if d == 3:
        return (q.astype(np.float32), t.astype(np.float32),
                np.asarray(N_TGT, np.int32))
    if d == 12:
        def emb(x):
            r, _ = np.linalg.qr(rng.normal(size=x.shape[:2] + (3, 3)))
            return np.concatenate(
                [3.0 * np.swapaxes(r, -1, -2).reshape(x.shape[:2] + (9,)),
                 x], -1)
        return (emb(q).astype(np.float32), emb(t).astype(np.float32),
                np.asarray(N_TGT, np.int32))
    # d == 33: FPFH features of the same clouds (padded rows at 1e6)
    n = torch.as_tensor(np.asarray(N_TGT, np.int32))
    cfg = fgr.FGRConfig(normals_knn=20, fpfh_knn=40)
    fq = fgr.features(torch.as_tensor(q, dtype=torch.float32), n, cfg)
    ft = fgr.features(torch.as_tensor(t, dtype=torch.float32), n, cfg)
    return fq.numpy(), ft.numpy(), np.asarray(N_TGT, np.int32)


def _hold(q, t, n, idx_p, d2_p, idx_j, d2_j, rows):
    """Port against JAX on the query rows ``rows[b]`` of each pair."""
    for b in range(q.shape[0]):
        r = slice(0, rows[b])
        qb = q[b, r].astype(np.float64)
        tb = t[b, :n[b]].astype(np.float64)
        scale = (qb * qb).sum(-1) + (tb * tb).sum(-1).max() + 1.0
        np.testing.assert_array_less(
            np.abs(d2_p[b, r] - d2_j[b, r]) / scale, D2_REL)
        assert (idx_p[b, r] < n[b]).all() and (idx_j[b, r] < n[b]).all()
        differ = idx_p[b, r] != idx_j[b, r]
        assert differ.mean() <= FLIP_SHARE, differ.sum()
        dp = ((qb[differ] - tb[idx_p[b, r][differ]]) ** 2).sum(-1)
        dj = ((qb[differ] - tb[idx_j[b, r][differ]]) ** 2).sum(-1)
        assert (np.abs(dp - dj) <= 2 * D2_REL * scale[differ]).all()


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.mark.parametrize("d", [3, 12, 33])
def test_nn_argmin_batched_matches_jax_kernel(d):
    q, t, n = _clouds(d)
    assert pk._interpret()
    ji, jd = pk.nn_argmin_pallas_batched(jnp.asarray(q), jnp.asarray(t),
                                         jnp.asarray(n))
    pi, pd = cuda_nn.nn_argmin_batched(_t(q), _t(t), _t(n))
    assert pi.dtype == torch.int32 and pi.shape == (2, NT)
    # padded queries of FPFH (1e6 rows) are far from everything: no
    # meaningful nearest target
    rows = n if d == 33 else (NT, NT)
    _hold(q, t, n, pi.numpy(), pd.numpy(), np.asarray(ji), np.asarray(jd),
          rows)


@pytest.mark.parametrize("d", [3, 12])
def test_nn_argmin_unbatched_matches_jax_kernel(d):
    q, t, n = _clouds(d, seed=4)
    ji, jd = pk.nn_argmin_pallas(jnp.asarray(q[0]), jnp.asarray(t[0]),
                                 int(n[0]))
    pi, pd = cuda_nn.nn_argmin_unbatched(_t(q[0]), _t(t[0]), int(n[0]))
    assert pi.shape == (NT,)
    _hold(q[:1], t[:1], n[:1], pi.numpy()[None], pd.numpy()[None],
          np.asarray(ji)[None], np.asarray(jd)[None], (NT,))
    # the dispatcher takes one cloud to K9 and a batch to K6
    ki, kd = knn.nn_argmin(_t(q[0]), _t(t[0]), int(n[0]))
    np.testing.assert_array_equal(ki.numpy(), pi.numpy())
    bi, _ = knn.nn_argmin(_t(q), _t(t), _t(n))
    np.testing.assert_array_equal(bi[0].numpy(), pi.numpy())


@pytest.mark.parametrize("d", [3, 12])
def test_nn_match_batched_matches_jax_kernel(d):
    q, t, n = _clouds(d, seed=7)
    rng = np.random.default_rng(9)
    pay = rng.normal(size=(2, NT, 9)).astype(np.float32)
    ji, jd, jm = pk.nn_match_pallas_batched(
        jnp.asarray(q), jnp.asarray(t), jnp.asarray(pay), jnp.asarray(n))
    pi, pd, pm = knn.nn_match(_t(q), _t(t), _t(pay), _t(n))
    pi, pd, pm = pi.numpy(), pd.numpy(), pm.numpy()
    jm = np.asarray(jm)
    _hold(q, t, n, pi, pd, np.asarray(ji), np.asarray(jd), (NT, NT))
    for b in range(2):
        np.testing.assert_array_equal(pm[b], pay[b, pi[b]])
        np.testing.assert_array_equal(jm[b], pay[b, np.asarray(ji)[b]])


def test_nn_match_packed_matches_jax_kernel():
    """K8 on both phases of one packing: pair 0 in the SE(3) block,
    pair 1 in the R3 block (rotation columns zero)."""
    q, t_a, n = _clouds(12, seed=11)
    t_b = t_a.copy()
    t_b[..., :9] = 0.0
    q_ph = q.copy()
    q_ph[1, :, :9] = 0.0
    rng = np.random.default_rng(12)
    pay = rng.normal(size=(2, NT, 9)).astype(np.float32)
    phase = np.asarray([0, 1], np.int32)
    packed = jax.vmap(pk.pack_match_targets, in_axes=(0, 0, 0, 0, None))(
        jnp.asarray(t_a), jnp.asarray(t_b), jnp.asarray(pay),
        jnp.asarray(n), NT)
    ji, jd, jm = pk.nn_match_packed(jnp.asarray(q_ph), *packed,
                                    jnp.asarray(phase))
    targets = cuda_knn.pack_match_targets(_t(t_a), _t(t_b), _t(pay), _t(n))
    pi, pd, pm = knn.nn_match_packed(_t(q_ph), targets, _t(phase))
    pi, pd, pm = pi.numpy(), pd.numpy(), pm.numpy()
    t_sel = np.stack([t_a[0], t_b[1]])
    _hold(q_ph, t_sel, n, pi, pd, np.asarray(ji), np.asarray(jd), (NT, NT))
    for b in range(2):
        np.testing.assert_array_equal(pm[b], pay[b, pi[b]])
        same = pi[b] == np.asarray(ji)[b]
        np.testing.assert_array_equal(pm[b][same], np.asarray(jm)[b][same])


def test_ties_go_to_the_lowest_index_as_in_the_jax_kernel():
    """Exact duplicates of the nearest target, one past the valid
    count: the lowest valid index wins on both sides."""
    rng = np.random.default_rng(2)
    t = rng.normal(size=(1, 300, 3)).astype(np.float32) * 10.0
    t[0, [40, 130, 290]] = t[0, 7]
    q = (t[:, [7] * 5] + 1e-3 * rng.normal(size=(1, 5, 3))).astype(
        np.float32)
    n = np.asarray([200], np.int32)
    ji, _ = pk.nn_argmin_pallas_batched(jnp.asarray(q), jnp.asarray(t),
                                        jnp.asarray(n))
    pi, _ = cuda_nn.nn_argmin_batched(_t(q), _t(t), _t(n))
    assert pi.tolist() == np.asarray(ji).tolist() == [[7] * 5]
    ki, _ = knn.nn_argmin(_t(q[0]), _t(t[0]), 6)     # 7 masked out
    assert (ki < 6).all()


def test_nn_distances_matches_jax_and_pads_widths():
    q, t, n = _clouds(3, seed=5)
    valid = np.arange(NT) < n[0]
    got = knn.nn_distances(_t(q[0]), _t(t[0]), _t(valid))
    want = j_knn.nn_distances(jnp.asarray(q[0]), jnp.asarray(t[0]),
                              jnp.asarray(valid))
    scale = (q[0] ** 2).sum(-1) + (t[0, :n[0]] ** 2).sum(-1).max() + 1.0
    np.testing.assert_array_less(np.abs(got.numpy() - np.asarray(want))
                                 / scale, D2_REL)
    # widths the kernel lacks pad with zero columns: the same search (the
    # kernel's FMA chain adds the zero products exactly; a CPU matrix
    # product may block the longer sum otherwise, hence the tolerance)
    x = torch.randn(2, 50, 5)
    wide = knn._pad_width(x)
    assert wide.shape == (2, 50, 12) and not wide[..., 5:].any()
    n2 = torch.tensor([50, 40], dtype=torch.int32)
    a = cuda_nn.nn_argmin_batched(x, x.flip(1), n2)
    b = cuda_nn.nn_argmin_batched(wide, wide.flip(1), n2)
    assert torch.equal(a[0], b[0])
    torch.testing.assert_close(a[1], b[1], atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="exceeds"):
        knn._pad_width(torch.zeros(1, 2, 65))


def test_wrappers_launch_nothing_on_the_cpu():
    """On CPU tensors the 1-NN wrappers take their plain versions; the
    counts stay as they were."""
    wrappers = (cuda_nn.nn_argmin_batched, cuda_nn.nn_argmin_unbatched,
                cuda_nn.nn_match_batched, cuda_nn.nn_match_packed)
    assert {w.__name__ for w in wrappers} <= set(_build.COUNTED)
    before = _build.launches()
    q, t, n = _clouds(3, seed=6)
    knn.nn_argmin(_t(q), _t(t), _t(n))
    knn.nn_argmin(_t(q[0]), _t(t[0]))
    knn.nn_match(_t(q), _t(t), _t(t), _t(n))
    targets = cuda_knn.pack_match_targets(
        _t(np.zeros((2, NT, 12), np.float32)),
        _t(np.zeros((2, NT, 12), np.float32)), _t(t), _t(n))
    knn.nn_match_packed(_t(np.zeros((2, 8, 12), np.float32)), targets,
                        torch.tensor([0, 1], dtype=torch.int32))
    assert _build.launches() == before
