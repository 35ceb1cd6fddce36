"""The port's fused match (``ops/cuda_knn.py``, plain version -- the
CUDA kernel needs the card) against the JAX package's Pallas kernel
``pallas_knn._kernel_match_affine`` run in interpret mode on the CPU.

The same float32 arrays go through both: seed-made "room" scenes with
random frames, padded targets (n_tgt < Nt), packed into the dual-phase
12-D embeddings and a 9-wide payload as the engine packs them.

Tolerances.  Both sides compute the shifted distance -2 q.t + |t|^2 in
float32-exact products but add in different orders, so d2 agrees to a
few float32 ulps of |q|^2 + |t|^2 (~40 here): 1e-4 absolute.  The
matched payload row is a copy of one target's row, so it agrees to the
last bit -- except where the two nearest targets are closer to each
other (in d2) than that rounding; such rows may pick the other target,
are checked to be near-ties, and may be at most 1% of the rows.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from se3_icp_tpu.ops import pallas_knn as pk

from se3_icp_tpu_torch.datasets import fixtures
from se3_icp_tpu_torch.ops import cuda_knn

# the suite runs several worker processes side by side: keep each
# one's torch thread pool small
torch.set_num_threads(1)

pytestmark = pytest.mark.usefixtures("interpret_mode")


@pytest.fixture()
def interpret_mode(monkeypatch):
    """The package's own interpret gate (plain ``interpret=True``
    evaluation of every pallas_call, as its engine tests use): it runs no
    host callbacks, unlike ``pltpu.force_tpu_interpret_mode``."""
    monkeypatch.setenv("SE3_ICP_TPU_FORCE_PALLAS", "1")
    monkeypatch.setenv("SE3_ICP_TPU_PALLAS_INTERPRET", "1")


B, NQ, NT, P = 2, 384, 512, 9
N_TGT = (512, 461)
ALPHA, BETA = 3.0, 1.25


def _rand_rots(rng, n):
    q, _ = np.linalg.qr(rng.normal(size=(n, 3, 3)))
    q[:, :, 0] *= np.sign(np.linalg.det(q))[:, None]
    return q


def _problem(seed):
    """Engine-shaped inputs of one match call, float32."""
    rng = np.random.default_rng(seed)
    src = np.stack([fixtures._scene(rng, NQ, "room") for _ in range(B)])
    tgt = np.stack([fixtures._scene(rng, NT, "room") for _ in range(B)])
    src -= src.mean(1, keepdims=True)
    tgt -= tgt.mean(1, keepdims=True)
    rs = _rand_rots(rng, B * NQ).reshape(B, NQ, 3, 3)
    rt = _rand_rots(rng, B * NT).reshape(B, NT, 3, 3)
    colmaj = lambda r: np.swapaxes(r, -1, -2).reshape(r.shape[:2] + (9,))
    feat = np.concatenate([colmaj(rs), src, np.ones((B, NQ, 1)),
                           np.zeros((B, NQ, 3))], -1)
    emb_a = np.concatenate([colmaj(rt) * ALPHA, tgt * BETA], -1)
    emb_b = np.concatenate([np.zeros((B, NT, 9)), tgt], -1)
    pay = np.concatenate([tgt, tgt * BETA, rng.normal(size=(B, NT, 3))], -1)
    # per-pair W(R, t, alpha, beta, phase): pair 0 in the SE(3) phase,
    # pair 1 after the switch
    R = _rand_rots(rng, B)
    t = rng.normal(size=(B, 3)) * 0.1
    w = np.zeros((B, 16, 16))
    for b, switched in enumerate((False, True)):
        blk = (0.0 if switched else ALPHA) * R[b].T
        for o in (0, 3, 6):
            w[b, o:o + 3, o:o + 3] = blk
        w[b, 9:12, 9:12] = (1.0 if switched else BETA) * R[b].T
        w[b, 12, 9:12] = t[b]
    f32 = lambda a: np.ascontiguousarray(a, np.float32)
    return (f32(feat), f32(w), f32(emb_a), f32(emb_b), f32(pay),
            np.asarray(N_TGT, np.int32))


def _jax_match(feat, w, emb_a, emb_b, pay, n_t, phase):
    packed = jax.vmap(pk.pack_match_targets, in_axes=(0, 0, 0, 0, None))(
        jnp.asarray(emb_a), jnp.asarray(emb_b), jnp.asarray(pay),
        jnp.asarray(n_t), feat.shape[1])
    assert pk._interpret()
    d2, mt = pk.nn_match_affine(jnp.asarray(feat), jnp.asarray(w),
                                *packed, jnp.asarray(phase))
    return np.asarray(d2), np.asarray(mt)


def _port_match(feat, w, emb_a, emb_b, pay, n_t, phase):
    t = torch.as_tensor
    targets = cuda_knn.pack_match_targets(t(emb_a), t(emb_b), t(pay), t(n_t))
    assert targets.emb.shape == (B, 2, emb_a.shape[1], 12)
    assert targets.tn.shape == (B, 2, emb_a.shape[1])
    d2, mt = cuda_knn.nn_match_affine(t(feat), t(w), targets, t(phase))
    return d2.numpy(), mt.numpy()


def _exact_top2_gap(feat, w, emb, n):
    """float64 gap between the two smallest squared distances."""
    q = (feat.astype(np.float64) @ w.astype(np.float64))[:, :12]
    d2 = ((q[:, None, :] - emb[None, :n].astype(np.float64)) ** 2).sum(-1)
    part = np.partition(d2, 1, axis=1)
    return part[:, 1] - part[:, 0], d2


@pytest.mark.parametrize("seed", [11, 21, 31])
def test_nn_match_affine_matches_jax_kernel_both_phases(seed):
    feat, w, emb_a, emb_b, pay, n_t = _problem(seed)
    phase = np.asarray([[0, 0], [1, 0]], np.int32)
    jd2, jmt = _jax_match(feat, w, emb_a, emb_b, pay, n_t, phase)
    pd2, pmt = _port_match(feat, w, emb_a, emb_b, pay, n_t, phase)
    assert pmt.shape == jmt.shape == (B, P, NQ)
    np.testing.assert_allclose(pd2, jd2, atol=1e-4, rtol=0)
    for b, emb in ((0, emb_a[0]), (1, emb_b[1])):
        gap, d2x = _exact_top2_gap(feat[b], w[b], emb, int(n_t[b]))
        # both agree with the exact search in the selected phase
        qn = ((feat[b].astype(np.float64) @ w[b].astype(np.float64))
              [:, :12] ** 2).sum(-1)
        np.testing.assert_allclose(pd2[b] + qn, d2x.min(1), atol=1e-4)
        differ = np.abs(pmt[b] - jmt[b]).max(0) > 0
        assert differ.mean() <= 0.01, differ.sum()
        assert (gap[differ] < 1e-4).all(), gap[differ]
        # rows that match the exact search carry that target's payload
        ei = d2x.argmin(1)
        sure = gap > 1e-3
        np.testing.assert_array_equal(pmt[b].T[sure], pay[b, ei[sure]])
        assert (ei < n_t[b]).all()


@pytest.mark.parametrize("done_pair", [0, 1])
def test_nn_match_affine_done_pairs_are_unspecified_not_required(done_pair):
    """A done pair's outputs may be anything; an active pair beside it
    is unaffected by the flag."""
    feat, w, emb_a, emb_b, pay, n_t = _problem(12)
    live = np.asarray([[0, 0], [1, 0]], np.int32)
    done = live.copy()
    done[done_pair, 1] = 1
    act = 1 - done_pair
    d2_live, mt_live = _port_match(feat, w, emb_a, emb_b, pay, n_t, live)
    d2_done, mt_done = _port_match(feat, w, emb_a, emb_b, pay, n_t, done)
    np.testing.assert_array_equal(d2_done[act], d2_live[act])
    np.testing.assert_array_equal(mt_done[act], mt_live[act])
    jd2, jmt = _jax_match(feat, w, emb_a, emb_b, pay, n_t, done)
    np.testing.assert_allclose(d2_done[act], jd2[act], atol=1e-4, rtol=0)
    assert (np.abs(mt_done[act] - jmt[act]).max(0) > 0).mean() <= 0.01


@pytest.mark.parametrize("n_tied", [2, 3, 4])
def test_nn_match_affine_tie_average_matches_jax_kernel(n_tied):
    """Exactly tied targets (a point present n_tied times): both kernels
    average the tied payload rows."""
    rng = np.random.default_rng(8)
    nq, nt, p = 8, 16, 4
    feat = np.zeros((1, nq, 16), np.float32)
    feat[:, :, 12] = 1.0
    w = np.zeros((1, 16, 16), np.float32)
    w[:, 9, 9] = w[:, 10, 10] = w[:, 11, 11] = 1.0
    t_b = np.zeros((1, nt, 12), np.float32)
    t_b[:, :, 9:12] = rng.normal(size=(1, nt, 3))
    t_b[0, 1:n_tied, 9:12] = t_b[0, 0, 9:12]  # copies of target 0
    t_b[0, n_tied:, 9:12] += 100.0           # everything else far away
    pay = rng.normal(size=(1, nt, p)).astype(np.float32)
    feat[0, :, 9:12] = t_b[0, 0, 9:12] + 1e-3 * rng.normal(size=(nq, 3))
    n_t = np.asarray([nt], np.int32)
    phase = np.asarray([[1, 0]], np.int32)
    _, jmt = _jax_match(feat, w, t_b, t_b, pay, n_t, phase)
    t = torch.as_tensor
    targets = cuda_knn.pack_match_targets(t(t_b), t(t_b), t(pay), t(n_t))
    _, pmt = cuda_knn.nn_match_affine(t(feat), t(w), targets, t(phase))
    avg = pay[0, :n_tied].mean(0)
    np.testing.assert_allclose(pmt[0].numpy().T,
                               np.broadcast_to(avg, (nq, p)), rtol=1e-6)
    np.testing.assert_allclose(pmt[0].numpy(), jmt[0], rtol=1e-5)


@pytest.mark.parametrize("seed", [13, 23, 33])
def test_nn_match_affine_float64_plain_is_exact_search(seed):
    """float64 through the plain version: the matched row is the exact
    nearest target's row, bit for bit (what the float64 engine tests
    rely on)."""
    feat, w, emb_a, emb_b, pay, n_t = _problem(seed)
    t = lambda a: torch.as_tensor(a).double()
    phase = torch.as_tensor(np.asarray([[0, 0], [1, 0]], np.int32))
    targets = cuda_knn.pack_match_targets(
        t(emb_a), t(emb_b), t(pay), torch.as_tensor(n_t))
    _, mt = cuda_knn.nn_match_affine_plain(t(feat), t(w), targets, phase)
    for b, emb in ((0, emb_a[0]), (1, emb_b[1])):
        gap, d2x = _exact_top2_gap(feat[b], w[b], emb, int(n_t[b]))
        sure = gap > 1e-9
        assert sure.mean() > 0.99
        np.testing.assert_array_equal(
            mt[b].numpy().T[sure],
            pay[b, d2x.argmin(1)[sure]].astype(np.float64))
