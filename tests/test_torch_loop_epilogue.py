"""The port's fused loop epilogue (``ops/cuda_loop.py``, plain version
-- the CUDA kernel needs the card) against the JAX package's Pallas
kernel ``pallas_loop._kernel_epilogue`` run in interpret mode on the
CPU, over variant x is_se3 x use_cf x overlap.

The same float32 arrays go through both.  Tolerances: the kept COUNT
(wsum) must be equal exactly -- both run the same float32 bisection on
the same distances, so the kept set is the same set; the MSE and the
sums A, b are float32 sums of ~600 terms taken in different orders:
1e-5 relative to the largest entry of each array (gicp: 1e-4, its
whitening amplifies the last ulps of acos/cos).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from se3_icp_tpu.ops import pallas_loop
from se3_icp_tpu.ops import trim as j_trim

from se3_icp_tpu_torch.ops import cuda_loop, solve

# the suite runs several worker processes side by side: keep each
# one's torch thread pool small
torch.set_num_threads(1)

pytestmark = pytest.mark.usefixtures("interpret_mode")


@pytest.fixture()
def interpret_mode(monkeypatch):
    monkeypatch.setenv("SE3_ICP_TPU_FORCE_PALLAS", "1")
    monkeypatch.setenv("SE3_ICP_TPU_PALLAS_INTERPRET", "1")


def test_pf_layout_is_the_jax_layout():
    for name in ("PF_T", "PF_BETA", "PF_SWITCHED", "PF_NSRC", "PF_COUNT",
                 "PF_R", "PF_WIDTH"):
        assert getattr(cuda_loop, name) == getattr(pallas_loop, name), name


def _rand_rot(rng):
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    return q.astype(np.float32)


def _mk_problem(rng, b, n, p_rows, overlap):
    srcT = rng.normal(size=(b, 3, n)).astype(np.float32)
    mt = rng.normal(size=(b, p_rows, n)).astype(np.float32)
    pf = np.zeros((b, cuda_loop.PF_WIDTH), np.float32)
    Rs = np.stack([_rand_rot(rng) for _ in range(b)])
    pf[:, cuda_loop.PF_T:cuda_loop.PF_T + 3] = rng.normal(size=(b, 3))
    pf[:, cuda_loop.PF_BETA] = 1.25
    pf[:, cuda_loop.PF_SWITCHED] = (np.arange(b) % 2).astype(np.float32)
    ns = rng.integers(n // 2, n + 1, size=b).astype(np.float32)
    pf[:, cuda_loop.PF_NSRC] = ns
    pf[:, cuda_loop.PF_COUNT] = np.floor(overlap * ns)
    pf[:, cuda_loop.PF_R:cuda_loop.PF_R + 9] = Rs.reshape(b, 9)
    return srcT, mt, pf


def _layout(variant, is_se3, use_cf):
    off = {"tr": 3 if is_se3 else 0}
    p_rows = 3 + (3 if is_se3 else 0)
    if variant == "pt2pl":
        off["nrm"] = p_rows
        p_rows += 3
    if variant == "gicp":
        off["cov"] = p_rows
        p_rows += 6
        if use_cf:
            off["conf"] = p_rows
            p_rows += 1
    return off, p_rows


def _inputs(variant, is_se3, use_cf, overlap, seed=7, b=4, n=640):
    rng = np.random.default_rng(seed)
    off, p_rows = _layout(variant, is_se3, use_cf)
    srcT, mt, pf = _mk_problem(rng, b, n, p_rows, overlap)
    cov6 = conf = None
    if variant == "pt2pl":
        nr = mt[:, off["nrm"]:off["nrm"] + 3]
        mt[:, off["nrm"]:off["nrm"] + 3] = (
            nr / np.linalg.norm(nr, axis=1, keepdims=True))
    if variant == "gicp":
        def spd6(a):
            return np.stack([a[:, 0] ** 2 + 0.5, a[:, 0] * a[:, 1] * .1,
                             a[:, 0] * a[:, 2] * .1, a[:, 1] ** 2 + 0.7,
                             a[:, 1] * a[:, 2] * .1, a[:, 2] ** 2 + 0.9],
                            axis=1).astype(np.float32)
        cov6 = spd6(rng.normal(size=(b, 3, n)))
        mt[:, off["cov"]:off["cov"] + 6] = spd6(rng.normal(size=(b, 3, n)))
        if use_cf:
            conf = rng.uniform(0.2, 1.0, size=(b, n)).astype(np.float32)
            mt[:, off["conf"]] = rng.uniform(0.2, 1.0, (b, n))
    kw = dict(variant=variant, is_se3=is_se3, use_cf=use_cf,
              do_trim=overlap < 1.0, off_tr=off.get("tr", 0),
              off_nrm=off.get("nrm", 0), off_cov=off.get("cov", 0),
              off_conf=off.get("conf", 0))
    return srcT, mt, pf, cov6, conf, kw


@pytest.mark.parametrize("overlap", [0.75, 1.0])
@pytest.mark.parametrize("variant,is_se3,use_cf", [
    ("pt2pt", True, False),
    ("pt2pt", False, False),
    ("pt2pl", True, False),
    ("pt2pl", False, False),   # vanilla icp payload layout (no tr_beta)
    ("gicp", True, False),
    ("gicp", False, False),
    ("gicp", True, True),      # with_cf
])
def test_epilogue_matches_jax_kernel(variant, is_se3, use_cf, overlap):
    srcT, mt, pf, cov6, conf, kw = _inputs(variant, is_se3, use_cf, overlap)
    jA, jb, jst = jax.device_get(pallas_loop.loop_epilogue_batched(
        jnp.asarray(srcT), jnp.asarray(mt), jnp.asarray(pf),
        cov6=None if cov6 is None else jnp.asarray(cov6),
        conf=None if conf is None else jnp.asarray(conf), **kw))
    t = torch.as_tensor
    A, b, st = cuda_loop.loop_epilogue_batched(
        t(srcT), t(mt), t(pf), None if cov6 is None else t(cov6),
        None if conf is None else t(conf), **kw)
    A, b, st = A.numpy(), b.numpy(), st.numpy()
    assert A.shape == (4, 6, 6) and b.shape == (4, 8) and st.shape == (4, 8)
    # kept set: identical count, and the count asked for
    np.testing.assert_array_equal(st[:, 1], jst[:, 1])
    np.testing.assert_array_equal(st[:, 1], pf[:, cuda_loop.PF_COUNT]
                                  if overlap < 1.0
                                  else pf[:, cuda_loop.PF_NSRC])
    np.testing.assert_allclose(st[:, 0], jst[:, 0], rtol=1e-5)
    np.testing.assert_array_equal(st[:, 2:], 0.0)
    rel = 1e-4 if variant == "gicp" else 1e-5
    for i in range(4):
        np.testing.assert_allclose(A[i], jA[i], rtol=0,
                                   atol=rel * np.abs(jA[i]).max())
        np.testing.assert_allclose(b[i], jb[i], rtol=0,
                                   atol=rel * max(np.abs(jb[i]).max(), 1.0))
    # and the step the loop takes from them is the same step
    tt = lambda a: torch.as_tensor(np.array(a))
    if variant == "pt2pt":
        T = solve.solve_pt2pt_from_moments(tt(A[:, :3, :3]), tt(b[:, 0:3]),
                                           tt(b[:, 3:6]), tt(st[:, 1]))
        Tj = solve.solve_pt2pt_from_moments(tt(jA[:, :3, :3]), tt(jb[:, 0:3]),
                                            tt(jb[:, 3:6]), tt(jst[:, 1]))
    else:
        T = solve.solve_from_normal(tt(A), tt(b[:, :6]), tt(st[:, 1]))
        Tj = solve.solve_from_normal(tt(jA), tt(jb[:, :6]), tt(jst[:, 1]))
    np.testing.assert_allclose(T.numpy(), Tj.numpy(), atol=1e-4)


@pytest.mark.parametrize("overlap", [0.3, 0.75])
def test_kernel_trim_keeps_the_same_set_as_the_jax_bisection(overlap):
    """The epilogue's value + index bisection keeps exactly the set of
    ``trim._trim_mask_bisect`` (lowest indices inside the boundary
    band), ties and padded rows included."""
    rng = np.random.default_rng(3)
    n = 640
    d = rng.uniform(0.0, 3.0, size=(3, n)).astype(np.float32)
    d[0, 100:180] = d[0, 5]                 # a run of exact ties
    d[1, ::5] = 0.0                         # sqrt(0) rows
    nv = np.asarray([n, 517, 600], np.float32)
    valid = np.arange(n)[None, :] < nv[:, None]
    count = np.floor(overlap * nv)
    kept = cuda_loop._kept_mask(
        torch.as_tensor(d), torch.as_tensor(valid),
        torch.as_tensor(count)[:, None], n).numpy()
    for i in range(3):
        ref = np.asarray(j_trim._trim_mask_bisect(
            jnp.asarray(d[i]), jnp.asarray(valid[i]),
            jnp.asarray(int(count[i]), jnp.int32)))
        np.testing.assert_array_equal(kept[i], ref)
        assert kept[i].sum() == count[i]


def test_epilogue_zero_kept_rows_is_finite():
    """wsum == 0 (count 0): mse divides by max(wsum, 1), sums are 0."""
    srcT, mt, pf, _, _, kw = _inputs("pt2pl", True, False, 0.75, b=2)
    pf[:, cuda_loop.PF_NSRC] = 1.0
    pf[:, cuda_loop.PF_COUNT] = 0.0
    t = torch.as_tensor
    A, b, st = cuda_loop.loop_epilogue_batched(t(srcT), t(mt), t(pf), **kw)
    jA, jb, jst = jax.device_get(pallas_loop.loop_epilogue_batched(
        jnp.asarray(srcT), jnp.asarray(mt), jnp.asarray(pf), **kw))
    assert torch.isfinite(A).all() and torch.isfinite(st).all()
    np.testing.assert_array_equal(st.numpy(), jst)
    np.testing.assert_array_equal(A.numpy(), jA)
    np.testing.assert_array_equal(st[:, :2].numpy(), 0.0)


def test_epilogue_rejects_unknown_variant():
    srcT, mt, pf, _, _, kw = _inputs("pt2pl", True, False, 1.0, b=1)
    kw["variant"] = "pt2line"
    with pytest.raises(ValueError):
        cuda_loop.loop_epilogue_batched(
            torch.as_tensor(srcT), torch.as_tensor(mt), torch.as_tensor(pf),
            **kw)
