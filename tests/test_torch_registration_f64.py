"""The port's exact route (``exact_knn=True``) as a whole, on the CPU,
in float64 against the JAX package on its plain CPU route (exact sorted
kNN, unfused loop): ``register_pair`` / ``register_pairs`` /
``register_batch`` with ``device="cpu"``, where each kernel's plain
version runs.

Inputs are seed-made (``datasets/fixtures.py``): the curved "bumpy"
surface under the golden pose, the "room" scene under a small pose for
the vanilla ICP modes, 420-480 points padded to 512 so n_valid < N.

Both sides see the same neighbourhoods and the same nearest targets, so
the iteration counts must be EQUAL and the transforms agree to
rounding: 1e-9 deg, 1e-10 in translation.  The float32 hold against the
JAX interpret route is in ``test_torch_registration.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from se3_icp_tpu.models import registration as j_reg
from se3_icp_tpu.ops import knn as j_knn
from se3_icp_tpu.ops import lrf as j_lrf
from se3_icp_tpu.parallel import pairs as j_pairs

import torch_port_cases as cases
from se3_icp_tpu_torch.datasets import fixtures
from se3_icp_tpu_torch.models import registration as reg
from se3_icp_tpu_torch.parallel import pairs
from se3_icp_tpu_torch.utils import convert, metrics_host
from se3_icp_tpu_torch.utils.config import GOLDEN

# the suite runs several worker processes side by side: keep each
# one's torch thread pool small
torch.set_num_threads(1)


@pytest.mark.parametrize("case", cases.CASES, ids=[c[0] for c in cases.CASES])
def test_register_pairs_float64_matches_jax_plain_route(case):
    _, alg, ckw, kind, pkw = case
    probs = cases.problems(kind, pkw)
    pair_list = [(p.source, p.target) for p in probs]
    jcfg, cfg = cases.configs(ckw, 150)
    j_res = j_pairs.register_pairs(pair_list, alg, jcfg, mesh=None,
                                   dtype=np.float64)
    stats = {}
    t_res = pairs.register_pairs(pair_list, alg, cfg, dtype=np.float64,
                                 device="cpu", stats=stats, exact_knn=True)
    cases.hold(probs, j_res, t_res, 1e-9, 1e-10)
    # done is polled every few steps, never every step
    steps = stats["loop_steps"]
    assert steps >= max(r.num_iterations for r in t_res)
    assert stats["host_syncs"] == steps // reg._POLL_EVERY

def test_register_pair_warm_start_and_history_match_jax():
    p = fixtures.golden_shape_problem(seed=3, n=450)
    jcfg, cfg = cases.configs({}, 150)
    T0 = p.T_gt.copy()
    T0[:3, :3] = T0[:3, :3] @ fixtures.rot_3d(0.05, -0.04, 0.03)
    T0[:3, 3] += (0.1, -0.05, 0.08)
    j = j_reg.register_pair(p.source, p.target, "se3_pt2pl", jcfg,
                            dtype=jnp.float64, record_history=True,
                            initial_T=T0)
    t = reg.register_pair(p.source, p.target, "se3_pt2pl", cfg,
                          dtype=torch.float64, record_history=True,
                          initial_T=T0, device="cpu", exact_knn=True)
    assert t.num_iterations == j.num_iterations
    assert t.num_pure_se3_iterations == j.num_pure_se3_iterations
    assert t.history.shape == j.history.shape == (t.num_iterations, 4, 4)
    np.testing.assert_allclose(t.history, j.history, atol=1e-9)
    np.testing.assert_allclose(t.transformation, j.transformation,
                               atol=1e-9)
    np.testing.assert_array_equal(t.history[-1], t.transformation)
    assert metrics_host.success(p.T_gt, t.transformation)
    # a start at the ground truth converges at once
    t_gt = reg.register_pair(p.source, p.target, "se3_pt2pl", cfg,
                             dtype=torch.float64, initial_T=p.T_gt,
                             device="cpu", exact_knn=True)
    assert t_gt.num_iterations < t.num_iterations
    assert metrics_host.success(p.T_gt, t_gt.transformation)

@pytest.mark.parametrize("alg,ckw", [
    ("se3_pt2pl", {}),
    ("se3_gicp_with_cf", {"estimated_overlap": 0.75}),
])
def test_loop_on_jax_setup_products_matches_jax(alg, ckw):
    """State carried across: the JAX package's setup products (frames,
    normals, covariances as numpy arrays) go through
    ``convert.match_state_from_numpy`` into this port's loop, which then
    lands on the JAX package's own result -- the loop and its two
    kernels held on their own, with the setup taken out."""
    probs = cases.problems("bumpy", cases.NOISY if ckw else {})
    pair_list = [(p.source, p.target) for p in probs]
    jcfg, cfg = cases.configs(ckw, 150)
    mode, variant = ("se3_cf", "gicp") if "cf" in alg else ("se3", "pt2pl")
    src, n_src, tgt, n_tgt = pairs.pack_pairs(pair_list, np.float64)
    t = torch.as_tensor
    h = reg.hyper(reg.split_cfg(cfg, torch.float64, "cpu")[0])
    src_c, tgt_c, pre = reg.preprocess(t(src), t(n_src), t(tgt), t(n_tgt),
                                       cfg, True, h)
    k = cfg.number_of_nn_for_lrf
    prod = {"rot_src": [], "rot_tgt": [], "nrm": [], "cs": [], "ct": []}
    for b in range(len(probs)):
        for side, pts, n in (("src", src_c[b].numpy(), int(n_src[b])),
                             ("tgt", tgt_c[b].numpy(), int(n_tgt[b]))):
            _, d2 = j_knn.knn_self(jnp.asarray(pts), k + 1, n,
                                   method="exact")
            rot, _ = j_lrf.toldi_frames_dense(jnp.asarray(pts), d2[:, :k],
                                              n)
            prod["rot_" + side].append(np.asarray(rot))
            if variant == "pt2pl" and side == "tgt":
                prod["nrm"].append(np.asarray(j_lrf.normals_dense(
                    jnp.asarray(pts), d2, cfg.normals_knn, n)))
            if variant == "gicp":
                cov = np.asarray(j_lrf.gicp_covariances_dense(
                    jnp.asarray(pts), d2, cfg.gicp_normals_knn,
                    cfg.gicp_epsilon, n))
                prod["cs" if side == "src" else "ct"].append(np.stack(
                    [cov[:, 0, 0], cov[:, 0, 1], cov[:, 0, 2],
                     cov[:, 1, 1], cov[:, 1, 2], cov[:, 2, 2]]))
    st = lambda key: np.stack(prod[key]) if prod[key] else None
    use_cf = mode == "se3_cf"
    ms = convert.match_state_from_numpy(
        src_c.numpy(), tgt_c.numpy(), n_src, n_tgt, cfg, mode, variant,
        rot_src=st("rot_src"), rot_tgt=st("rot_tgt"), tgt_normals=st("nrm"),
        cov_src6=st("cs"), cov_tgt6=st("ct"),
        conf_src=(reg.lounge_point_confidence(t(src)).numpy()
                  if use_cf else None),
        conf_tgt=(reg.lounge_point_confidence(t(tgt)).numpy()
                  if use_cf else None),
        dtype=torch.float64)
    assert ms.feat16.shape == (2, 512, 16)
    assert ms.targets.payload.shape[-1] == (13 if use_cf else 9)
    T, it, pure, _ = reg.run_loop(ms, pre.scaling, cfg, mode, h)
    T = reg.to_original(T, pre, True).numpy()
    j_res = j_pairs.register_pairs(pair_list, alg, jcfg, mesh=None,
                                   dtype=np.float64)
    for b, (p, j) in enumerate(zip(probs, j_res)):
        assert int(it[b]) == j.num_iterations
        assert int(pure[b]) == j.num_pure_se3_iterations
        np.testing.assert_allclose(T[b], j.transformation, atol=1e-8)
        assert metrics_host.success(p.T_gt, T[b])

def test_register_batch_heterogeneous_pairs_and_padding_invariance():
    """Pairs of different sizes and difficulty share one batch: each
    result equals the pair registered alone (done-masked extra steps are
    no-ops), whatever the padding."""
    a = fixtures.golden_shape_problem(seed=4, n=450)
    b = fixtures.golden_shape_problem(seed=5, n=380, **cases.SMALL_POSE)
    cfg = GOLDEN
    both = pairs.register_pairs([(a.source, a.target), (b.source, b.target)],
                                "se3_pt2pl", cfg, dtype=np.float64,
                                device="cpu")
    assert both[0].num_iterations != both[1].num_iterations
    for p, r in zip((a, b), both):
        alone = reg.register_pair(p.source, p.target, "se3_pt2pl", cfg,
                                  dtype=torch.float64, device="cpu")
        assert alone.num_iterations == r.num_iterations
        np.testing.assert_allclose(alone.transformation, r.transformation,
                                   atol=1e-12)
        assert metrics_host.success(p.T_gt, r.transformation)
    # register_batch on tensors: wider padding, same answer
    src, n_src, tgt, n_tgt = pairs.pack_pairs(
        [(a.source, a.target), (b.source, b.target)], np.float64,
        bucket=1024)
    assert src.shape == (2, 1024, 3) and n_src.tolist() == [450, 380]
    T, it, _ = pairs.register_batch(
        torch.as_tensor(src), torch.as_tensor(n_src), torch.as_tensor(tgt),
        torch.as_tensor(n_tgt), cfg, "se3_pt2pl", device="cpu")
    assert it.tolist() == [r.num_iterations for r in both]
    np.testing.assert_allclose(T.numpy(), np.stack(
        [r.transformation for r in both]), atol=1e-12)
