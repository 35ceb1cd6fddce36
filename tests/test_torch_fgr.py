"""The port's FPFH (``ops/fpfh.py``) and FGR (``models/fgr.py``) against
the JAX package's, on the CPU, in float32.

Both sides run their exact feature kNN (the JAX package's TPU route takes
an approximate top-k; ``SE3_ICP_TPU_FGR_EXACT_KNN=1`` makes it exact, as
it is off the TPU anyway) and the JAX package's reciprocal match runs its
batched 1-NN kernel (K6) through the callback-free interpret gate
(``SE3_ICP_TPU_FORCE_PALLAS=1 SE3_ICP_TPU_PALLAS_INTERPRET=1``).  Inputs:
seed-made golden-shape pairs of 420-480 points under the golden pose,
default ``FGRConfig`` (normals k = 30, FPFH k = 100, 16384 trials, 64
Gauss-Newton steps).

A fault of the JAX package's dense FPFH sum, not carried over: it
leaves the query itself out of its neighbour sum by ``d2 > 0`` alone,
but the float32 self-distance |q|^2 - 2 q.q + |q|^2 is a few ulps of
|q|^2 for ~10% of the rows, and 1/d2 then weights the point's own SPFH
by ~1e5; which rows are hit depends on how XLA fuses the expression (the
same JAX code gives 223 of 900 other forward matches under ``jax.jit``
than eagerly).  The port leaves the query out by its index.  So the
features are held against the JAX package's GATHERED route, which
leaves the query out by rank.

What is held, and how tightly:

  * pair features, SPFH and FPFH on the same neighbourhoods: a feature
    near a histogram bin edge may fall into the next bin on one side
    (float32 rounding of the Darboux angles), and a boundary member of
    the dense ball may differ from the rank-k one, so descriptors are
    held by their relative L1 error: median below 1e-4, mean below 1e-2
    (``tests/test_fgr.py`` holds the JAX package to an Open3D
    transcription at 0.05 / 0.15);
  * the reciprocal match on the JAX package's features: indices equal
    except where two targets are within float32 rounding of each other
    (checked in float64), at most 1% of rows;
  * the rest of FGR with the JAX package's own matches (its feature
    front end traced as its FGR program traces it) and random triples
    injected: transforms within 1e-3 deg and 1e-4;
  * the full route, with the port's own features and random triples
    (``torch.Generator``, other numbers than ``jax.random``): every pair
    passes the 2 deg / 0.25 gate on both sides, and the two agree within
    FULL_ROUTE_DEG = 0.15 deg, since other triples and the repaired
    features keep other correspondence multiplicities (measured: at most
    0.039 deg over these two pairs and two seeds; each side's own error
    0.036-0.090 deg).

Measured on these inputs: features against the JAX package's gathered
route median 1.4e-7, mean 1.5e-5 to 3.7e-5 relative L1; no forward or
backward match of a valid row differs.

Run as a script, this file is the survey behind gating every pair of
``chip_smoke.py``'s FGR path:

    JAX_PLATFORMS=cpu python tests/test_torch_fgr.py

registers 64 golden-shape pairs (4167 points) by FGR through the JAX
package (plain CPU route, float32, default ``FGRConfig``) and prints
each pair's errors and the misses of the gate.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from se3_icp_tpu.models import fgr as j_fgr  # noqa: E402
from se3_icp_tpu.ops import fpfh as j_fpfh  # noqa: E402
from se3_icp_tpu.ops import knn as j_knn  # noqa: E402
from se3_icp_tpu.ops import lrf as j_lrf  # noqa: E402
from se3_icp_tpu.parallel import pairs as j_pairs  # noqa: E402

from se3_icp_tpu_torch import cli  # noqa: E402
from se3_icp_tpu_torch.datasets import fixtures  # noqa: E402
from se3_icp_tpu_torch.models import fgr  # noqa: E402
from se3_icp_tpu_torch.ops import fpfh  # noqa: E402
from se3_icp_tpu_torch.parallel import pairs  # noqa: E402
from se3_icp_tpu_torch.utils import metrics_host, ply  # noqa: E402

# the suite runs several worker processes side by side: keep each
# one's torch thread pool small
torch.set_num_threads(1)

FULL_ROUTE_DEG = 0.15
N_PTS = ((1, 480), (2, 420))


@pytest.fixture()
def jax_fgr_route(monkeypatch):
    monkeypatch.setenv("SE3_ICP_TPU_FORCE_PALLAS", "1")
    monkeypatch.setenv("SE3_ICP_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("SE3_ICP_TPU_FGR_EXACT_KNN", "1")


def _problems():
    return [fixtures.golden_shape_problem(seed=s, n=n) for s, n in N_PTS]


def _packed(probs):
    src, n_src, tgt, n_tgt = pairs.pack_pairs(
        [(p.source, p.target) for p in probs])
    return src, n_src, tgt, n_tgt


def _jax_front(src, n_src, tgt, n_tgt, cfg, dense=True):
    """The JAX package's FGR up to the reciprocal match (its
    ``_fgr_impl``), one pair; vmapped by the caller.  ``dense=False``:
    FPFH by the gathered route."""
    ns, nt = src.shape[0], tgt.shape[0]
    sv = jnp.arange(ns) < n_src
    tv = jnp.arange(nt) < n_tgt
    src = jnp.where(sv[:, None], src, 0.0)
    tgt = jnp.where(tv[:, None], tgt, 0.0)
    kw = max(cfg.fpfh_knn, cfg.normals_knn) + 1
    kf = cfg.fpfh_knn

    def feat(pts, n, valid):
        idx, d2 = j_knn.knn_self(pts, kw, n, method="exact")
        nrm = j_lrf.normals_dense(pts, d2, cfg.normals_knn, n)
        m = ((jnp.arange(kf)[None, :] < jnp.minimum(n, kf))
             & (jnp.arange(pts.shape[0])[:, None] < n))
        f = j_fpfh.fpfh_from_neighbors(pts, nrm, idx[:, :kf], d2[:, :kf],
                                       m, n_valid=n, dense_sum=dense)
        return jnp.where(valid[:, None], f, 1e6)

    fs, ft = feat(src, n_src, sv), feat(tgt, n_tgt, tv)
    fwd, _ = j_knn.nn_argmin(fs, ft, n_tgt)
    bwd, _ = j_knn.nn_argmin(ft, fs, n_src)
    return fs, ft, fwd, bwd


def _jax_features(probs, cfg):
    """The JAX package's features (gathered FPFH route) and its
    reciprocal match on them."""
    src, n_src, tgt, n_tgt = _packed(probs)
    out = jax.vmap(_jax_front, in_axes=(0, 0, 0, 0, None, None))(
        src, n_src, tgt, n_tgt, cfg, False)
    return [np.asarray(x) for x in out]


def _jax_matches(probs, cfg):
    """(fwd, bwd, raw triples, results) of the JAX package's FGR: its
    front end traced as ``fgr_register_arrays`` traces it (jit, highest
    matmul precision, vmapped), which gives its dense FPFH sum the same
    float32 self-distances."""
    src, n_src, tgt, n_tgt = _packed(probs)

    def front(*a):
        with jax.default_matmul_precision("highest"):
            return _jax_front(*a, cfg)

    _, _, fwd, bwd = jax.jit(jax.vmap(front))(src, n_src, tgt, n_tgt)
    raw = jax.random.randint(jax.random.key(cfg.seed),
                             (cfg.tuple_trials, 3), 0, 1 << 30)
    res = j_pairs.register_pairs([(p.source, p.target) for p in probs],
                                 "fgr", cfg, mesh=None)
    return np.asarray(fwd), np.asarray(bwd), np.asarray(raw), res


def _rel_l1(got, want):
    return (np.abs(got - want).sum(-1)
            / np.maximum(np.abs(want).sum(-1), 1e-9))


def _t(a):
    return torch.as_tensor(np.array(a))


def test_pair_features_match_jax():
    rng = np.random.default_rng(3)
    p1, p2 = rng.normal(size=(2, 500, 3)).astype(np.float32)
    n1, n2 = rng.normal(size=(2, 500, 3)).astype(np.float32)
    n1 /= np.linalg.norm(n1, axis=-1, keepdims=True)
    n2 /= np.linalg.norm(n2, axis=-1, keepdims=True)
    p2[:3] = p1[:3]                        # coincident points: all zero
    want = j_fpfh.pair_features(*map(jnp.asarray, (p1, n1, p2, n2)))
    got = fpfh.pair_features(*map(_t, (p1, n1, p2, n2)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-6,
                                   rtol=1e-5)
    assert not got[0][:3].any() and not got[1][:3].any()


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "gathered"])
def test_fpfh_on_the_same_neighbourhoods_matches_jax(dense):
    """SPFH and FPFH from the JAX package's own kNN and normals, both of
    the port's routes against the JAX package's gathered one."""
    probs = _problems()
    src, n_src, _, _ = _packed(probs)
    k = 100
    got_s, want_s, got_f, want_f = [], [], [], []
    idx_b, d2_b, nrm_b, m_b = [], [], [], []
    for b in range(len(probs)):
        pts, n = jnp.asarray(src[b]), int(n_src[b])
        idx, d2 = j_knn.knn_self(pts, k + 1, n, method="exact")
        nrm = j_lrf.normals_dense(pts, d2, 30, n)
        m = ((jnp.arange(k)[None, :] < min(n, k))
             & (jnp.arange(pts.shape[0])[:, None] < n))
        want_s.append(np.asarray(j_fpfh.spfh(pts, nrm, idx[:, :k], m))[:n])
        want_f.append(np.asarray(j_fpfh.fpfh_from_neighbors(
            pts, nrm, idx[:, :k], d2[:, :k], m, n_valid=n,
            dense_sum=False))[:n])
        for lst, a in ((idx_b, idx[:, :k]), (d2_b, d2[:, :k]), (nrm_b, nrm),
                       (m_b, m)):
            lst.append(np.asarray(a))
    idx, d2, nrm, m = (_t(np.stack(x)) for x in (idx_b, d2_b, nrm_b, m_b))
    pts = _t(src)
    spfh = fpfh.spfh(pts, nrm, idx, m)
    feat = fpfh.fpfh_from_neighbors(pts, nrm, idx, d2, m,
                                    n_valid=_t(n_src), dense_sum=dense)
    for b in range(len(probs)):
        n = int(n_src[b])
        for got, want in ((spfh[b, :n], want_s[b]), (feat[b, :n], want_f[b])):
            err = _rel_l1(got.numpy(), want)
            assert np.median(err) < 1e-4, np.median(err)
            assert np.mean(err) < 1e-2, np.mean(err)


def test_features_and_matching_match_jax(jax_fgr_route):
    """The whole feature pipeline (kNN, normals, FPFH, padded rows at
    1e6) and the reciprocal match (two K6 calls) on the JAX package's
    features."""
    probs = _problems()
    cfg = fgr.FGRConfig()
    fs, ft, fwd, bwd = _jax_features(probs, j_fgr.FGRConfig())
    src, n_src, tgt, n_tgt = _packed(probs)
    got_s = fgr.features(_t(src), _t(n_src), cfg).numpy()
    got_t = fgr.features(_t(tgt), _t(n_tgt), cfg).numpy()
    for b in range(len(probs)):
        for got, want, n in ((got_s, fs, n_src), (got_t, ft, n_tgt)):
            err = _rel_l1(got[b, :n[b]], want[b, :n[b]])
            assert np.median(err) < 1e-4, np.median(err)
            assert np.mean(err) < 1e-2, np.mean(err)
            assert (got[b, n[b]:] == 1e6).all()
    f, bk = fgr.reciprocal_matches(_t(fs), _t(n_src), _t(ft), _t(n_tgt))
    for got, want, q, t, nq in ((f.numpy(), fwd, fs, ft, n_src),
                                (bk.numpy(), bwd, ft, fs, n_tgt)):
        for b in range(len(probs)):
            n = nq[b]
            differ = got[b, :n] != want[b, :n]
            assert differ.mean() <= 0.01, differ.sum()
            qd = q[b, :n][differ].astype(np.float64)
            dg = ((qd - t[b][got[b, :n][differ]]) ** 2).sum(-1)
            dw = ((qd - t[b][want[b, :n][differ]]) ** 2).sum(-1)
            scale = (qd * qd).sum(-1) + (t[b] ** 2).sum(-1).max()
            assert (np.abs(dg - dw) <= 2e-5 * scale).all()


def test_fgr_with_injected_matches_and_triples_matches_jax(jax_fgr_route):
    """The tuple test, scale normalisation, GNC loop and denormalisation
    on the JAX package's own matches and random integers."""
    probs = _problems()
    jcfg = j_fgr.FGRConfig(seed=103)
    fwd, bwd, raw, j_res = _jax_matches(probs, jcfg)
    src, n_src, tgt, n_tgt = _packed(probs)
    T = fgr.register_from_matches(
        _t(src), _t(n_src), _t(tgt), _t(n_tgt), _t(fwd), _t(bwd),
        fgr.FGRConfig(seed=103), raw=_t(raw)).numpy()
    for p, a, Tb in zip(probs, j_res, T):
        Ta = a.transformation
        assert metrics_host.success(p.T_gt, Ta)
        assert metrics_host.angular_error_so3(Ta[:3, :3], Tb[:3, :3]) < 1e-3
        assert np.linalg.norm(Ta[:3, 3] - Tb[:3, 3]) < 1e-4


def test_full_fgr_passes_the_gate_and_agrees_with_jax(jax_fgr_route):
    probs = _problems()
    pl = [(p.source, p.target) for p in probs]
    j_res = j_pairs.register_pairs(pl, "fgr", j_fgr.FGRConfig(seed=107),
                                   mesh=None)
    stats = {}
    t_res = pairs.register_pairs(pl, "fgr", fgr.FGRConfig(seed=107),
                                 device="cpu", stats=stats)
    assert all(r >= 3 for r in stats["kept_correspondences"])
    for p, a, b in zip(probs, j_res, t_res):
        assert metrics_host.success(p.T_gt, a.transformation)
        assert metrics_host.success(p.T_gt, b.transformation)
        assert b.num_iterations == a.num_iterations == 64
        assert metrics_host.angular_error_so3(
            a.transformation[:3, :3],
            b.transformation[:3, :3]) < FULL_ROUTE_DEG


def test_degenerate_correspondences_give_the_identity():
    """No reciprocal match at all: fewer than 3 correspondences, the
    identity (the JAX package's fallback)."""
    probs = _problems()
    src, n_src, tgt, n_tgt = (_t(a) for a in _packed(probs))
    ns = src.shape[1]
    fwd = torch.zeros((2, ns), dtype=torch.int64)
    bwd = torch.ones((2, tgt.shape[1]), dtype=torch.int64)
    T = fgr.register_from_matches(src, n_src, tgt, n_tgt, fwd, bwd,
                                  fgr.FGRConfig())
    np.testing.assert_array_equal(T.numpy(), np.broadcast_to(np.eye(4),
                                                             (2, 4, 4)))


def test_fgr_entry_points_and_cli_on_cpu(tmp_path, capsys):
    p = fixtures.golden_shape_problem(seed=5, n=450)
    res = fgr.fgr_register(p.source, p.target, device="cpu")
    assert metrics_host.success(p.T_gt, res.transformation)
    assert res.num_iterations == 64 and res.num_pure_se3_iterations == 0
    with pytest.raises(ValueError, match="initial_T"):
        pairs.register_pairs([(p.source, p.target)], "fgr", fgr.FGRConfig(),
                             initial_Ts=[np.eye(4)], device="cpu")
    ply.write_ply(tmp_path / "s.ply", p.source)
    ply.write_ply(tmp_path / "t.ply", p.target)
    cli.main(["run", "fgr", str(tmp_path / "s.ply"), str(tmp_path / "t.ply"),
              "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    at = lines.index("Estimated transformation = ")
    T = np.asarray([[float(v) for v in ln.split()]
                    for ln in lines[at + 1:at + 5]])
    np.testing.assert_allclose(T, res.transformation, atol=1e-6)


# ---------------------------------------------------------------- survey

def main():
    jax.config.update("jax_platforms", "cpu")
    seeds = list(range(1, 65))
    errs = []
    for s0 in range(0, len(seeds), 4):
        chunk = seeds[s0:s0 + 4]
        probs = [fixtures.golden_shape_problem(seed=s) for s in chunk]
        res = j_pairs.register_pairs([(p.source, p.target) for p in probs],
                                     "fgr", j_fgr.FGRConfig(), mesh=None)
        for s, p, r in zip(chunk, probs, res):
            T = r.transformation
            e = (metrics_host.angular_error_so3(p.T_gt[:3, :3], T[:3, :3]),
                 metrics_host.translation_error(p.T_gt[:3, 3], T[:3, 3]),
                 metrics_host.success(p.T_gt, T))
            errs.append(e)
            print(f"seed {s}: {e[0]:.4f} deg, {e[1]:.5f}, passes {e[2]}",
                  flush=True)
    rot = np.asarray([e[0] for e in errs])
    tra = np.asarray([e[1] for e in errs])
    print(f"FGR golden shape, seeds 1..64: {sum(not e[2] for e in errs)} "
          f"miss the gate; rotation error max {rot.max():.4f} / median "
          f"{np.median(rot):.4f} deg, translation max {tra.max():.5f}")


if __name__ == "__main__":
    main()
