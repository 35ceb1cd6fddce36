"""The port's pairs mesh (``parallel/pairs.py``) and its callers on the
CPU, against the unsharded port and the JAX package.

Held: a batch sharded over a mesh of ``cpu`` x 2 and x 4 gives every
pair the unsharded bits (transforms and iteration counts), through
``register_pairs`` and through ``register_batch`` with 5 pairs padded
over 4 devices, warm starts too; ``setup_checksum_batch`` sharded equals
unsharded bit for bit, and the port's exact-route float64 checksum
agrees with the JAX package's ``setup_checksum_batch`` to 1e-6;
multistart and ``bench/common.run_pairs`` over a mesh give the unsharded
bits, ``run_pairs``'s chunk a multiple of the mesh; K1-K3's plain
versions on row slices (the points route's) give the whole call's bits;
``default_mesh`` and the mesh defaults; ``multihost.initialize`` on the card with no
card raises.  The multi-process routes are in
``test_torch_scaleout_points.py`` and
``test_torch_scaleout_multihost.py``.
"""

import numpy as np
import pytest
import torch

import se3_icp_tpu_torch
from se3_icp_tpu_torch.bench import common
from se3_icp_tpu_torch.datasets import fixtures
from se3_icp_tpu_torch.models import multistart
from se3_icp_tpu_torch.parallel import multihost, pairs
from se3_icp_tpu_torch.utils.config import RegistrationConfig
from se3_icp_tpu_torch.utils import metrics_host

torch.set_num_threads(1)

# tests/torch_port_cases.BASE with its own iteration cap
BASE = dict(number_of_nn_for_lrf=90, max_num_se3_iterations=10,
            mse_switch_error=5e-5, max_num_iterations=58)
CFG = RegistrationConfig(**BASE)


def _problems(n_pairs):
    return [fixtures.golden_shape_problem(seed=s, n=420 + 12 * s)
            for s in range(1, n_pairs + 1)]


def _pair_list(n_pairs):
    return [(p.source, p.target) for p in _problems(n_pairs)]


def _same(a, b):
    return all(np.array_equal(x.transformation, y.transformation)
               and x.num_iterations == y.num_iterations
               and x.num_pure_se3_iterations == y.num_pure_se3_iterations
               for x, y in zip(a, b)) and len(a) == len(b)


@pytest.fixture(scope="module")
def unsharded():
    pl = _pair_list(5)
    return pl, pairs.register_pairs(pl, "se3_pt2pl", CFG, device="cpu")


@pytest.mark.parametrize("n_dev", [2, 4])
def test_pairs_mesh_gives_every_pair_the_unsharded_bits(unsharded, n_dev):
    pl, ref = unsharded
    stats = {}
    got = pairs.register_pairs(pl, "se3_pt2pl", CFG, mesh=("cpu",) * n_dev,
                               stats=stats)
    assert _same(got, ref)
    # each shard ran its own loop: steps summed over the shards
    assert stats["loop_steps"] >= n_dev * 4
    for p, r in zip(_problems(5), got):
        assert metrics_host.success(p.T_gt, r.transformation)


def test_register_batch_pads_five_pairs_over_four_devices(unsharded):
    pl, ref = unsharded
    batch = [torch.as_tensor(a) for a in pairs.pack_pairs(pl)]
    T0 = torch.eye(4).repeat(5, 1, 1)
    T0[:, :3, 3] = 0.01
    whole = pairs.register_batch(*batch, CFG, "se3_pt2pl", initial_T=T0,
                                 device="cpu")
    for T_init in (None, T0):
        got = pairs.register_batch(*batch, CFG, "se3_pt2pl",
                                   initial_T=T_init, mesh=("cpu",) * 4)
        assert got[0].shape == (5, 4, 4) and got[1].shape == (5,)
        if T_init is None:
            assert np.array_equal(got[0].double().numpy(),
                                  np.stack([r.transformation for r in ref]))
            assert got[1].tolist() == [r.num_iterations for r in ref]
        else:
            for x, y in zip(got, whole):
                assert torch.equal(x, y)


def test_setup_checksum_sharded_equals_unsharded():
    batch = [torch.as_tensor(a) for a in pairs.pack_pairs(_pair_list(5))]
    for alg in ("se3_pt2pl", "se3_gicp"):
        whole = pairs.setup_checksum_batch(*batch, CFG, alg, device="cpu")
        assert whole.shape == (5,) and bool(torch.isfinite(whole).all())
        for n_dev in (2, 4):
            got = pairs.setup_checksum_batch(*batch, CFG, alg,
                                             mesh=("cpu",) * n_dev)
            assert torch.equal(got, whole), (alg, n_dev)


@pytest.mark.parametrize("alg", ["se3_pt2pl", "se3_gicp"])
def test_exact_route_checksum_agrees_with_jax(alg):
    """float64, the exact route on both sides: the JAX package's CPU
    route (its setup-only program on its unsharded layout) against the
    port's, pair by pair."""
    import jax.numpy as jnp
    from se3_icp_tpu.parallel import pairs as j_pairs
    from se3_icp_tpu.utils.config import RegistrationConfig as JaxConfig
    pl = _pair_list(3)
    arrs = pairs.pack_pairs(pl, np.float64)
    got = pairs.setup_checksum_batch(*(torch.as_tensor(a) for a in arrs),
                                     CFG, alg, mesh=("cpu",) * 2,
                                     exact_knn=True)
    want = np.asarray(j_pairs.setup_checksum_batch(
        *(jnp.asarray(a) for a in j_pairs.pack_pairs(pl, np.float64)),
        JaxConfig(**BASE), alg, None))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_default_mesh_and_the_mesh_defaults():
    assert "default_mesh" in se3_icp_tpu_torch.__all__
    assert se3_icp_tpu_torch.default_mesh is pairs.default_mesh
    mesh = pairs.default_mesh(["cpu", torch.device("cpu")])
    assert mesh == (torch.device("cpu"),) * 2
    assert pairs._auto_mesh(None, "cpu") is None
    assert pairs._auto_mesh(False, "cuda") is None
    assert pairs._auto_mesh(["cpu"], "cuda") == (torch.device("cpu"),)
    with pytest.raises(ValueError, match="at least one"):
        pairs.default_mesh([])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pairs.default_mesh()


def test_multistart_over_a_mesh_gives_the_unsharded_bits():
    pl = _pair_list(2)
    kw = dict(n_starts=4, device="cpu", pair_chunk=None)
    ref = multistart.register_pairs_multistart(pl, "se3_pt2pl", CFG,
                                               mesh=False, **kw)
    got = multistart.register_pairs_multistart(pl, "se3_pt2pl", CFG,
                                               mesh=("cpu",) * 4, **kw)
    for a, b in zip(got, ref):
        assert a.start_index == b.start_index
        assert np.array_equal(a.scores, b.scores)
        assert _same([a.best], [b.best])


def test_run_pairs_over_a_mesh(capsys):
    pl = _pair_list(5)
    ref = common.run_pairs(pl, "se3_pt2pl", CFG, chunk=3, device="cpu",
                           verbose=False)
    got = common.run_pairs(pl, "se3_pt2pl", CFG, chunk=3, device="cpu",
                           mesh=("cpu",) * 2)
    # the chunk of 3 rounds up to 4, a multiple of the mesh: 2 batches
    assert capsys.readouterr().out.count("on 2 device(s)") == 2
    assert sorted(got) == sorted(ref) == list(range(5))
    for i in range(5):
        assert np.array_equal(got[i].T_est, ref[i].T_est)
        assert got[i].num_iterations == ref[i].num_iterations


@pytest.mark.parametrize("chunk_bytes", [None, 1],
                         ids=["one-block", "32-row-blocks"])
def test_plain_setup_slices_give_the_whole_call_bits(monkeypatch,
                                                      chunk_bytes):
    """K1-K3's plain versions on 3 row slices (the points route's rows
    at R = 3, no multiple of the blocks) concatenated: the whole call's
    bits, with the rows in one block and in 32-row blocks."""
    from se3_icp_tpu_torch.ops import cuda_moments as cm, lrf
    if chunk_bytes is not None:
        monkeypatch.setattr(cm, "_CHUNK_BYTES", chunk_bytes)
    probs = _problems(2)
    pts = np.zeros((2, 600, 3), np.float32)
    for b, p in enumerate(probs):
        pts[b, :len(p.source)] = p.source - p.source.mean(0)
    pts = torch.as_tensor(pts)
    nv = torch.tensor([len(p.source) for p in probs], dtype=torch.int32)
    cloud = cm.setup_cloud(pts, nv)
    cc = torch.tensor([[90, 31, 30]] * 2)
    thr = cm.neighborhood_thresholds_plain(pts, nv, cc, cloud=cloud)
    mom = cm.moments_plain(pts, nv, thr[:, 2], thr[:, 1], thr[:, 0],
                           cloud=cloud)
    nrm, ndq, rad = lrf.toldi_axis_inputs(mom, thr[:, 0], 30)
    ax = cm.axis_sums_plain(pts, nv, nrm, ndq, rad, thr[:, 0], cloud=cloud)
    parts = []
    for rows in ((0, 200), (200, 400), (400, 600)):
        sl = slice(*rows)
        t = cm.neighborhood_thresholds_plain(pts, nv, cc, cloud=cloud,
                                             rows=rows)
        parts.append((t, cm.moments_plain(pts, nv, t[:, 2], t[:, 1],
                                          t[:, 0], cloud=cloud, rows=rows),
                      cm.axis_sums_plain(pts, nv, nrm[..., sl], ndq[..., sl],
                                         rad[..., sl], t[:, 0], cloud=cloud,
                                         rows=rows)))
    assert torch.equal(torch.cat([x[0] for x in parts], -1), thr)
    for key in mom:
        assert torch.equal(torch.cat([x[1][key] for x in parts], -1),
                           mom[key]), key
    for j in (0, 1):
        assert torch.equal(torch.cat([x[2][j] for x in parts], -1), ax[j])
    with pytest.raises(ValueError, match="outside the cloud"):
        cm.neighborhood_thresholds_plain(pts, nv, cc, rows=(500, 700))


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs no card")
def test_initialize_on_the_card_without_one_raises():
    with pytest.raises(RuntimeError, match="device='cpu'"):
        multihost.initialize("127.0.0.1:1", 1, 0)
