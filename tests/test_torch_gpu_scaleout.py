"""Scale-out on the card: the pairs mesh, the setup kernels' and the
match kernel's row-slice instances, and the points and multi-process
routes over a world-1 NCCL group.  These tests need a CUDA device and
``nvcc``; elsewhere they skip.  Run them on a GPU machine with
``python -m pytest tests/test_torch_gpu_scaleout.py -q --noconftest``.

Held: 32 pairs over a mesh naming the card twice (and 62 over it four
times, padded), and 8 pairs over it 2, 4 and 8 times (shards of 4, 2
and 1), give the unsharded bits, and so does the setup checksum;
K1-K3 on 2 and 3 row slices of 8 x 4608 clouds, concatenated, give the
whole call's bits (K1 each slice its plain version's bits), K4 on
slices of ``feat16`` likewise; the points route on the golden pair (a
replay of its captured program, the all_gathers inside the graph, no
host sync), the 2-D layout on 1 x 1 ranks and
``register_pairs_multihost`` give the eager loop's or the one-process
call's bits; a gloo group asked to serve card tensors raises.  Several
cards are not needed: the collectives across ranks are held on the CPU
(``test_torch_scaleout_*.py``).
"""

import copy

import pytest
import torch

from se3_icp_tpu_torch.datasets import fixtures
from se3_icp_tpu_torch.models import program, registration as reg
from se3_icp_tpu_torch.ops import cuda_knn, cuda_moments as cm, knn, lrf
from se3_icp_tpu_torch.parallel import multihost, pairs, points
from se3_icp_tpu_torch.utils.config import GOLDEN

torch.set_num_threads(1)

pytestmark = pytest.mark.gpu


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA")
    with knn.full_precision():
        yield torch.device("cuda")


@pytest.fixture(scope="module")
def world():
    """A world-1 NCCL group for the module's tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: NCCL")
    import socket
    import torch.distributed as dist
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    multihost.initialize(f"127.0.0.1:{port}", 1, 0)
    yield dist.group.WORLD
    program.release_group(dist.group.WORLD)
    dist.destroy_process_group()


def _problems(n_pairs):
    return [fixtures.golden_shape_problem(seed=s)
            for s in range(1, 1 + n_pairs)]


def _batch(card, probs):
    return [torch.as_tensor(a, device=card) for a in
            pairs.pack_pairs([(p.source, p.target) for p in probs])]


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("n_pairs,n_dev", [(32, 2), (62, 4), (8, 2),
                                           (8, 4), (8, 8)])
def test_pairs_mesh_gives_the_unsharded_bits(card, n_pairs, n_dev):
    batch = _batch(card, _problems(n_pairs))
    whole = pairs.register_batch(*batch, GOLDEN, "se3_pt2pl")
    mesh = pairs.default_mesh([card] * n_dev)
    assert _same(pairs.register_batch(*batch, GOLDEN, "se3_pt2pl",
                                      mesh=mesh), whole)
    assert torch.equal(
        pairs.setup_checksum_batch(*batch, GOLDEN, "se3_pt2pl", mesh=mesh),
        pairs.setup_checksum_batch(*batch, GOLDEN, "se3_pt2pl"))


@pytest.mark.parametrize("n_slices", [2, 3])
def test_setup_and_match_slices_give_the_whole_call_bits(card, n_slices):
    probs = _problems(8)
    src, n_src, tgt, n_tgt = _batch(card, probs)
    h = reg.hyper(reg.split_cfg(GOLDEN, torch.float32, card)[0])
    with torch.no_grad():
        pts, _, _ = reg.preprocess(src, n_src, tgt, n_tgt, GOLDEN, True, h)
        ms, _ = reg.setup(src, n_src, tgt, n_tgt, GOLDEN, "se3", "pt2pl", h)
    cloud = cm.setup_cloud(pts, n_src)
    cc = torch.tensor([[90, 31, 30]] * 8, device=card)
    thr = cm.neighborhood_thresholds_batched(pts, n_src, cc, cloud=cloud)
    mom = cm.moments_batched(pts, n_src, thr[:, 2], thr[:, 1], thr[:, 0],
                             cloud=cloud)
    nrm, ndq, rad = lrf.toldi_axis_inputs(mom, thr[:, 0], 30)
    ax = cm.axis_sums_batched(pts, n_src, nrm, ndq, rad, thr[:, 0],
                              cloud=cloud)
    W, ph2, _ = reg.iteration_inputs(
        ms, GOLDEN, torch.eye(4, device=card).repeat(8, 1, 1),
        torch.zeros(8, dtype=torch.bool, device=card),
        torch.zeros(8, dtype=torch.bool, device=card), h)
    d2, mt = cuda_knn.nn_match_affine(ms.feat16, W, ms.targets, ph2)
    n = pts.shape[1]
    got = []
    for i in range(n_slices):
        rows = (i * n // n_slices, (i + 1) * n // n_slices)
        sl = slice(*rows)
        t = cm.neighborhood_thresholds_batched(pts, n_src, cc, cloud=cloud,
                                               rows=rows)
        assert torch.equal(t, cm.neighborhood_thresholds_plain(
            pts, n_src, cc, cloud=cloud, rows=rows))
        m = cm.moments_batched(pts, n_src, t[:, 2], t[:, 1], t[:, 0],
                               cloud=cloud, rows=rows)
        a = cm.axis_sums_batched(pts, n_src, nrm[..., sl], ndq[..., sl],
                                 rad[..., sl], t[:, 0], cloud=cloud,
                                 rows=rows)
        part = copy.copy(ms)
        part.feat16 = ms.feat16[:, sl].contiguous()
        got.append((t, m, a, cuda_knn.nn_match_affine(
            part.feat16, W, ms.targets, ph2)))
    assert torch.equal(torch.cat([g[0] for g in got], -1), thr)
    for key in mom:
        assert torch.equal(torch.cat([g[1][key] for g in got], -1), mom[key])
    for j in (0, 1):
        assert torch.equal(torch.cat([g[2][j] for g in got], -1), ax[j])
    assert torch.equal(torch.cat([g[3][0] for g in got], 1), d2)
    assert torch.equal(torch.cat([g[3][1] for g in got], 2), mt)


def test_points_route_gives_the_eager_bits(card, world):
    batch = _batch(card, _problems(1))
    se, sg = {}, {}
    want = reg.register_arrays_eager(*batch, GOLDEN, "se3", "pt2pl",
                                     stats=se)
    got = points.register_arrays_points_sharded(*batch, GOLDEN, "se3_pt2pl",
                                                 world, stats=sg)
    assert _same(got, want)
    assert sg["host_syncs"] == 0 and se["host_syncs"] > 0
    assert sg["loop_steps"] == se["loop_steps"]
    # the eager points route, its all_gathers polled step by step, too
    assert _same(reg.register_arrays_eager(*batch, GOLDEN, "se3", "pt2pl",
                                           group=world), want)
    captures = program.info()["captures"]
    assert _same(points.register_arrays_points_sharded(
        *batch, GOLDEN, "se3_pt2pl", world), want)
    assert program.info()["captures"] == captures
    pg, qg = points.mesh_2d(1, 1)
    batch = _batch(card, _problems(4))
    assert _same(points.register_batch_2d(*batch, GOLDEN, "se3_gicp", pg, qg),
                 reg.register_arrays_eager(*batch, GOLDEN, "se3", "gicp"))


def test_multihost_gives_the_one_process_bits(card, world):
    pl = [(p.source, p.target) for p in _problems(8)]
    want = pairs.register_pairs(pl, "se3_pt2pl", GOLDEN, mesh=False)
    got = multihost.register_pairs_multihost(pl, "se3_pt2pl", GOLDEN)
    assert [r.num_iterations for r in got] == [r.num_iterations for r in want]
    for a, b in zip(got, want):
        assert (a.transformation == b.transformation).all()


def test_a_gloo_group_refuses_card_tensors(card, world):
    import torch.distributed as dist
    gloo = dist.new_group(backend="gloo")
    with pytest.raises(ValueError, match="needs a nccl process group"):
        reg.check_group(gloo, card)
    batch = _batch(card, _problems(1))
    with pytest.raises(ValueError, match="needs a nccl process group"):
        points.register_arrays_points_sharded(*batch, GOLDEN, "se3_pt2pl",
                                              gloo)
