"""The port's CUDA kernels against their plain PyTorch versions, on
the card.  These tests need a CUDA device and ``nvcc``; elsewhere they
skip (a CUDA kernel has no interpret mode).  Run them on a GPU machine
with ``python -m pytest tests/test_torch_gpu_kernels.py -q --noconftest``
(they need no jax, which ``conftest.py`` would import); the full
on-card check at the main path's shapes is ``python3 chip_smoke.py``.

Tolerances as in ``chip_smoke.py``: the match's shifted d2 to 1e-4
absolute with at most 1% of rows matched to another (near-tied) target;
at its edges (tiles, phases, done pairs, ties) as in the emulated
kernel tests, with its R3-phase chain bit-equal to its 12-FMA chain;
the epilogue's kept count exact, sums to 1e-5 (gicp 1e-4) of the
largest entry; the setup kernels' thresholds bit-equal, their ball
counts equal, K2's sums to 1e-5 and K3's to 1e-4 of each row's largest
entry (float32 sums in another order); the 1-NN kernels K6-K9 their d2
to 1e-5 of |q|^2 + max |t|^2, indices equal except between targets
within that of each other (at most 1% of rows), matched rows copies of
the indexed payload rows.
"""

import copy

import numpy as np
import pytest
import torch

import torch_kernel_cases as kcases

from se3_icp_tpu_torch.datasets import fixtures
from se3_icp_tpu_torch.models import registration as reg
from se3_icp_tpu_torch.ops import (_build, cuda_knn, cuda_loop, cuda_moments,
                                   cuda_nn)
from se3_icp_tpu_torch.parallel import pairs
from se3_icp_tpu_torch.utils import metrics_host
from se3_icp_tpu_torch.utils.config import GOLDEN, parse_algorithm

# the suite runs several worker processes side by side: keep each
# one's torch thread pool small
torch.set_num_threads(1)

pytestmark = pytest.mark.gpu


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _state(card, alg, cfg):
    probs = [fixtures.golden_shape_problem(seed=s, n=n)
             for s, n in ((1, 900), (2, 777), (3, 1024))]
    src, n_src, tgt, n_tgt = pairs.pack_pairs(
        [(p.source, p.target) for p in probs])
    t = lambda a: torch.as_tensor(a, device=card)
    mode, variant = parse_algorithm(alg)
    h = reg.hyper(reg.split_cfg(cfg, torch.float32, card)[0])
    ms, _ = reg.setup(t(src), t(n_src), t(tgt), t(n_tgt), cfg, mode,
                      variant, h)
    eye = torch.eye(4, device=card).repeat(len(probs), 1, 1)
    switched = torch.tensor([False, True, False], device=card)
    W, phase, pf = reg.iteration_inputs(ms, cfg, eye, switched,
                                        torch.zeros_like(switched), h)
    return ms, W, phase, pf


@pytest.mark.parametrize("alg,overlap", [
    ("se3_pt2pl", 1.0), ("se3_pt2pl", 0.75), ("se3_pt2pt", 0.75),
    ("se3_gicp", 1.0), ("se3_gicp_with_cf", 0.75), ("pt2pl", 1.0),
])
def test_kernels_match_their_plain_versions(card, alg, overlap):
    cfg = GOLDEN.replace(estimated_overlap=overlap)
    ms, W, phase, pf = _state(card, alg, cfg)
    n0 = _build.launches()["nn_match_affine"]
    d2, mt = cuda_knn.nn_match_affine(ms.feat16, W, ms.targets, phase)
    assert _build.launches()["nn_match_affine"] == n0 + 1
    d2p, mtp = cuda_knn.nn_match_affine_plain(ms.feat16, W, ms.targets,
                                              phase)
    assert float((d2 - d2p).abs().max()) <= 1e-4
    assert float((mt != mtp).any(1).float().mean()) <= 0.01
    kw = reg.epilogue_options(ms, cfg)
    args = (ms.src_cT, mtp, pf, ms.cov_src6, ms.conf_src)
    A, b, st = cuda_loop.loop_epilogue_batched(*args, **kw)
    Ap, bp, stp = cuda_loop.loop_epilogue_plain(*args, **kw)
    assert bool((st[:, 1] == stp[:, 1]).all())
    rel = 1e-4 if ms.variant == "gicp" else 1e-5
    for k, p in ((A, Ap), (b, bp)):
        scale = p.abs().flatten(1).amax(1).clamp_min(1.0)
        assert float(((k - p).abs().flatten(1).amax(1) / scale).max()) <= rel
    np.testing.assert_allclose(st[:, 0].cpu().numpy(),
                               stp[:, 0].cpu().numpy(), rtol=1e-5)


def test_kernels_refuse_what_they_do_not_take(card):
    ms, W, phase, _ = _state(card, "se3_pt2pl", GOLDEN)
    with pytest.raises(TypeError):
        cuda_knn.nn_match_affine(ms.feat16.double(), W, ms.targets, phase)
    with pytest.raises(ValueError):
        cuda_knn.nn_match_affine(ms.feat16[:, :, :12], W, ms.targets, phase)
    with pytest.raises(ValueError):
        cuda_knn.nn_match_affine(ms.feat16, W.cpu(), ms.targets, phase)


@pytest.mark.parametrize("n_tied", [2, 3, 5])
def test_match_kernel_averages_exact_ties(card, n_tied):
    """A target present n_tied times: the kernel averages the tied
    payload rows -- two gathered directly, three or more through its
    second pass over the targets."""
    rng = np.random.default_rng(8)
    nq, nt, p = 200, 300, 4
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32),
                                  device=card)
    emb = np.zeros((1, nt, 12))
    emb[:, :, 9:12] = rng.normal(size=(1, nt, 3))
    emb[0, 1:n_tied, 9:12] = emb[0, 0, 9:12]
    emb[0, n_tied:, 9:12] += 100.0
    pay = rng.normal(size=(1, nt, p)).astype(np.float32)
    feat = np.zeros((1, nq, 16))
    feat[:, :, 12] = 1.0
    feat[0, :, 9:12] = emb[0, 0, 9:12] + 1e-3 * rng.normal(size=(nq, 3))
    W = np.zeros((1, 16, 16))
    W[:, 9:12, 9:12] = np.eye(3)
    targets = cuda_knn.pack_match_targets(
        t(emb), t(emb), t(pay),
        torch.tensor([nt], dtype=torch.int32, device=card))
    phase = torch.tensor([[1, 0]], dtype=torch.int32, device=card)
    _, m = cuda_knn.nn_match_affine(t(feat), t(W), targets, phase)
    _, mp = cuda_knn.nn_match_affine_plain(t(feat), t(W), targets, phase)
    want = np.broadcast_to(pay[0, :n_tied].mean(0), (nq, p))
    np.testing.assert_allclose(m[0].cpu().numpy().T, want, rtol=1e-6)
    np.testing.assert_allclose(m.cpu().numpy(), mp.cpu().numpy(), rtol=1e-6)


@pytest.mark.parametrize("nq,nt,n_tgt", [
    (4608, 4608, (4167, 100, 4167)),
    (4200, 4608, (4167, 77, 4000)),
], ids=["main-shape", "ragged"])
def test_match_kernel_at_its_edges(card, nq, nt, n_tgt):
    """K4 at the main path's width: query counts a whole and not a whole
    number of blocks, a pair with fewer valid targets than one tile,
    SE(3)-phase, R3-phase and done pairs in one batch, exact ties of two
    and three duplicated rows, rows past n_tgt never matched; the R3
    pair's 3-FMA chain bit-equal to the 12-FMA chain on its targets."""
    feat, w, targets, phase, same = kcases.match_edge_case(nq, nt, n_tgt,
                                                          device=card)
    d2, mt = cuda_knn.nn_match_affine(feat, w, targets, phase)
    d2_p, mt_p = cuda_knn.nn_match_affine_plain(feat, w, targets, phase)
    kcases.hold_match(d2, mt, d2_p, mt_p, targets)
    d2_s, mt_s = cuda_knn.nn_match_affine(feat, w, same,
                                          torch.zeros_like(phase))
    assert torch.equal(d2_s[1], d2[1]) and torch.equal(mt_s[1], mt[1])


def test_match_kernel_finds_a_tie_across_tiles(card):
    feat, w, targets, phase = kcases.match_tie_case(device=card)
    _, mt = cuda_knn.nn_match_affine(feat, w, targets, phase)
    _, mt_p = cuda_knn.nn_match_affine_plain(feat, w, targets, phase)
    want = targets.payload[:, [3, 4, 200]].mean(1)
    torch.testing.assert_close(mt, want[..., None].expand_as(mt),
                               rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(mt, mt_p, rtol=1e-6, atol=1e-6)


def test_register_pairs_on_the_card_matches_the_cpu_route(card):
    probs = [fixtures.golden_shape_problem(seed=s, n=600) for s in (1, 2)]
    pl = [(p.source, p.target) for p in probs]
    on_card = pairs.register_pairs(pl, "se3_pt2pl", GOLDEN)
    on_cpu = pairs.register_pairs(pl, "se3_pt2pl", GOLDEN, device="cpu")
    for p, a, b in zip(probs, on_card, on_cpu):
        assert metrics_host.success(p.T_gt, a.transformation)
        assert a.num_iterations == b.num_iterations
        assert metrics_host.angular_error_so3(
            a.transformation[:3, :3], b.transformation[:3, :3]) < 1e-3


def test_kernels_at_the_kitti_bucket(card):
    """N = 15360: the trim keys of one pair (61 KB) exceed the 48 KB a
    block gets without asking, so the epilogue takes its opt-in
    shared-memory path; the match walks 120 target tiles."""
    rng = np.random.default_rng(0)
    bsz, n, p = 2, 15360, 9
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32),
                                  device=card)
    srcT = t(rng.normal(size=(bsz, 3, n)))
    mt = rng.normal(size=(bsz, p, n))
    mt[:, 6:9] /= np.linalg.norm(mt[:, 6:9], axis=1, keepdims=True)
    pf = np.zeros((bsz, cuda_loop.PF_WIDTH))
    pf[:, cuda_loop.PF_BETA] = 1.0
    pf[:, cuda_loop.PF_SWITCHED] = (0.0, 1.0)
    pf[:, cuda_loop.PF_NSRC] = (15360, 14001)
    pf[:, cuda_loop.PF_COUNT] = np.floor(0.7 * pf[:, cuda_loop.PF_NSRC])
    pf[:, cuda_loop.PF_R:cuda_loop.PF_R + 9] = np.eye(3).reshape(9)
    kw = dict(variant="pt2pl", is_se3=True, use_cf=False, do_trim=True,
              off_tr=3, off_nrm=6)
    A, b, st = cuda_loop.loop_epilogue_batched(srcT, t(mt), t(pf), **kw)
    Ap, bp, stp = cuda_loop.loop_epilogue_plain(srcT, t(mt), t(pf), **kw)
    assert st[:, 1].tolist() == stp[:, 1].tolist() == \
        pf[:, cuda_loop.PF_COUNT].tolist()
    for k, q in ((A, Ap), (b, bp), (st, stp)):
        scale = q.abs().flatten(1).amax(1).clamp_min(1.0)
        assert float(((k - q).abs().flatten(1).amax(1) / scale).max()) <= 1e-5

    feat = np.zeros((bsz, n, 16))
    feat[:, :, 9:12] = rng.normal(size=(bsz, n, 3))
    feat[:, :, 12] = 1.0
    W = np.zeros((bsz, 16, 16))
    W[:, 9:12, 9:12] = np.eye(3)
    emb = np.zeros((bsz, n, 12))
    emb[:, :, 9:12] = rng.normal(size=(bsz, n, 3))
    targets = cuda_knn.pack_match_targets(
        t(emb), t(emb), t(rng.normal(size=(bsz, n, p))),
        torch.tensor([15360, 15000], dtype=torch.int32, device=card))
    phase = torch.tensor([[1, 0], [1, 0]], dtype=torch.int32, device=card)
    d2, m = cuda_knn.nn_match_affine(t(feat), t(W), targets, phase)
    d2p, mp = cuda_knn.nn_match_affine_plain(t(feat), t(W), targets, phase)
    assert float((d2 - d2p).abs().max()) <= 1e-4
    assert float((m != mp).any(1).float().mean()) <= 0.01


def _row_rel(got, ref):
    """max over (pair, component row) of max |got - ref| / max |ref|."""
    g = got.reshape(got.shape[0], -1, got.shape[-1])
    r = ref.reshape(ref.shape[0], -1, ref.shape[-1])
    scale = r.abs().amax(-1).clamp_min(1e-30)
    return float(((g - r).abs().amax(-1) / scale).max())


@pytest.mark.parametrize("n,n_valid,counts", [
    (1024, (1024, 777), (90, 31, 30)),
    (1024, (900, 1024), (90, 31, 30, 20)),
    (15360, (15360, 14001), (90, 31, 30)),
])
def test_setup_kernels_match_their_plain_versions(card, n, n_valid, counts):
    """K1 bit-equal to its plain version (same rounding steps); K2's ball
    counts equal and its sums, K3's sums within tolerance; K2 and K3 the
    same bits in the index order as in the spatial order.  N = 15360 is
    the KITTI bucket: K1 streams 30 target tiles, and K3's balls are
    larger in absolute terms."""
    probs = [fixtures.golden_shape_problem(seed=s + 1, n=v)
             for s, v in enumerate(n_valid)]
    pts = np.zeros((len(probs), n, 3), np.float32)
    for b, p in enumerate(probs):
        pts[b, :len(p.source)] = p.source - p.source.mean(0)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=card)
    pts_d, nv = t(pts), t(np.asarray(n_valid, np.int32))
    cc = t(np.asarray([counts] * len(probs), np.int32))
    cloud = cuda_moments.setup_cloud(pts_d, nv)
    n0 = _build.launches()["neighborhood_thresholds_batched"]
    thr = cuda_moments.neighborhood_thresholds_batched(pts_d, nv, cc,
                                                       cloud=cloud)
    assert _build.launches()["neighborhood_thresholds_batched"] == n0 + 1
    thr_p = cuda_moments.neighborhood_thresholds_plain(pts_d, nv, cc,
                                                       cloud=cloud)
    assert bool((thr == thr_p).all())

    args = (pts_d, nv, thr[:, 2], thr[:, 1], thr[:, 0])
    mom = cuda_moments.moments_batched(*args, cloud=cloud)
    mom_p = cuda_moments.moments_plain(*args, cloud=cloud)
    for key in ("cen_cnt", "cov_cnt", "all_cnt"):
        assert bool((mom[key] == mom_p[key]).all()), key
    for key in ("cen_sum", "cen_p9", "cov_sum", "cov_p9", "all_sum"):
        assert _row_rel(mom[key], mom_p[key]) <= 1e-5, key
    by_index = copy.copy(cloud)
    by_index.order = torch.arange(n, dtype=torch.int32,
                                  device=card).repeat(len(probs), 1)
    mom_i = cuda_moments.moments_batched(*args, cloud=by_index)
    for key in mom:
        assert torch.equal(mom_i[key], mom[key]), key

    nrm = torch.nn.functional.normalize(mom["cov_sum"], dim=1)
    ndotq = (nrm * mom["q_t"]).sum(1)
    radius = thr[:, 0].clamp_min(0.0).sqrt()
    ax = cuda_moments.axis_sums_batched(pts_d, nv, nrm, ndotq, radius,
                                        thr[:, 0], cloud=cloud)
    ax_p = cuda_moments.axis_sums_plain(pts_d, nv, nrm, ndotq, radius,
                                        thr[:, 0], cloud=cloud)
    assert _row_rel(ax[0], ax_p[0]) <= 1e-4
    assert _row_rel(ax[1][:, None], ax_p[1][:, None]) <= 1e-4
    ax_i = cuda_moments.axis_sums_batched(pts_d, nv, nrm, ndotq, radius,
                                          thr[:, 0], cloud=by_index)
    assert torch.equal(ax_i[0], ax[0]) and torch.equal(ax_i[1], ax[1])


@pytest.mark.parametrize("counts", [(20,), (90, 31, 30, 20)],
                         ids=["T1", "T4"])
def test_thresholds_kernel_at_its_edges(card, counts):
    """K1 bit-equal to its plain version at width 600 (not a multiple of
    the 32 queries a block) with n_valid 1, 511 and 513."""
    points, nv = (x.to(card) for x in kcases.threshold_edge_clouds())
    cc = torch.tensor([counts] * points.shape[0], device=card)
    thr = cuda_moments.neighborhood_thresholds_batched(points, nv, cc)
    thr_p = cuda_moments.neighborhood_thresholds_plain(points, nv, cc)
    assert bool((thr == thr_p).all())


def test_setup_kernels_refuse_what_they_do_not_take(card):
    pts = torch.zeros((2, 512, 3), device=card)
    nv = torch.tensor([512, 500], dtype=torch.int32, device=card)
    cloud = cuda_moments.setup_cloud(pts, nv)
    thr = torch.ones((2, 512), device=card)
    with pytest.raises(ValueError):        # nine counts: more than K1 takes
        cuda_moments.neighborhood_thresholds_batched(
            pts, nv, torch.ones((2, 9), dtype=torch.int32, device=card))
    bad = cuda_moments.SetupCloud(cloud.pts_t.double(), cloud.tn, cloud.n)
    with pytest.raises(TypeError):
        cuda_moments.moments_batched(pts, nv, thr, thr, thr, cloud=bad)
    with pytest.raises(ValueError):
        cuda_moments.axis_sums_batched(pts, nv, torch.zeros((2, 3, 256),
                                                            device=card),
                                       thr, thr, thr, cloud=cloud)


def _nn_hold(q, t, n, idx, d2, idx_p, d2_p):
    col = torch.arange(t.shape[1], device=t.device)
    tn = torch.where(col[None] < n[:, None], (t * t).sum(-1), 0.0)
    scale = (q * q).sum(-1) + tn.amax(-1, keepdim=True) + 1.0
    assert float(((d2 - d2_p).abs() / scale).max()) <= 1e-5
    assert bool((idx >= 0).all() and (idx < n[:, None]).all())
    differ = idx != idx_p
    assert float(differ.float().mean()) <= 0.01
    b, i = differ.nonzero(as_tuple=True)
    qd = q[b, i].double()
    dk = ((qd - t[b, idx[b, i].long()].double()) ** 2).sum(-1)
    dp = ((qd - t[b, idx_p[b, i].long()].double()) ** 2).sum(-1)
    assert bool(((dk - dp).abs() <= 2e-5 * scale[b, i].double()).all())


@pytest.mark.parametrize("n,d", [(1024, 3), (1024, 12), (1024, 33),
                                 (15360, 3), (15360, 12)])
def test_nn_kernels_match_their_plain_versions(card, n, d):
    """K6, K9, K7 (and K8 at D = 12) at N = 1024 and at the KITTI bucket
    N = 15360 (120 target tiles), targets padded in the second pair; K8
    with the bits of the one-query-a-thread search at S = 1."""
    g = torch.Generator().manual_seed(n + d)
    q = torch.randn(2, n, d, generator=g).to(card)
    t = torch.randn(2, n, d, generator=g).to(card)
    nv = torch.tensor([n, n - 77], dtype=torch.int32, device=card)
    n0 = _build.launches()["nn_argmin_batched"]
    out = cuda_nn.nn_argmin_batched(q, t, nv)
    assert _build.launches()["nn_argmin_batched"] == n0 + 1
    _nn_hold(q, t, nv, *out, *cuda_nn.nn_argmin_batched_plain(q, t, nv))
    n0 = _build.launches()["nn_argmin_unbatched"]
    i1, d1 = cuda_nn.nn_argmin_unbatched(q[1], t[1], nv[1])
    assert _build.launches()["nn_argmin_unbatched"] == n0 + 1
    _nn_hold(q[1:], t[1:], nv[1:], i1[None], d1[None],
             *(x[None] for x in cuda_nn.nn_argmin_unbatched_plain(
                 q[1], t[1], nv[1])))
    pay = torch.randn(2, n, 9, generator=g).to(card)
    idx, d2, m = cuda_nn.nn_match_batched(q, t, pay, nv)
    ip, dp, _ = cuda_nn.nn_match_batched_plain(q, t, pay, nv)
    _nn_hold(q, t, nv, idx, d2, ip, dp)
    assert torch.equal(m, cuda_nn._gather_rows(pay, idx))
    if d == 12:
        t_b = t.clone()
        t_b[..., :9] = 0.0
        targets = cuda_knn.pack_match_targets(t, t_b, pay, nv)
        phase = torch.tensor([0, 1], dtype=torch.int32, device=card)
        n0 = _build.launches()["nn_match_packed"]
        idx, d2, m = cuda_nn.nn_match_packed(q, targets, phase)
        assert _build.launches()["nn_match_packed"] == n0 + 1
        ip, dp, _ = cuda_nn.nn_match_packed_plain(q, targets, phase)
        _nn_hold(q, torch.stack([t[0], t_b[1]]), nv, idx, d2, ip, dp)
        assert torch.equal(m, cuda_nn._gather_rows(pay, idx))
        ref = cuda_nn.untiled_match_packed(q, targets, phase, split=1)
        assert all(torch.equal(a, b) for a, b in zip((idx, d2, m), ref))


def test_nn_kernels_refuse_what_they_do_not_take(card):
    q = torch.zeros((2, 64, 3), device=card)
    nv = torch.tensor([64, 60], dtype=torch.int32, device=card)
    with pytest.raises(TypeError):
        cuda_nn.nn_argmin_batched(q.double(), q.double(), nv)
    with pytest.raises(ValueError):              # no kernel of width 5
        cuda_nn.nn_argmin_batched(torch.zeros((2, 64, 5), device=card),
                                  torch.zeros((2, 64, 5), device=card), nv)
    with pytest.raises(ValueError):
        cuda_nn.nn_argmin_batched(q, q.cpu(), nv)
    with pytest.raises(TypeError):
        cuda_nn.nn_argmin_batched(q, q, nv.long())
    with pytest.raises(ValueError):
        cuda_nn.nn_match_batched(q, q, torch.zeros((2, 63, 4), device=card),
                                 nv)


@pytest.mark.parametrize("variant,is_se3,use_cf,overlap,ties", [
    ("pt2pl", True, False, 1.0, False),
    ("pt2pt", True, False, 0.6, True),
    ("gicp", True, True, 0.75, False),
])
def test_epilogue_cluster_sizes_give_the_same_bits(card, variant, is_se3,
                                                   use_cf, overlap, ties):
    """K5 as a cluster of C = 1, 2, 4 and 8 blocks a pair: the bits of
    C = 1 for every C, and the plain version's kept count and sums; a
    size the kernel does not take is refused."""
    case = [None if x is None else x.to(card) for x in
            kcases.epilogue_case(variant, is_se3, use_cf, overlap,
                                 ties=ties)[:5]]
    kw = kcases.epilogue_case(variant, is_se3, use_cf, overlap,
                              ties=ties)[5]
    ref = cuda_loop.loop_epilogue_batched(*case, **kw, cluster=1)
    kcases.hold_epilogue(ref, cuda_loop.loop_epilogue_plain(*case, **kw),
                         variant)
    for c in (2, 4, 8):
        got = cuda_loop.loop_epilogue_batched(*case, **kw, cluster=c)
        assert all(torch.equal(a, b) for a, b in zip(got, ref)), c
    with pytest.raises(ValueError):
        cuda_loop.loop_epilogue_batched(*case, **kw, cluster=3)


@pytest.mark.parametrize("d", [3, 12])
def test_split_search_gives_the_unsplit_bits(card, d):
    """K9 with the targets split over S = 2 to 8 blocks a query tile:
    the bits of S = 1 on every pair of the split case (counts past,
    inside and at slice boundaries, one target; ties across a boundary),
    with an int count and a device count; the tiled K6 on the batch
    gives the same bits."""
    q, t, n = (x.to(card) for x in kcases.split_case(d))
    tiled = cuda_nn.nn_argmin_batched(q, t, n)
    for b in range(q.shape[0]):
        ref = cuda_nn.nn_argmin_unbatched(q[b], t[b], n[b], split=1)
        assert torch.equal(ref[0], tiled[0][b])
        assert torch.equal(ref[1], tiled[1][b])
        for s in range(2, cuda_nn.MAX_SPLIT + 1):
            got = cuda_nn.nn_argmin_unbatched(q[b], t[b], n[b], split=s)
            assert torch.equal(got[0], ref[0]) and torch.equal(got[1],
                                                               ref[1])
        got = cuda_nn.nn_argmin_unbatched(q[b], t[b], int(n[b]))
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert int(tiled[0][0, 0]) == kcases.TIE_LO
    with pytest.raises(ValueError):
        cuda_nn.nn_argmin_unbatched(q[0], t[0], n[0], split=9)


@pytest.mark.parametrize("one_point", [False, True],
                         ids=["planted-ties", "one-point"])
@pytest.mark.parametrize("d", [3, 12, 33, 64])
def test_tiled_search_gives_the_untiled_bits(card, d, one_point):
    """K6 and K7 (the register-tiled search) against the
    one-query-a-thread search at S = 1 on the same batch, bit for bit,
    on the emulated tests' case: ragged query and target tiles, a pair
    with no valid target (row 0, 3.4e38 + |q|^2), exact ties inside a
    thread's step, between the threads of a query, across steps and
    tiles; K7's rows are copies of the payload rows."""
    q, t, n = (x.to(card) for x in kcases.tiled_case(d, one_point))
    idx, d2 = cuda_nn.nn_argmin_batched(q, t, n)
    ref = cuda_nn.untiled_argmin(q, t, n, split=1)
    assert torch.equal(idx, ref[0]) and torch.equal(d2, ref[1])
    for (b, i), j in kcases.tiled_answers(one_point).items():
        assert int(idx[b, i]) == j, (b, i)
    assert bool((idx[1] == 0).all() and (d2[1] >= 3.4e38).all())
    pay = torch.randn(4, t.shape[1], 9, device=card)
    idx_m, d2_m, m = cuda_nn.nn_match_batched(q, t, pay, n)
    assert torch.equal(idx_m, idx) and torch.equal(d2_m, d2)
    assert torch.equal(m, cuda_nn._gather_rows(pay, idx))


@pytest.mark.parametrize("case", ["planted-ties", "one-point", "given-tn"])
def test_tiled_packed_match_gives_the_untiled_bits(card, case):
    """K8 (the tiled search on packed targets, a phase block per pair)
    against the one-query-a-thread search at S = 1, bit for bit, on the
    emulated tests' case: phases 0, 1, 1, 0, the wrong block one row
    off, the planted answers (``given-tn``: a given |t|^2 one ulp lower
    wins its tie), the pair with no valid target (row 0, 3.4e38 +
    |q|^2)."""
    q, targets, phase, answers = kcases.packed_case(
        one_point=case == "one-point", nudge=case == "given-tn",
        device=card)
    out = cuda_nn.nn_match_packed(q, targets, phase)
    ref = cuda_nn.untiled_match_packed(q, targets, phase, split=1)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    idx, d2, m = out
    for (b, i), j in answers.items():
        assert int(idx[b, i]) == j, (b, i)
    assert bool((idx[1] == 0).all() and (d2[1] >= 3.4e38).all())
    assert torch.equal(m, cuda_nn._gather_rows(targets.payload, idx))
