"""On the card a pair's result does not follow its batch.  These tests
need a CUDA device and ``nvcc``; elsewhere they skip (a CUDA kernel has
no interpret mode).  Run them on a GPU machine with
``python -m pytest tests/test_torch_gpu_batch_bits.py -q --noconftest``.

  * 8 golden-shape pairs registered in batches of 1, 2 and 8 (each batch
    packed at its own width) and as the first 8 of a 64-pair batch give
    every pair the same transform bits and iteration counts, for
    ``se3_pt2pl``, ``se3_gicp``, ``se3_pt2pt`` and ``pt2pl`` on the
    captured program (the batchings of ``chip_smoke.batch_size_runs``,
    which ``chip_smoke.py``'s hold runs as shards of a mesh).
  * FGR's 8 pairs the same way (its own captured program).
  * G4 at every cluster size (C = 1, 2, 4, 8 blocks a cloud), B = 1, 2
    and 64, N = 4608 and 15872: its plain version's bits.
  * G4 (``cuda_prep.center_scale``), G2 (``cuda_frames.frame_assembly``)
    and G3 (``cuda_step.step_update``) give their plain versions' bits at
    the main path's 64 x 4608 and the KITTI road's 1 x 15872, each
    launch counted.
"""

import pytest
import torch

from se3_icp_tpu_torch.datasets import fixtures
from se3_icp_tpu_torch.models import registration as reg
from se3_icp_tpu_torch.ops import (_build, cuda_frames, cuda_moments,
                                   cuda_prep, cuda_step, knn)
from se3_icp_tpu_torch.parallel import pairs
from se3_icp_tpu_torch.utils.config import GOLDEN, parse_algorithm

torch.set_num_threads(1)

pytestmark = pytest.mark.gpu


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    with knn.full_precision():
        yield torch.device("cuda")


def _same(a, b, what):
    assert a.shape == b.shape and a.dtype == b.dtype, what
    differ = a != b
    if a.is_floating_point():   # NaN == NaN for this purpose
        differ &= ~(torch.isnan(a) & torch.isnan(b))
    differ = int(differ.sum())
    assert differ == 0, f"{what}: {differ} entries differ from the plain bits"


def _packed(card, n_pairs, n, **kw):
    probs = [fixtures.golden_shape_problem(seed=s, n=n, **kw)
             for s in range(1, n_pairs + 1)]
    return [torch.as_tensor(a, device=card) for a in pairs.pack_pairs(
        [(p.source, p.target) for p in probs])]


@pytest.mark.parametrize("alg", ["se3_pt2pl", "se3_gicp", "se3_pt2pt",
                                 "pt2pl"])
def test_a_pair_gets_the_same_bits_in_any_batch(card, alg):
    import chip_smoke
    kw = fixtures.SMALL_POSE if alg == "pt2pl" else {}
    pl = [(p.source, p.target) for p in
          (fixtures.golden_shape_problem(seed=s, **kw) for s in range(1, 65))]
    runs = chip_smoke.batch_size_runs(
        pl, chip_smoke.one_call_a_batch(lambda b: pairs.register_pairs(
            b, alg, GOLDEN, mesh=False)), sizes=(1, 2))
    differ = chip_smoke.pairs_differing(
        runs, lambda a, b: chip_smoke.same_results([a], [b]))
    assert not any(differ.values()), differ


@pytest.mark.parametrize("n_pairs,n", [(64, 4167), (1, 15500)],
                         ids=["64x4608", "1x15872"])
def test_center_scale_gives_the_plain_bits(card, n_pairs, n):
    src, n_src, tgt, n_tgt = _packed(card, n_pairs, n)
    scale = reg.hyper(reg.split_cfg(GOLDEN, torch.float32,
                                    card)[0]).scale_preprocessing
    n0 = _build.launches()["center_scale"]
    got = cuda_prep.center_scale(src, n_src, tgt, n_tgt, scale)
    assert _build.launches()["center_scale"] == n0 + 1
    want = cuda_prep.center_scale_plain(src, n_src, tgt, n_tgt, scale)
    for name, a, b in zip(("src_c", "tgt_c", "cen_s", "cen_t", "scaling"),
                          got, want):
        _same(a, b, f"G4 {name}")
    # each pair alone: the same bits
    for b in (0, n_pairs - 1):
        one = cuda_prep.center_scale(src[b:b + 1], n_src[b:b + 1],
                                     tgt[b:b + 1], n_tgt[b:b + 1], scale)
        for name, a, c in zip(("src_c", "tgt_c", "cen_s", "cen_t",
                               "scaling"), one, got):
            _same(a[0], c[b], f"G4 {name}, pair {b} alone")


def test_fgr_gives_a_pair_the_same_bits_in_any_batch(card):
    """FGR's 8 golden-shape pairs at B = 1, 2 and 8 and as the first 8 of
    64, on its captured program: every pair the same transform bits and
    counts (``chip_smoke.fgr_batch_size_hold`` also holds shards on a
    mesh and the eager function)."""
    import chip_smoke
    from se3_icp_tpu_torch.models import fgr
    pl = [(p.source, p.target) for p in
          (fixtures.golden_shape_problem(seed=s) for s in range(1, 65))]

    def per_batch(batch):
        st = {}
        res = pairs.register_pairs(batch, "fgr", fgr.FGRConfig(),
                                   mesh=False, stats=st)
        return [(r.transformation.tolist(), st["reciprocal"][b],
                 st["kept_correspondences"][b]) for b, r in enumerate(res)]
    runs = chip_smoke.batch_size_runs(
        pl, chip_smoke.one_call_a_batch(per_batch), sizes=(1, 2))
    differ = chip_smoke.pairs_differing(runs, lambda a, b: a == b)
    assert not any(differ.values()), differ


@pytest.mark.parametrize("n", [4167, 15500], ids=["4608", "15872"])
@pytest.mark.parametrize("n_pairs", [1, 2, 64])
def test_center_scale_gives_the_plain_bits_at_every_cluster_size(
        card, n_pairs, n):
    """G4 with a cloud on C = 1, 2, 4 and 8 blocks (a pair's cluster 2C
    blocks): the plain version's bits at each, each launch counted."""
    src, n_src, tgt, n_tgt = _packed(card, n_pairs, n)
    scale = reg.hyper(reg.split_cfg(GOLDEN, torch.float32,
                                    card)[0]).scale_preprocessing
    want = cuda_prep.center_scale_plain(src, n_src, tgt, n_tgt, scale)
    assert cuda_prep.cluster_size(n_pairs, card) in cuda_prep.CLUSTERS
    for c in cuda_prep.CLUSTERS:
        n0 = _build.launches()["center_scale"]
        got = cuda_prep.center_scale(src, n_src, tgt, n_tgt, scale,
                                     cluster=c)
        assert _build.launches()["center_scale"] == n0 + 1
        for name, a, b in zip(("src_c", "tgt_c", "cen_s", "cen_t",
                               "scaling"), got, want):
            _same(a, b, f"G4 {name}, C = {c}")
    with pytest.raises(ValueError):
        cuda_prep.center_scale(src, n_src, tgt, n_tgt, scale, cluster=3)


@pytest.mark.parametrize("n_pairs,n", [(64, 4167), (1, 15500)],
                         ids=["64x4608", "1x15872"])
def test_frame_assembly_gives_the_plain_bits(card, n_pairs, n):
    src, n_src, tgt, n_tgt = _packed(card, n_pairs, n)
    h = reg.hyper(reg.split_cfg(GOLDEN, torch.float32, card)[0])
    pts, _, _ = reg.preprocess(src, n_src, tgt, n_tgt, GOLDEN, True, h)
    cloud = cuda_moments.setup_cloud(pts, n_src)
    cc = torch.tensor([90, 31, 30], dtype=torch.int32,
                      device=card).expand(n_pairs, -1)
    thr = cuda_moments.neighborhood_thresholds_batched(pts, n_src, cc,
                                                       cloud=cloud)
    raw = cuda_moments.moments_raw(pts, n_src, (thr[:, 2], thr[:, 1],
                                                thr[:, 0]), cloud)
    nrm, aux, fused = cuda_frames.frame_inputs(raw, pts, cloud.tn,
                                               thr[:, 0], 30, 30)
    w = cuda_moments.axis_sums_aux(pts, n_src, nrm, aux, cloud)
    for fz in (None, fused):
        n0 = _build.launches()["frame_assembly"]
        got = cuda_frames.frame_assembly(raw, pts, nrm, w, fz)
        assert _build.launches()["frame_assembly"] == n0 + 1
        want = cuda_frames.frame_assembly_plain(raw, pts, nrm, w, fz)
        _same(got[0], want[0], "G2 rows")
        _same(got[1], want[1].contiguous(), "G2 point-major frames")


@pytest.mark.parametrize("alg", ["se3_pt2pl", "se3_pt2pt"])
@pytest.mark.parametrize("n_pairs,n", [(64, 4167), (1, 15500)],
                         ids=["64x4608", "1x15872"])
def test_step_update_gives_the_plain_bits(card, alg, n_pairs, n):
    src, n_src, tgt, n_tgt = _packed(card, n_pairs, n)
    mode, variant = parse_algorithm(alg)
    floats, scfg = reg.split_cfg(GOLDEN, torch.float32, card)
    h = reg.hyper(floats)
    ms, pre = reg.setup(src, n_src, tgt, n_tgt, scfg, mode, variant, h)
    s, c = reg.init_loop(ms, pre.scaling, scfg, mode, h,
                         record_history=True)
    kw = dict(variant=ms.variant, is_se3=ms.is_se3, hybrid=c.hybrid,
              do_trim=c.ep_kw["do_trim"], max_iters=c.max_iters,
              max_se3_iters=scfg.max_num_se3_iterations)
    keys = cuda_step.STATE + ("hist", "W", "ph2", "pf")
    for step in range(4):
        A, b, st = reg._match_and_epilogue(s, ms, c, s.W, s.ph2, s.pf)
        if step == 2 and n_pairs > 1:
            s.switched[::3] = True
            s.done[1::4] = True
        state = {k: getattr(s, k) for k in keys}
        want = cuda_step.step_update_plain(
            A, b, st, {k: v.clone() for k, v in state.items()}, c.hv,
            c.stop_thresh, c.n_src_f, **kw)
        n0 = _build.launches()["step_update"]
        got = cuda_step.step_update(
            A, b, st, {k: v.clone() for k, v in state.items()}, c.hv,
            c.stop_thresh, c.n_src_f, **kw)
        assert _build.launches()["step_update"] == n0 + 1
        for k in keys:
            _same(got[k], want[k], f"{alg} step {step}: {k}")
        s = reg.LoopState(**{k: got[k] for k in keys})
    torch.cuda.synchronize()
