"""The glue kernels G1, G2 (``csrc/frames.cu``: the threshold setup's
frame inputs, normals, GICP covariances and TOLDI frame assembly) and G3
(``csrc/step_update.cu``: the loop step after the epilogue) against
their plain PyTorch versions on the card, bit for bit; and the captured
main path against the eager loop, bit for bit, with the glue kernels'
launches counted.  These tests need a CUDA device and ``nvcc``;
elsewhere they skip (a CUDA kernel has no interpret mode).  Run them on
a GPU machine with
``python -m pytest tests/test_torch_gpu_glue.py -q --noconftest``.

G1 and G2 at the main path's shape (64 x 4608), at the KITTI road's
(1 x 15872) and on a row slice; G3 for pt2pl, GICP (with and without
confidences), pt2pt and icp pt2pl, whole and trimmed, hybrid and not,
with done pairs, pairs in both phases and failing solves (a zero, a
non-finite and an under-counted system), its history row included.
"""

import numpy as np
import pytest
import torch

from se3_icp_tpu_torch.datasets import fixtures
from se3_icp_tpu_torch.models import registration as reg
from se3_icp_tpu_torch.ops import (_build, cuda_frames, cuda_moments,
                                   cuda_step)
from se3_icp_tpu_torch.parallel import pairs
from se3_icp_tpu_torch.utils.config import GOLDEN, parse_algorithm

torch.set_num_threads(1)

pytestmark = pytest.mark.gpu


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _same(a, b, what):
    if a is None or b is None:
        assert a is None and b is None, what
        return
    assert a.shape == b.shape and a.dtype == b.dtype, what
    differ = a != b
    if a.is_floating_point():   # NaN == NaN for this purpose
        differ &= ~(torch.isnan(a) & torch.isnan(b))
    differ = int(differ.sum())
    assert differ == 0, f"{what}: {differ} entries differ from the plain bits"


def _clouds(card, n_pairs, n):
    probs = [fixtures.golden_shape_problem(seed=s, n=n)
             for s in range(1, n_pairs + 1)]
    src, n_src, tgt, n_tgt = (torch.as_tensor(a, device=card)
                              for a in pairs.pack_pairs(
                                  [(p.source, p.target) for p in probs]))
    h = reg.hyper(reg.split_cfg(GOLDEN, torch.float32, card)[0])
    src_c, _, _ = reg.preprocess(src, n_src, tgt, n_tgt, GOLDEN, True, h)
    return src_c, n_src


@pytest.mark.parametrize("n_pairs,n,slices", [(64, 4167, 1), (1, 15000, 1),
                                              (8, 4167, 2)],
                         ids=["64x4608", "1x15872", "8x4608-row-slice"])
def test_frame_kernels_give_the_plain_bits(card, n_pairs, n, slices):
    pts, nv = _clouds(card, n_pairs, n)
    cloud = cuda_moments.setup_cloud(pts, nv)
    cc = torch.tensor([90, 31, 30, 20], dtype=torch.int32,
                      device=card).expand(n_pairs, -1)
    thr = cuda_moments.neighborhood_thresholds_batched(pts, nv, cc,
                                                       cloud=cloud)
    npad = pts.shape[1]
    step = npad // slices
    for r0 in range(0, npad, step):
        rows = None if slices == 1 else (r0, r0 + step)
        sl = slice(r0, r0 + step)
        raw = cuda_moments.moments_raw(
            pts, nv, (thr[:, 2, sl], thr[:, 1, sl], thr[:, 0, sl]), cloud,
            rows)
        n0 = _build.launches()["frame_inputs"]
        got = cuda_frames.frame_inputs(raw, pts, cloud.tn, thr[:, 0, sl], 30,
                                       30, r0)
        assert _build.launches()["frame_inputs"] == n0 + 1
        want = cuda_frames.frame_inputs_plain(raw, pts, cloud.tn,
                                              thr[:, 0, sl], 30, 30, r0)
        for name, a, b in zip(("normal", "aux", "fused normal"), got, want):
            _same(a, b, f"G1 {name}")
        w = cuda_moments.axis_sums_aux(pts, nv, got[0], got[1], cloud, rows)
        out = cuda_frames.frame_assembly(raw, pts, got[0], w, got[2], r0)
        ref = cuda_frames.frame_assembly_plain(raw, pts, got[0], w, got[2],
                                               r0)
        _same(out[0], ref[0], "G2 rows")
        _same(out[1], ref[1].contiguous(), "G2 point-major frames")
        # the one-ball modes on the GICP normals' ball (count 20)
        one = cuda_moments.moments_raw(pts, nv, (thr[:, 3, sl],), cloud,
                                       rows)
        for eps in (None, 1e-3):
            _same(cuda_frames.ball_normals(one, pts, 20, r0, eps),
                  cuda_frames.ball_normals_plain(one, pts, 20, r0, eps),
                  f"G1 one ball, gicp epsilon {eps}")
    torch.cuda.synchronize()


def _loop_state(card, alg, cfg, n_pairs=8):
    probs = [fixtures.golden_shape_problem(seed=s, n=900 + 37 * s)
             for s in range(1, n_pairs + 1)]
    src, n_src, tgt, n_tgt = (torch.as_tensor(a, device=card)
                              for a in pairs.pack_pairs(
                                  [(p.source, p.target) for p in probs]))
    mode, variant = parse_algorithm(alg)
    floats, scfg = reg.split_cfg(cfg, torch.float32, card)
    h = reg.hyper(floats)
    ms, pre = reg.setup(src, n_src, tgt, n_tgt, scfg, mode, variant, h)
    s, c = reg.init_loop(ms, pre.scaling, scfg, mode, h,
                         record_history=True)
    return ms, s, c


@pytest.mark.parametrize("alg,overlap", [
    ("se3_pt2pl", 1.0), ("se3_pt2pl", 0.75), ("se3_gicp", 1.0),
    ("se3_gicp_with_cf", 0.75), ("se3_pt2pt", 1.0), ("se3_pt2pt", 0.75),
    ("se3_pure_pt2pl", 1.0), ("pt2pl", 0.75), ("pt2pt", 1.0)])
def test_step_kernel_gives_the_plain_bits(card, alg, overlap):
    cfg = GOLDEN.replace(estimated_overlap=overlap)
    ms, s, c = _loop_state(card, alg, cfg)
    bsz = ms.feat16.shape[0]
    kw = dict(variant=ms.variant, is_se3=ms.is_se3, hybrid=c.hybrid,
              do_trim=c.ep_kw["do_trim"], max_iters=c.max_iters,
              max_se3_iters=c.cfg.max_num_se3_iterations)
    keys = cuda_step.STATE + ("hist", "W", "ph2", "pf")
    for step in range(6):
        A, b, st = reg._match_and_epilogue(s, ms, c, s.W, s.ph2, s.pf)
        if step == 3:
            # mixed phases, done pairs and failing solves
            s.switched[::3] = True
            s.done[1::4] = True
            A = A.clone()
            st = st.clone()
            A[2] = 0.0
            A[3, 1, 2] = float("nan")
            st[5, 1] = 2.0
        state = {k: getattr(s, k) for k in keys}
        plain = cuda_step.step_update_plain(
            A, b, st, {k: v.clone() for k, v in state.items()}, c.hv,
            c.stop_thresh, c.n_src_f, **kw)
        n0 = _build.launches()["step_update"]
        got = cuda_step.step_update(
            A, b, st, {k: v.clone() for k, v in state.items()}, c.hv,
            c.stop_thresh, c.n_src_f, **kw)
        assert _build.launches()["step_update"] == n0 + 1
        for k in keys:
            _same(got[k], plain[k], f"{alg} step {step}: {k}")
        s = reg.LoopState(**{k: got[k] for k in keys})
    assert bsz == 8 and bool(s.done.any())
    torch.cuda.synchronize()


@pytest.mark.parametrize("alg", ["se3_pt2pl", "se3_gicp", "se3_pt2pt"])
def test_captured_main_path_gives_the_eager_bits(card, alg):
    probs = [fixtures.golden_shape_problem(seed=s) for s in range(1, 9)]
    plist = [(p.source, p.target) for p in probs]
    pairs.register_pairs(plist, alg, GOLDEN)            # capture
    _build.zero_launches()
    st = {}
    got = pairs.register_pairs(plist, alg, GOLDEN, stats=st)
    launches = _build.launches()
    orig = reg.loop_route
    reg.loop_route = lambda *a, **kw: "eager"
    try:
        se = {}
        ref = pairs.register_pairs(plist, alg, GOLDEN, stats=se)
    finally:
        reg.loop_route = orig
    assert st["loop_steps"] == se["loop_steps"] > 0 and st["host_syncs"] == 0
    for a, b in zip(got, ref):
        assert a.num_iterations == b.num_iterations
        assert np.array_equal(a.transformation, b.transformation)
    assert launches["step_update"] == st["loop_steps"]
    assert launches["frame_assembly"] == 2
    # G1: each cloud's TOLDI pass; GICP's normals pass a cloud more
    assert launches["frame_inputs"] == (4 if alg == "se3_gicp" else 2)
