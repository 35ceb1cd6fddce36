"""The glue kernels' CUDA sources -- G1 and G2 (``csrc/frames.cu``) and
G3 (``csrc/step_update.cu``) -- compiled for the CPU against the
emulation of the CUDA built-ins (``tests/cuda_emulation.h``, as
``test_torch_kernels_emulated.py`` does) and called through their C
signatures on the wrappers' inputs, against the plain versions.

This checks their indexing, layouts, modes and control flow where no
card is available; the card holds them to the plain versions' bits
(``test_torch_gpu_glue.py``, ``chip_smoke.py``).  Here the two sides
round differently in a few places -- the CPU's torch divides a tensor by
a Python number where the card (and the kernel) multiplies by its
reciprocal, and its sqrt, acos, cos and sin are not the CUDA library's
-- so the comparison is at a tolerance: G1's normals parallel to 1e-5
for 99% of the queries, K3's operands the same thresholds, radii within
1e-6 relative and n.q within 1e-4 (it follows the normal); G2's
frames' entries within 1e-5 for 99% of the queries; G3's states equal in
every integer and flag, its floats within 1e-5 of 1 + their size.
Needs a host C++20 compiler (``g++``).
"""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

import torch_port_cases as cases
from se3_icp_tpu_torch.datasets import fixtures
from se3_icp_tpu_torch.models import registration as reg
from se3_icp_tpu_torch.ops import _build, cuda_frames, cuda_moments
from se3_icp_tpu_torch.ops import cuda_step
from se3_icp_tpu_torch.parallel import pairs
from se3_icp_tpu_torch.utils.config import GOLDEN, parse_algorithm

torch.set_num_threads(1)

# kernel<<<grid, threads, smem, stream>>>(args);
_LAUNCH = re.compile(
    r"(\w+(?:<[^<>;]*>)?)<<<([^,]+),\s*([^,]+),\s*([^,]+),[^>]*>>>"
    r"\((.*?)\);", re.S)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs a host C++20 compiler (g++) to emulate the "
                    "kernels")
    out = tmp_path_factory.mktemp("emulated_glue")
    here = _build.CSRC.parent.parent / "tests"
    shutil.copy(here / "cuda_emulation.h", out / "cuda_runtime.h")
    for h in _build.headers():
        shutil.copy(h, out / h.name)
    srcs = []
    for name in ("frames.cu", "step_update.cu"):
        text, n = _LAUNCH.subn(
            lambda m: (f"emu_launch({m.group(2)}, {m.group(3)}, "
                       f"{m.group(4)}, [&] {{ {m.group(1)}({m.group(5)}); "
                       "});"),
            (_build.CSRC / name).read_text())
        assert n > 0 and "<<<" not in text, name
        srcs.append(out / f"{name}.cpp")
        srcs[-1].write_text(text)
    so = out / "libglue.so"
    subprocess.run([cxx, "-std=c++20", "-O2", "-ffp-contract=off",
                    "-pthread", "-shared", "-fPIC", "-I", str(out),
                    *map(str, srcs), "-o", str(so)],
                   check=True, capture_output=True, text=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    for name in ("se3icp_frame_inputs", "se3icp_frame_assembly",
                 "se3icp_step_update"):
        fn = getattr(lib, name)
        fn.argtypes = _build.SIGNATURES[name]
        fn.restype = ctypes.c_int
    return lib


def _p(x):
    return None if x is None else x.data_ptr()


def _surface():
    pts = np.zeros((2, 512, 3), np.float32)
    nv = (480, 420)
    for b, n in enumerate(nv):
        pts[b, :n] = fixtures.golden_shape_problem(seed=b + 1, n=n).source
    nv = np.asarray(nv, np.int32)
    thr = cases.midpoint_thresholds(pts, nv, [30, 31, 90, 20])
    return torch.from_numpy(pts), torch.from_numpy(nv), torch.from_numpy(thr)


def _parallel(a, b, nv):
    """Share of valid queries whose unit vectors a, b [B,3,N] are
    parallel (either sign) to 1e-5."""
    ok, total = 0, 0
    for i, n in enumerate(nv.tolist()):
        d = (a[i, :, :n] * b[i, :, :n]).sum(0).abs()
        ok += int((d > 1 - 1e-5).sum())
        total += n
    return ok / total


def test_frame_kernels_follow_their_plain_versions(lib):
    pts, nv, thr = _surface()
    cloud = cuda_moments.setup_cloud(pts, nv)
    bsz, n, _ = pts.shape
    raw = cuda_moments.moments_raw(pts, nv, (thr[:, 0], thr[:, 1],
                                             thr[:, 2]), cloud)
    thr_k = thr[:, 2]
    out = torch.full((3, bsz, 3, n), float("nan"))
    code = lib.se3icp_frame_inputs(
        _p(raw), _p(pts), _p(cloud.tn), _p(thr_k), _p(out[0]), _p(out[1]),
        _p(out[2]), bsz, n, n, 0, thr_k.stride(0), 0, 1,
        cuda_frames._bits(np.float32(1) / np.float32(30)),
        cuda_frames._bits(1.0 / 30), 0, None)
    assert code == 0
    normal, aux, fused = cuda_frames.frame_inputs_plain(
        raw, pts, cloud.tn, thr_k, 30, 30)
    assert _parallel(out[0], normal, nv) >= 0.99
    assert _parallel(out[2], fused, nv) >= 0.99
    assert torch.equal(out[1][:, 0], aux[:, 0])
    torch.testing.assert_close(out[1][:, 1], aux[:, 1], rtol=1e-6, atol=0)
    torch.testing.assert_close(out[1][:, 2], aux[:, 2], rtol=0, atol=1e-4)
    # G2 on the kernel's own normal
    w = cuda_moments.axis_sums_aux(pts, nv, out[0], out[1], cloud)
    out_t = torch.full((bsz, 12, n), float("nan"))
    frames = torch.full((bsz, n, 9), float("nan"))
    code = lib.se3icp_frame_assembly(
        _p(raw), _p(pts), _p(out[0]), _p(w), _p(out[2]), _p(out_t),
        _p(frames), bsz, n, n, 0, None)
    assert code == 0
    ref_t, ref_frames = cuda_frames.frame_assembly_plain(
        raw, pts, out[0], w, out[2])
    assert torch.equal(frames, out_t[:, :9].mT)
    assert torch.equal(out_t[:, 9:], out[2])
    for b, nb in enumerate(nv.tolist()):
        err = (frames[b, :nb] - ref_frames[b, :nb]).abs().amax(1)
        assert float((err < 1e-5).float().mean()) >= 0.99
    # the one-ball modes on the count-20 ball
    one = cuda_moments.moments_raw(pts, nv, (thr[:, 3],), cloud)
    for mode, eps in ((1, None), (2, 1e-3)):
        got = torch.full((bsz, 3 if eps is None else 6, n), float("nan"))
        code = lib.se3icp_frame_inputs(
            _p(one), _p(pts), None, None, _p(got), None, None, bsz, n, n, 0,
            0, mode, 0, cuda_frames._bits(1.0 / 20),
            cuda_frames._bits(1.0 - eps) if eps else 0,
            cuda_frames._bits(eps) if eps else 0, None)
        assert code == 0
        want = cuda_frames.ball_normals_plain(one, pts, 20, 0, eps)
        if eps is None:
            assert _parallel(got, want, nv) >= 0.99
        else:
            valid = torch.arange(n)[None, :] < nv[:, None]
            close = ((got - want).abs().amax(1) < 1e-4) | ~valid
            assert float(close.float().mean()) >= 0.99


@pytest.mark.parametrize("alg,overlap", [
    ("se3_pt2pl", 0.75), ("se3_gicp", 1.0), ("se3_pt2pt", 1.0),
    ("pt2pl", 1.0)])
def test_step_kernel_follows_its_plain_version(lib, alg, overlap):
    probs = [fixtures.golden_shape_problem(seed=s, n=300 + 50 * s)
             for s in (1, 2, 3)]
    src, n_src, tgt, n_tgt = (torch.as_tensor(a) for a in pairs.pack_pairs(
        [(p.source, p.target) for p in probs]))
    cfg = GOLDEN.replace(estimated_overlap=overlap)
    mode, variant = parse_algorithm(alg)
    floats, scfg = reg.split_cfg(cfg, src.dtype, src.device)
    h = reg.hyper(floats)
    keys = cuda_step.STATE + ("hist", "W", "ph2", "pf")
    with torch.no_grad():
        ms, pre = reg.setup(src, n_src, tgt, n_tgt, scfg, mode, variant, h)
        s, c = reg.init_loop(ms, pre.scaling, scfg, mode, h,
                             record_history=True)
        for step in range(8):
            A, b, st = reg._match_and_epilogue(s, ms, c, s.W, s.ph2, s.pf)
            if step == 4:   # too few kept points, a zero system, a done pair
                A, st = A.clone(), st.clone()
                st[0, 1] = 2.0
                A[1] = 0.0
                s.done[2] = True
            state = {k: getattr(s, k) for k in keys}
            want = cuda_step.step_update_plain(
                A, b, st, state, c.hv, c.stop_thresh, c.n_src_f,
                variant=ms.variant, is_se3=ms.is_se3, hybrid=c.hybrid,
                do_trim=c.ep_kw["do_trim"], max_iters=c.max_iters,
                max_se3_iters=scfg.max_num_se3_iterations)
            got = {k: v.clone() for k, v in state.items()}
            code = lib.se3icp_step_update(
                _p(A), _p(b), _p(st), *(_p(got[k]) for k in (
                    "T", "it", "pure_it", "mse_prev", "mse_cur", "switched",
                    "done", "hist", "W", "ph2", "pf")), _p(c.hv),
                _p(c.stop_thresh), _p(c.n_src_f), A.shape[0],
                got["hist"].shape[1], int(ms.variant == "pt2pt"),
                int(ms.is_se3), int(c.hybrid), int(c.ep_kw["do_trim"]),
                c.max_iters, scfg.max_num_se3_iterations, None)
            assert code == 0
            for k in keys:
                x, y = got[k], want[k]
                if x.is_floating_point():
                    tol = 1e-5 * (1.0 + float(y.abs().max()))
                    assert float((x - y).abs().max()) <= tol, (step, k)
                else:
                    assert torch.equal(x, y), (step, k)
            if step == 4:          # the identity step leaves T as it was
                assert torch.equal(got["T"][0], state["T"][0])
            s = reg.LoopState(**{k: want[k] for k in keys})
    assert bool(s.it.min() >= 4)
