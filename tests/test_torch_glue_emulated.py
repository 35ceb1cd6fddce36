"""The glue kernels' CUDA sources -- G1 and G2 (``csrc/frames.cu``), G3
(``csrc/step_update.cu``) and G4 (``csrc/prep.cu``) -- compiled for the
CPU against the emulation of the CUDA built-ins
(``tests/cuda_emulation.h``, as ``test_torch_kernels_emulated.py`` does)
and called through their C signatures on the wrappers' inputs, against
the plain versions.

This checks their indexing, layouts, modes, warps, shuffles, clusters
and control flow where no card is available; the card holds them to the
plain versions' bits (``test_torch_gpu_glue.py``,
``test_torch_gpu_batch_bits.py``, ``chip_smoke.py``).  G2, G3 and G4 are
held to the plain versions bit for bit here too.  Where the CPU's torch
computes an elementary function otherwise than the kernel's library --
its float32 sqrt is not correctly rounded, its sin and cos are not the C
library's -- the plain version is given the kernel's own functions for
that call (correctly rounded sqrt; the C library's sinf / cosf, the
ones the emulated kernel calls), so what is compared is the order of
every other operation.  G1 is held at a tolerance: the CPU's torch
divides a tensor by a Python number where the card (and the kernel)
multiplies by its reciprocal, and its eigenvector's acos and cos are not
the C library's; its normals parallel to 1e-5 for 99% of the queries,
K3's operands the same thresholds, radii within 1e-6 relative and n.q
within 1e-4 (it follows the normal).  Needs a host C++20 compiler
(``g++``).
"""

import contextlib
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
from se3_icp_tpu_torch.ops import cuda_prep, cuda_step
from se3_icp_tpu_torch.parallel import pairs
from se3_icp_tpu_torch.utils.config import GOLDEN, parse_algorithm

torch.set_num_threads(1)

# kernel<<<grid, threads, smem, stream>>>(args);
_LAUNCH = re.compile(
    r"(\w+(?:<[^<>;]*>)?)<<<([^,]+),\s*([^,]+),\s*([^,]+),[^>]*>>>"
    r"\((.*?)\);", re.S)
# extern __shared__ [__align__(n)] type name[];  (a block's dynamic
# shared memory)
_DYN_SMEM = re.compile(
    r"extern __shared__ (?:__align__\(\d+\)\s+)?(\w+)\s+(\w+)\[\];")


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs a host C++20 compiler (g++) to emulate the "
                    "kernels")
    out = tmp_path_factory.mktemp("emulated_glue")
    here = _build.CSRC.parent.parent / "tests"
    shutil.copy(here / "cuda_emulation.h", out / "cuda_runtime.h")
    (out / "cooperative_groups.h").write_text(
        '#pragma once\n#include "cuda_runtime.h"\n')
    for h in _build.headers():
        shutil.copy(h, out / h.name)
    srcs = []
    for name in ("frames.cu", "step_update.cu", "prep.cu"):
        text, n = _LAUNCH.subn(
            lambda m: (f"emu_launch({m.group(2)}, {m.group(3)}, "
                       f"{m.group(4)}, [&] {{ {m.group(1)}({m.group(5)}); "
                       "});"),
            (_build.CSRC / name).read_text())
        text = _DYN_SMEM.sub(
            lambda m: (f"{m.group(1)}* {m.group(2)} = "
                       f"reinterpret_cast<{m.group(1)}*>(emu_dyn_smem());"),
            text)
        assert (n > 0 or "cudaLaunchKernelEx" in text) and "<<<" not in \
            text and "extern __shared__" not in text, name
        srcs.append(out / f"{name}.cpp")
        srcs[-1].write_text(text)
    # the C library's sinf / cosf, as the emulated kernels call them
    (out / "libm_f.cpp").write_text(
        '#include <cmath>\nextern "C" void emu_sincos(const float* x, '
        'float* s, float* c, int n) {\n  for (int i = 0; i < n; ++i) '
        '{ s[i] = sinf(x[i]); c[i] = cosf(x[i]); }\n}\n')
    srcs.append(out / "libm_f.cpp")
    so = out / "libglue.so"
    subprocess.run([cxx, "-std=c++20", "-O2", "-ffp-contract=off",
                    "-pthread", "-shared", "-fPIC", "-I", str(out),
                    *map(str, srcs), "-o", str(so)],
                   check=True, capture_output=True, text=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    for name in ("se3icp_frame_inputs", "se3icp_frame_assembly",
                 "se3icp_step_update", "se3icp_prep"):
        fn = getattr(lib, name)
        fn.argtypes = _build.SIGNATURES[name]
        fn.restype = ctypes.c_int
    lib.emu_sincos.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int]
    lib.emu_sincos.restype = None
    return lib


def _p(x):
    return None if x is None else x.data_ptr()


@contextlib.contextmanager
def _kernel_functions(lib):
    """Within the block torch's sqrt, sin and cos are the ones the
    emulated kernels call: float32 square roots correctly rounded
    (``__fsqrt_rn`` here is ``std::sqrt``) and the C library's sinf and
    cosf; float64 goes to torch's own."""
    sqrt, sin, cos = torch.sqrt, torch.sin, torch.cos

    def libm(x, which):
        x = x.contiguous()
        if x.dtype != torch.float32:
            return (sin, cos)[which](x)
        out = (torch.empty_like(x), torch.empty_like(x))
        lib.emu_sincos(_p(x), _p(out[0]), _p(out[1]), x.numel())
        return out[which]
    torch.sqrt = lambda x: (sqrt(x.double()).float()
                            if x.dtype == torch.float32 else sqrt(x))
    torch.sin = lambda x: libm(x, 0)
    torch.cos = lambda x: libm(x, 1)
    try:
        yield
    finally:
        torch.sqrt, torch.sin, torch.cos = sqrt, sin, cos


def _differ(got, want) -> int:
    """Entries whose bits differ, NaN against NaN counted equal."""
    differ = got != want
    if got.is_floating_point():
        differ &= ~(torch.isnan(got) & torch.isnan(want))
    return int(differ.sum())


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
    with _kernel_functions(lib):
        ref_t, ref_frames = cuda_frames.frame_assembly_plain(
            raw, pts, out[0], w, out[2])
    assert _differ(out_t, ref_t) == 0
    assert _differ(frames, ref_frames) == 0
    assert torch.equal(frames, out_t[:, :9].mT)
    assert torch.equal(out_t[:, 9:], out[2])
    # a row slice, its points and frames runs starting mid-block
    r0, nq = 77, 300
    sl = slice(r0, r0 + nq)
    part_t = torch.full((bsz, 9, nq), float("nan"))
    part = torch.full((bsz, nq, 9), float("nan"))
    raw_s, nrm_s, w_s = (x[..., sl].contiguous() for x in (raw, out[0], w))
    code = lib.se3icp_frame_assembly(
        _p(raw_s), _p(pts), _p(nrm_s), _p(w_s), None, _p(part_t), _p(part),
        bsz, n, nq, r0, None)
    assert code == 0
    assert _differ(part_t, ref_t[:, :9, sl]) == 0
    assert _differ(part, ref_frames[:, sl]) == 0
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
            with _kernel_functions(lib):
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
                assert _differ(got[k], want[k]) == 0, (step, k)
            if step == 4:          # the identity step leaves T as it was
                assert torch.equal(got["T"][0], state["T"][0])
            s = reg.LoopState(**{k: want[k] for k in keys})
    assert bool(s.it.min() >= 4)


def _prep(lib, src, n_src, tgt, n_tgt, scale, cluster):
    """G4's results on the emulated card, each output filled with 7.0
    first."""
    bsz, ns, nt = src.shape[0], src.shape[1], tgt.shape[1]
    got = (torch.full_like(src, 7.0), torch.full_like(tgt, 7.0),
           torch.full((bsz, 3), 7.0), torch.full((bsz, 3), 7.0),
           torch.full((bsz,), 7.0))
    code = lib.se3icp_prep(_p(src), _p(n_src), _p(tgt), _p(n_tgt),
                           _p(scale), *map(_p, got), bsz, ns, nt, cluster,
                           None)
    return code, got


@pytest.mark.parametrize("cluster", [1, 2, 4])
def test_center_scale_kernel_gives_its_plain_version_bits(lib, cluster):
    """G4 on three pairs of other widths (768 and 600: one not a multiple
    of the 256 lanes) and counts (a full cloud, a single row, none), the
    padded rows NaN, a cloud on C = 1, 2 and 4 blocks: the plain
    version's bits, and rows past a count are never read."""
    rng = np.random.default_rng(15)
    bsz, ns, nt = 3, 768, 600
    src = torch.from_numpy((rng.normal(size=(bsz, ns, 3)) * [2.0, 0.5, 1.0]
                            + [3.0, -1.0, 0.5]).astype(np.float32))
    tgt = torch.from_numpy((rng.normal(size=(bsz, nt, 3)) * [1.0, 1.5, 0.7]
                            - [0.5, 2.0, 1.0]).astype(np.float32))
    n_src = torch.tensor([700, 257, 768], dtype=torch.int32)
    n_tgt = torch.tensor([600, 1, 0], dtype=torch.int32)
    for x, nv in ((src, n_src), (tgt, n_tgt)):
        x[torch.arange(x.shape[1])[None] >= nv[:, None]] = float("nan")
    scale = torch.tensor(3.0)
    with _kernel_functions(lib):
        want = cuda_prep.center_scale_plain(src, n_src, tgt, n_tgt, scale)
    code, got = _prep(lib, src, n_src, tgt, n_tgt, scale, cluster)
    assert code == 0
    for name, a, b in zip(("src_c", "tgt_c", "cen_s", "cen_t", "scaling"),
                          got, want):
        assert _differ(a, b) == 0, name
    assert bool(torch.isfinite(got[0]).all() & torch.isfinite(got[1]).all())
    assert float(got[3][2].abs().max()) == 0.0     # no row: centroid 0
    if cluster == 1:     # cluster sizes the kernel does not take
        for bad in (3, 16):
            assert _prep(lib, src, n_src, tgt, n_tgt, scale, bad)[0] != 0


def test_center_scale_kernel_stages_a_cloud_over_several_tiles(lib):
    """G4 on one pair of 3500 and 1000 valid rows: at C = 1 a block stages
    the source's 14 slabs of 256 rows in two tiles, at C = 2 in one;
    both the plain version's bits."""
    rng = np.random.default_rng(16)
    src = torch.from_numpy((rng.normal(size=(1, 3500, 3)) * 3.0
                            + 5.0).astype(np.float32))
    tgt = torch.from_numpy(rng.normal(size=(1, 1100, 3)).astype(np.float32))
    n_src = torch.tensor([3500], dtype=torch.int32)
    n_tgt = torch.tensor([1000], dtype=torch.int32)
    scale = torch.tensor(2.0)
    with _kernel_functions(lib):
        want = cuda_prep.center_scale_plain(src, n_src, tgt, n_tgt, scale)
    for cluster in (1, 2):
        code, got = _prep(lib, src, n_src, tgt, n_tgt, scale, cluster)
        assert code == 0
        for name, a, b in zip(("src_c", "tgt_c", "cen_s", "cen_t",
                               "scaling"), got, want):
            assert _differ(a, b) == 0, (name, cluster)
