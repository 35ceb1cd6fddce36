"""The setup kernels' CUDA sources -- K1 (``csrc/thresholds.cu``), K2
and K3 (``csrc/moments.cu``) --, the loop's match K4
(``csrc/match_affine.cu``) and the 1-NN kernels K6-K9
(``csrc/nn_argmin.cu``) compiled for the CPU against an emulation of the
CUDA built-ins (``tests/cuda_emulation.h``: one OS thread per CUDA
thread, barriers for ``__syncthreads`` and the warp shuffles, the
cp.async pipeline as plain copies) and called through the wrappers' own
C signatures, on the wrappers' own prepared inputs, against the plain
PyTorch versions.

This checks the kernels' indexing, tiling, bounds, warp reductions and
arithmetic order where no card is available; what only the card can
show (that nvcc accepts the source for sm_90a, registers, launch limits,
time) is ``chip_smoke.py``'s and ``test_torch_gpu_kernels.py``'s.  The
tolerances are the card's: K1 bit-equal, K2 ball counts equal and sums
within 1e-5 of each row's largest entry, K3 within 1e-4; K4 d2 within
1e-4 (the plain version's q = feat @ W is a matrix product), at most 1%
of rows matched elsewhere, tied rows averaged, its R3-phase chain
bit-equal to its 12-FMA chain on the same targets; K6-K9 d2
within 1e-5 of |q|^2 + max |t|^2 (an FMA chain here, a matrix product in
the plain version), indices equal except between targets within that of
each other (at most 1% of rows), matched rows copies of the indexed
payload rows.  Needs a host C++20 compiler (``g++``).
"""

import copy
import ctypes
import pathlib
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

import torch_kernel_cases as kcases
import torch_port_cases as cases
from se3_icp_tpu_torch.datasets import fixtures
from se3_icp_tpu_torch.ops import _build, cuda_knn, cuda_nn, lrf
from se3_icp_tpu_torch.ops import cuda_moments as cm

# the suite runs several worker processes side by side: keep each
# one's torch thread pool small
torch.set_num_threads(1)

HERE = pathlib.Path(__file__).resolve().parent
# kernel<<<grid, threads, smem, stream>>>(args);
_LAUNCH = re.compile(
    r"(\w+(?:<[^<>;]*>)?)<<<([^,]+),\s*([^,]+),[^>]*>>>\((.*?)\);", re.S)


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs a host C++20 compiler (g++) to emulate the "
                    "kernels")
    out = tmp_path_factory.mktemp("emulated_kernels")
    shutil.copy(HERE / "cuda_emulation.h", out / "cuda_runtime.h")
    (out / "cuda_pipeline_primitives.h").write_text(
        '#pragma once\n#include "cuda_runtime.h"\n')
    for h in _build.headers():
        shutil.copy(h, out / h.name)
    srcs = []
    for name in ("thresholds.cu", "moments.cu", "nn_argmin.cu",
                 "match_affine.cu"):
        text, n = _LAUNCH.subn(
            lambda m: (f"emu_launch({m.group(2)}, {m.group(3)}, "
                       f"[&] {{ {m.group(1)}({m.group(4)}); }});"),
            (_build.CSRC / name).read_text())
        assert n > 0 and "<<<" not in text, name
        srcs.append(out / f"{name}.cpp")
        srcs[-1].write_text(text)
    so = out / "libemulated.so"
    subprocess.run([cxx, "-std=c++20", "-O2", "-ffp-contract=off",
                    "-pthread", "-shared", "-fPIC", "-I", str(out),
                    *map(str, srcs), "-o", str(so)],
                   check=True, capture_output=True, text=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    for name in ("se3icp_thresholds", "se3icp_moments", "se3icp_axis",
                 "se3icp_nn_argmin", "se3icp_nn_match",
                 "se3icp_nn_match_packed", "se3icp_match_affine"):
        getattr(lib, name).argtypes = _build.SIGNATURES[name]
        getattr(lib, name).restype = ctypes.c_int
    return lib


def _surface_clouds():
    """Two centred "bumpy" clouds padded to 1024 (two K1 target tiles),
    700 and 555 valid rows."""
    pts = np.zeros((2, 1024, 3), np.float32)
    for b, (seed, n) in enumerate(((1, 700), (2, 555))):
        src = fixtures.golden_shape_problem(seed=seed, n=n).source
        pts[b, :n] = (src - src.mean(0)) / np.abs(src).max()
    return torch.as_tensor(pts), torch.tensor([700, 555], dtype=torch.int32)


def _gaussian_clouds():
    """Width 600 (no multiple of 512), the first cloud fully valid."""
    pts, nv = cases.normal_clouds(4, 600, (600, 333))
    return torch.as_tensor(pts), torch.as_tensor(nv)


def _k1(lib, points, nv, counts):
    cloud, cc, hib, order = cm._threshold_inputs(points, nv, counts, None)
    bsz, _, n = cloud.pts_t.shape
    out = torch.full((bsz, cc.shape[1], n), float("nan"))
    assert lib.se3icp_thresholds(
        cloud.pts_t.data_ptr(), cloud.tn.data_ptr(), cloud.n.data_ptr(),
        cc.data_ptr(), hib.data_ptr(), out.data_ptr(), bsz, n, cc.shape[1],
        None) == 0
    return cm._unpermute(out, order)


def _row_rel_err(got, ref, nv):
    col = torch.arange(got.shape[-1])
    valid = (col[None, :] < nv[:, None])[:, None, :]
    diff = torch.where(valid, (got - ref).abs(), 0.0).amax(-1)
    scale = torch.where(valid, ref.abs(), 0.0).amax(-1).clamp_min(1e-30)
    return float((diff / scale).max())


@pytest.mark.parametrize("clouds,counts", [
    (_surface_clouds, (90, 31, 30)),
    (_surface_clouds, (30, 90, 20, 31)),
    (_gaussian_clouds, (20,)),
    # width 600, not a multiple of the 32 queries a block; n_valid 1, 511
    # and 513: one point, one short of a 512-target tile, one past it
    (kcases.threshold_edge_clouds, (20,)),
    (kcases.threshold_edge_clouds, (90, 31, 30, 20)),
], ids=["surface-T3", "surface-T4-unsorted", "gaussian-T1", "edges-T1",
        "edges-T4"])
def test_emulated_thresholds_kernel_is_bit_equal_to_plain(emulated, clouds,
                                                          counts):
    points, nv = clouds()
    cc = torch.tensor([counts] * points.shape[0])
    got = _k1(emulated, points, nv, cc)
    assert not got.isnan().any()           # every row written
    want = cm.neighborhood_thresholds_plain(points, nv, cc)
    assert int((got != want).sum()) == 0


def _k2(lib, cloud, thr_s):
    """The emulated K2 on thr_s [B,M,N] (M = 1 or 3) -> raw [B,10 M,N]."""
    bsz, balls, n = thr_s.shape
    raw = torch.full((bsz, 10 * balls, n), float("nan"))
    assert lib.se3icp_moments(
        cloud.pts_t.data_ptr(), cloud.tn.data_ptr(), cloud.n.data_ptr(),
        cloud.order.data_ptr(), thr_s.data_ptr(), raw.data_ptr(), bsz, n,
        balls, None) == 0
    return raw


def _k3(lib, cloud, nrm, aux):
    bsz, _, n = nrm.shape
    out = torch.full((bsz, 4, n), float("nan"))
    assert lib.se3icp_axis(
        cloud.pts_t.data_ptr(), cloud.tn.data_ptr(), cloud.n.data_ptr(),
        cloud.order.data_ptr(), nrm.data_ptr(), aux.data_ptr(),
        out.data_ptr(), bsz, n, None) == 0
    return out


def _setup_inputs(points, nv):
    """The main path's K2 and K3 inputs on a cloud: thresholds of the
    counts (90, 31, 30) from K1's plain version, K2's shifted thresholds
    (balls 30, 31, 90), and K3's normals and aux rows from K2's plain
    sums."""
    thr = cm.neighborhood_thresholds_plain(
        points, nv, torch.tensor([[90, 31, 30]] * points.shape[0]))
    cloud, thr_s = cm._moments_inputs(
        points, nv, (thr[:, 2], thr[:, 1], thr[:, 0]), None)
    mom = cm._moments_dict(cm._moments_raw_plain(cloud, thr_s), points)
    normal_t, ndotq, radius = lrf.toldi_axis_inputs(mom, thr[:, 0], 30)
    _, nrm, aux = cm._axis_inputs(points, nv, normal_t, ndotq, radius,
                                  thr[:, 0], cloud)
    return cloud, thr_s, nrm, aux


def _ragged_clouds():
    """Width 300 (no multiple of a tile or a block), n_valid 1, 255 and
    300.  Padded rows are copies of valid ones, nearer to their queries
    than any valid row: a kernel that reads them sums them."""
    pts = np.zeros((3, 300, 3), np.float32)
    nv = (1, 255, 300)
    for b, n in enumerate(nv):
        src = fixtures.golden_shape_problem(seed=b + 3, n=300).source
        pts[b] = (src - src.mean(0)) / np.abs(src).max()
        pts[b, n:] = pts[b, :300 - n] + 1e-4
    return torch.as_tensor(pts), torch.tensor(nv, dtype=torch.int32)


@pytest.mark.parametrize("clouds", [_surface_clouds, _gaussian_clouds],
                         ids=["surface", "gaussian"])
def test_emulated_moments_and_axis_kernels_match_plain(emulated, clouds):
    points, nv = clouds()
    cloud, thr_s, nrm, aux = _setup_inputs(points, nv)
    raw = _k2(emulated, cloud, thr_s)
    raw_p = cm._moments_raw_plain(cloud, thr_s)
    counts = [9, 19, 29]                   # the three balls' member counts
    assert torch.equal(raw[:, counts], raw_p[:, counts])
    assert _row_rel_err(raw, raw_p, nv) <= 1e-5
    out = _k3(emulated, cloud, nrm, aux)
    assert _row_rel_err(out, cm._axis_raw_plain(cloud, nrm, aux), nv) <= 1e-4


def test_emulated_moments_kernel_sums_members_in_target_order(emulated):
    """Every query row, padded ones too: each ball's ten sums are the
    float32 sums of its members' feature rows taken one after another in
    target-index order, bit for bit."""
    points, nv = _ragged_clouds()
    cloud, thr_s, _, _ = _setup_inputs(points, nv)
    raw = _k2(emulated, cloud, thr_s).view(3, 3, 10, 300).numpy()
    r = cm._shifted_d2(cloud, 0, 300).numpy()                # [B,N,N]
    for b, n in enumerate(nv.tolist()):
        x, y, z = cloud.pts_t[b, :, :n].numpy()
        feat = np.stack([x, y, z, x * x, x * y, x * z, y * y, y * z, z * z,
                         np.ones_like(x)], -1)               # [n,10] f32
        for m in range(3):
            member = r[b, :, :n] <= thr_s[b, m, :, None].numpy()
            rows = np.where(member[..., None], feat[None], np.float32(0))
            want = np.cumsum(rows, axis=1, dtype=np.float32)[:, -1]
            assert np.array_equal(raw[b, m].T, want), (b, m)


def test_emulated_moments_and_axis_kernels_ignore_the_query_order(emulated):
    """The same bits under the identity order, the Z-order of
    ``setup_cloud`` and a seeded random permutation."""
    points, nv = _ragged_clouds()
    cloud, thr_s, nrm, aux = _setup_inputs(points, nv)
    bsz, _, n = cloud.pts_t.shape
    gen = torch.Generator().manual_seed(0)
    orders = [torch.arange(n, dtype=torch.int32).expand(bsz, n).contiguous(),
              torch.stack([torch.randperm(n, generator=gen)
                           for _ in range(bsz)]).to(torch.int32)]
    assert not torch.equal(cloud.order, orders[0])
    raw, out = _k2(emulated, cloud, thr_s), _k3(emulated, cloud, nrm, aux)
    for order in orders:
        other = copy.copy(cloud)
        other.order = order
        assert torch.equal(_k2(emulated, other, thr_s), raw)
        assert torch.equal(_k3(emulated, other, nrm, aux), out)


def test_emulated_moments_and_axis_kernels_skip_entries_that_are_no_row(
        emulated):
    """An order entry outside [0, N) is skipped: nothing is read or
    written for it, the rows it displaced keep what the output held, and
    every other row gets its bits."""
    points, nv = _ragged_clouds()
    cloud, thr_s, nrm, aux = _setup_inputs(points, nv)
    raw, out = _k2(emulated, cloud, thr_s), _k3(emulated, cloud, nrm, aux)
    bad = copy.copy(cloud)
    bad.order = cloud.order.clone()
    n = bad.order.shape[1]
    pos = torch.tensor([0, 7, 150, n - 1])
    dropped = bad.order[:, pos].long()
    bad.order[:, pos] = torch.tensor([n, -1, 2**31 - 1, -2**31],
                                     dtype=torch.int32)
    for got, want in ((_k2(emulated, bad, thr_s), raw),
                      (_k3(emulated, bad, nrm, aux), out)):
        for b in range(got.shape[0]):
            kept = torch.ones(n, dtype=torch.bool)
            kept[dropped[b]] = False
            assert bool(got[b][:, ~kept].isnan().all())
            assert torch.equal(got[b][:, kept], want[b][:, kept])


def test_emulated_one_ball_moments_equal_the_three_ball_block(emulated):
    """K2's one-ball instance equals the three-ball kernel's block of
    that ball; ``moments_one_ball``'s dict (plain version here) is the
    dict of one threshold passed three times."""
    points, nv = _ragged_clouds()
    cloud, thr_s, _, _ = _setup_inputs(points, nv)
    raw3 = _k2(emulated, cloud, thr_s)
    for m in range(3):
        one = thr_s[:, m:m + 1].contiguous()
        assert torch.equal(_k2(emulated, cloud, one),
                           raw3[:, 10 * m:10 * m + 10])
    thr = thr_s[:, 1] + cloud.tn
    got = cm.moments_one_ball(points, nv, thr, cloud=cloud)
    want = cm.moments_plain(points, nv, thr, thr, thr, cloud=cloud)
    assert got.keys() == want.keys()
    for key in want:
        assert torch.equal(got[key], want[key]), key


def test_setup_cloud_query_order_is_a_permutation_valid_rows_first():
    """K2's and K3's query order: a permutation of each row, the valid
    rows first, then the padded ones in index order; the valid rows in a
    spatial order (consecutive queries lie near each other, where the
    fixture's index order is random)."""
    points, nv = _ragged_clouds()
    order = cm.setup_cloud(points, nv).order
    assert order.dtype == torch.int32 and order.shape == (3, 300)
    for b, n in enumerate(nv.tolist()):
        row = order[b].tolist()
        assert sorted(row) == list(range(300))
        assert sorted(row[:n]) == list(range(n))
        assert row[n:] == list(range(n, 300))
        if n > 1:
            step = lambda idx: float(
                (points[b, idx[1:]] - points[b, idx[:-1]]).norm(dim=1)
                .mean())
            assert step(row[:n]) < 0.5 * step(list(range(n)))


# ------------------------------------------------------------ K6-K9

def _nn_hold(q, t, n, idx, d2, idx_p, d2_p):
    assert not d2.isnan().any()                # every row written
    col = torch.arange(t.shape[1])
    tn = torch.where(col[None] < n[:, None], (t * t).sum(-1), 0.0)
    scale = (q * q).sum(-1) + tn.amax(-1, keepdim=True) + 1.0
    assert float(((d2 - d2_p).abs() / scale).max()) <= 1e-5
    assert bool((idx < n[:, None]).all())
    differ = idx != idx_p
    assert float(differ.float().mean()) <= 0.01
    b, i = differ.nonzero(as_tuple=True)
    qd = q[b, i].double()
    dk = ((qd - t[b, idx[b, i].long()].double()) ** 2).sum(-1)
    dp = ((qd - t[b, idx_p[b, i].long()].double()) ** 2).sum(-1)
    assert bool(((dk - dp).abs() <= 2e-5 * scale[b, i].double()).all())


def _nn_inputs(d, seed):
    """Two clouds of 300 queries against 333 targets (three tiles of
    128, the last ragged), 333 and 200 of them valid."""
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(2, 300, d, generator=g)
    t = torch.randn(2, 333, d, generator=g)
    t[0, 5] = t[0, 4]                          # an exact tie: lowest index
    return q, t, torch.tensor([333, 200], dtype=torch.int32)


@pytest.mark.parametrize("d", cuda_nn.WIDTHS)
def test_emulated_nn_kernels_match_plain(emulated, d):
    q, t, n = _nn_inputs(d, d)
    bsz, nq, nt = 2, 300, 333
    idx = torch.full((bsz, nq), -1, dtype=torch.int32)
    d2 = torch.full((bsz, nq), float("nan"))
    assert emulated.se3icp_nn_argmin(q.data_ptr(), t.data_ptr(),
                                     n.data_ptr(), idx.data_ptr(),
                                     d2.data_ptr(), bsz, nq, nt, d,
                                     None) == 0
    _nn_hold(q, t, n, idx, d2, *cuda_nn.nn_argmin_batched_plain(q, t, n))
    pay = torch.randn(bsz, nt, 5)
    m = torch.full((bsz, nq, 5), float("nan"))
    assert emulated.se3icp_nn_match(q.data_ptr(), t.data_ptr(),
                                    pay.data_ptr(), n.data_ptr(),
                                    idx.data_ptr(), d2.data_ptr(),
                                    m.data_ptr(), bsz, nq, nt, d, 5,
                                    None) == 0
    assert torch.equal(m, cuda_nn._gather_rows(pay, idx))
    # a width the kernel is not built for is refused, not run
    assert emulated.se3icp_nn_argmin(q.data_ptr(), t.data_ptr(),
                                     n.data_ptr(), idx.data_ptr(),
                                     d2.data_ptr(), bsz, nq, nt, 5,
                                     None) != 0


def test_emulated_packed_match_kernel_matches_plain(emulated):
    q, t_a, n = _nn_inputs(12, 1)
    t_b = t_a.clone()
    t_b[..., :9] = 0.0
    pay = torch.randn(2, 333, 9)
    targets = cuda_knn.pack_match_targets(t_a, t_b, pay, n)
    phase = torch.tensor([1, 0], dtype=torch.int32)
    idx = torch.full((2, 300), -1, dtype=torch.int32)
    d2 = torch.full((2, 300), float("nan"))
    m = torch.full((2, 300, 9), float("nan"))
    assert emulated.se3icp_nn_match_packed(
        q.data_ptr(), targets.emb.data_ptr(), targets.tn.data_ptr(),
        targets.payload.data_ptr(), targets.n.data_ptr(), phase.data_ptr(),
        idx.data_ptr(), d2.data_ptr(), m.data_ptr(), 2, 300, 333, 9,
        None) == 0
    idx_p, d2_p, _ = cuda_nn.nn_match_packed_plain(q, targets, phase)
    _nn_hold(q, torch.stack([t_b[0], t_a[1]]), n, idx, d2, idx_p, d2_p)
    assert torch.equal(m, cuda_nn._gather_rows(pay, idx))


# --------------------------------------------------------------- K4

def _k4(lib, feat, w, targets, phase):
    bsz, nq, _ = feat.shape
    nt, p = targets.payload.shape[1:]
    d2 = torch.full((bsz, nq), float("nan"))
    mt = torch.full((bsz, p, nq), float("nan"))
    assert lib.se3icp_match_affine(
        feat.data_ptr(), w.data_ptr(), targets.emb.data_ptr(),
        targets.tn.data_ptr(), targets.payload.data_ptr(),
        targets.n.data_ptr(), phase.data_ptr(), d2.data_ptr(),
        mt.data_ptr(), bsz, nq, nt, p, None) == 0
    return d2, mt


@pytest.mark.parametrize("n_tgt", [(333, 77, 300), (128, 300, 200)],
                         ids=["ragged-tiles", "whole-tile"])
def test_emulated_match_kernel_matches_plain(emulated, n_tgt):
    """300 queries (not a multiple of the 256 a block) against 360 target
    rows: 333 valid (ragged last tile), 77 (less than one tile of 128),
    128 (one whole tile); SE(3)-phase, R3-phase and done pairs in one
    batch; exact ties of two and three duplicated rows; the rows past
    n_tgt never matched."""
    feat, w, targets, phase, same = kcases.match_edge_case(300, 360, n_tgt)
    d2, mt = _k4(emulated, feat, w, targets, phase)
    d2_p, mt_p = cuda_knn.nn_match_affine_plain(feat, w, targets, phase)
    kcases.hold_match(d2, mt, d2_p, mt_p, targets)
    # the done pair returned at once: its outputs were not written
    assert bool(d2[2].isnan().all() and mt[2].isnan().all())
    # the R3 pair's 3-FMA chain gives the bits of the 12-FMA chain that
    # the SE(3) path runs on the same (zero-rotation) targets
    d2_s, mt_s = _k4(emulated, feat, w, same, torch.zeros_like(phase))
    assert torch.equal(d2_s[1], d2[1]) and torch.equal(mt_s[1], mt[1])


def test_emulated_match_kernel_finds_a_tie_across_tiles(emulated):
    """Every query one point, three targets exactly there in two tiles:
    the mean of the three rows, the same as the plain version's."""
    feat, w, targets, phase = kcases.match_tie_case()
    _, mt = _k4(emulated, feat, w, targets, phase)
    _, mt_p = cuda_knn.nn_match_affine_plain(feat, w, targets, phase)
    want = targets.payload[:, [3, 4, 200]].mean(1)            # [2,P]
    torch.testing.assert_close(mt, want[..., None].expand_as(mt),
                               rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(mt, mt_p, rtol=1e-6, atol=1e-6)
