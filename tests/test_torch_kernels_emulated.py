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
payload rows, and the tiled K6/K7 bit-equal to the untiled search.
K1-K3's row-slice instances (the points route's: rows [r0, r1) of a
cloud against the whole cloud), concatenated over R = 1, 2, 3, 4 slices,
a slice of padding rows only among them, are bit-equal to the whole call
and each to its plain version's slice (K1 bits, K2 counts).
Needs a host C++20 compiler (``g++``).
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
from se3_icp_tpu_torch.ops import _build, cuda_knn, cuda_loop, cuda_nn, lrf
from se3_icp_tpu_torch.ops import trim
from se3_icp_tpu_torch.ops import cuda_moments as cm

# the suite runs several worker processes side by side: keep each
# one's torch thread pool small
torch.set_num_threads(1)

HERE = pathlib.Path(__file__).resolve().parent
# kernel<<<grid, threads, smem, stream>>>(args);
_LAUNCH = re.compile(
    r"(\w+(?:<[^<>;]*>)?)<<<([^,]+),\s*([^,]+),\s*([^,]+),[^>]*>>>"
    r"\((.*?)\);", re.S)
# extern __shared__ [__align__(n)] type name[];  (a block's dynamic
# shared memory)
_DYN_SMEM = re.compile(
    r"extern __shared__ (?:__align__\(\d+\)\s+)?(\w+)\s+(\w+)\[\];")


# extern "C" int se3icp_name(params) {  (an exported entry point)
_C_ENTRY = re.compile(r'extern "C" int (se3icp_\w+)\((.*?)\)\s*\{', re.S)


def test_signature_table_matches_the_c_entry_points():
    """Every exported C entry point has its ctypes argument list in
    ``_build.SIGNATURES``, pointer for pointer and int for int, and the
    table names no other: a list one int short would pass garbage as the
    stream, without an error."""
    found = {}
    for src in _build.sources():
        for name, params in _C_ENTRY.findall(src.read_text()):
            kinds = []
            for a in params.split(","):
                assert "*" in a or a.split()[0] == "int", (name, a)
                kinds.append(ctypes.c_void_p if "*" in a else ctypes.c_int)
            found[name] = kinds
    assert found == _build.SIGNATURES


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs a host C++20 compiler (g++) to emulate the "
                    "kernels")
    out = tmp_path_factory.mktemp("emulated_kernels")
    shutil.copy(HERE / "cuda_emulation.h", out / "cuda_runtime.h")
    for h in ("cuda_pipeline_primitives.h", "cooperative_groups.h",
              "math_constants.h"):
        (out / h).write_text('#pragma once\n#include "cuda_runtime.h"\n')
    for h in _build.headers():
        shutil.copy(h, out / h.name)
    srcs = []
    for name in ("thresholds.cu", "moments.cu", "nn_argmin.cu",
                 "match_affine.cu", "loop_epilogue.cu"):
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
    so = out / "libemulated.so"
    subprocess.run([cxx, "-std=c++20", "-O2", "-ffp-contract=off",
                    "-pthread", "-shared", "-fPIC", "-I", str(out),
                    *map(str, srcs), "-o", str(so)],
                   check=True, capture_output=True, text=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    for name in ("se3icp_thresholds", "se3icp_moments", "se3icp_axis",
                 "se3icp_thresholds_rows", "se3icp_moments_rows",
                 "se3icp_axis_rows", "se3icp_nn_argmin", "se3icp_nn_argmin_batched",
                 "se3icp_nn_match_batched", "se3icp_nn_match_packed",
                 "se3icp_nn_match_packed_batched", "se3icp_nn_tiled_smem",
                 "se3icp_match_affine", "se3icp_loop_epilogue"):
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


def _k1_rows(lib, points, nv, counts, rows):
    cloud, cc, hib, order = cm._threshold_inputs(points, nv, counts, None)
    bsz, _, n = cloud.pts_t.shape
    r0, r1 = rows
    out = torch.full((bsz, cc.shape[1], r1 - r0), float("nan"))
    assert lib.se3icp_thresholds_rows(
        cloud.pts_t.data_ptr(), cloud.tn.data_ptr(), cloud.n.data_ptr(),
        cc.data_ptr(), hib.data_ptr(), out.data_ptr(), bsz, n, r0, r1 - r0,
        cc.shape[1], None) == 0
    return cm._unpermute(out, order)


def _k2_rows(lib, cloud, thr_s, rows):
    """The emulated K2 on the rows ``rows``: thr_s [B,M,C] -> [B,10 M,C]."""
    bsz, balls, nq = thr_s.shape
    order = cloud.rows_order(rows)
    raw = torch.full((bsz, 10 * balls, nq), float("nan"))
    assert lib.se3icp_moments_rows(
        cloud.pts_t.data_ptr(), cloud.tn.data_ptr(), cloud.n.data_ptr(),
        order.data_ptr(), thr_s.data_ptr(), raw.data_ptr(), bsz,
        cloud.pts_t.shape[2], rows[0], nq, balls, None) == 0
    return raw


def _k3_rows(lib, cloud, nrm, aux, rows):
    bsz, _, nq = nrm.shape
    order = cloud.rows_order(rows)
    out = torch.full((bsz, 4, nq), float("nan"))
    assert lib.se3icp_axis_rows(
        cloud.pts_t.data_ptr(), cloud.tn.data_ptr(), cloud.n.data_ptr(),
        order.data_ptr(), nrm.data_ptr(), aux.data_ptr(), out.data_ptr(),
        bsz, cloud.pts_t.shape[2], rows[0], nq, None) == 0
    return out


_WHOLE_CALLS: dict = {}


def _whole_call(lib, clouds):
    """(inputs, K1-K3's whole-call results) of ``clouds``, made once."""
    if clouds not in _WHOLE_CALLS:
        points, nv = clouds()
        cloud, thr_s, nrm, aux = _setup_inputs(points, nv)
        cc = torch.tensor([[90, 31, 30]] * points.shape[0])
        _WHOLE_CALLS[clouds] = (
            (points, nv, cc, cloud, thr_s, nrm, aux),
            (_k1(lib, points, nv, cc), _k2(lib, cloud, thr_s),
             _k3(lib, cloud, nrm, aux)))
    return _WHOLE_CALLS[clouds]


@pytest.mark.parametrize("clouds,n_slices", [
    (_ragged_clouds, 1), (_ragged_clouds, 2), (_ragged_clouds, 3),
    (_ragged_clouds, 4), (_surface_clouds, 3), (_surface_clouds, 4)],
    ids=["ragged-1", "ragged-2", "ragged-3", "ragged-4", "surface-3",
         "surface-4"])
def test_emulated_row_slices_give_the_whole_call_bits(emulated, clouds,
                                                      n_slices):
    """K1, K2 and K3 on R contiguous row slices, each against the whole
    cloud: concatenated, the whole call's bits; each slice K1's plain
    bits and K2's plain counts.  The surface clouds' last of 4 slices
    (rows 768-1023, past both n_valid) and the ragged clouds' slices
    past the first pair's one valid row hold padding only."""
    (points, nv, cc, cloud, thr_s, nrm, aux), whole = _whole_call(
        emulated, clouds)
    n = points.shape[1]
    parts = []
    for i in range(n_slices):
        rows = (i * n // n_slices, (i + 1) * n // n_slices)
        sl = slice(*rows)
        thr = _k1_rows(emulated, points, nv, cc, rows)
        assert torch.equal(thr, cm.neighborhood_thresholds_plain(
            points, nv, cc, cloud=cloud, rows=rows))
        raw = _k2_rows(emulated, cloud, thr_s[..., sl].contiguous(), rows)
        raw_p = cm._moments_raw_plain(cloud, thr_s[..., sl], rows[0])
        assert torch.equal(raw[:, [9, 19, 29]], raw_p[:, [9, 19, 29]])
        parts.append((thr, raw, _k3_rows(
            emulated, cloud, nrm[..., sl].contiguous(),
            aux[..., sl].contiguous(), rows)))
    for k, want in enumerate(whole):
        assert torch.equal(torch.cat([p[k] for p in parts], -1), want), k


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


def _nn_untiled(lib, q, t, n, split):
    """The emulated one-query-a-thread search (K9's entry point) at
    ``split`` target slices and q's batch -> (code, idx, d2)."""
    bsz, nq, d = q.shape
    idx = torch.full((bsz, nq), -1, dtype=torch.int32)
    d2 = torch.full((bsz, nq), float("nan"))
    code = lib.se3icp_nn_argmin(q.data_ptr(), t.data_ptr(), n.data_ptr(),
                                idx.data_ptr(), d2.data_ptr(), bsz, nq,
                                t.shape[1], d, split, None)
    return code, idx, d2


def _nn_tiled(lib, q, t, n, pay=None, d=None):
    """The emulated tiled search: K6 -> (code, idx, d2), K7 with ``pay``
    -> (code, idx, d2, matched); ``d`` overrides the width passed."""
    bsz, nq, width = q.shape
    d = width if d is None else d
    nt = t.shape[1]
    idx = torch.full((bsz, nq), -1, dtype=torch.int32)
    d2 = torch.full((bsz, nq), float("nan"))
    if pay is None:
        code = lib.se3icp_nn_argmin_batched(
            q.data_ptr(), t.data_ptr(), n.data_ptr(), idx.data_ptr(),
            d2.data_ptr(), bsz, nq, nt, d, None)
        return code, idx, d2
    m = torch.full((bsz, nq, pay.shape[2]), float("nan"))
    code = lib.se3icp_nn_match_batched(
        q.data_ptr(), t.data_ptr(), pay.data_ptr(), n.data_ptr(),
        idx.data_ptr(), d2.data_ptr(), m.data_ptr(), bsz, nq, nt, d,
        pay.shape[2], None)
    return code, idx, d2, m


@pytest.mark.parametrize("d", cuda_nn.WIDTHS)
def test_emulated_nn_kernels_match_plain(emulated, d):
    q, t, n = _nn_inputs(d, d)
    code, idx, d2 = _nn_tiled(emulated, q, t, n)
    assert code == 0
    _nn_hold(q, t, n, idx, d2, *cuda_nn.nn_argmin_batched_plain(q, t, n))
    pay = torch.randn(2, 333, 5)
    code, idx_m, d2_m, m = _nn_tiled(emulated, q, t, n, pay)
    assert code == 0 and torch.equal(idx_m, idx) and torch.equal(d2_m, d2)
    assert torch.equal(m, cuda_nn._gather_rows(pay, idx))
    # a width the kernels are not built for is refused, not run
    assert _nn_tiled(emulated, q, t, n, d=5)[0] != 0
    assert _nn_tiled(emulated, q, t, n, pay, d=5)[0] != 0
    assert emulated.se3icp_nn_argmin(q.data_ptr(), t.data_ptr(),
                                     n.data_ptr(), idx.data_ptr(),
                                     d2.data_ptr(), 2, 300, 333, 5, 1,
                                     None) != 0


@pytest.mark.parametrize("one_point", [False, True],
                         ids=["planted-ties", "one-point"])
@pytest.mark.parametrize("d", cuda_nn.WIDTHS)
def test_emulated_tiled_search_returns_the_untiled_bits(emulated, d,
                                                        one_point):
    """K6 and K7 (the tiled search) against the one-query-a-thread
    search at S = 1 on the same batch, bit for bit: 300 queries (a
    ragged query tile) against 333 target rows with counts of every row,
    none, 201 and 129 (ragged target tiles and steps), rows past a count
    nearer than any valid one, and exact ties inside a thread's step,
    between two threads of a query, across steps and across tiles (or
    every query one point on a tie of twelve rows); the lowest index of
    each tie; a pair with no valid target gives row 0 and 3.4e38 + |q|^2;
    K7's rows are copies of the payload rows; the plain version's
    results within the kernels' tolerance."""
    q, t, n = kcases.tiled_case(d, one_point)
    code, idx, d2 = _nn_tiled(emulated, q, t, n)
    assert code == 0
    code, idx_u, d2_u = _nn_untiled(emulated, q, t, n, 1)
    assert code == 0
    assert torch.equal(idx, idx_u) and torch.equal(d2, d2_u)
    for (b, i), j in kcases.tiled_answers(one_point).items():
        assert int(idx[b, i]) == j, (b, i)
    qn = torch.zeros(q.shape[:2])
    for k in range(d):                       # the kernel's |q|^2 chain
        qn = torch.addcmul(qn, q[..., k], q[..., k])
    assert bool((idx[1] == 0).all())
    assert torch.equal(d2[1], torch.tensor(3.4e38) + qn[1])
    live = n > 0
    _nn_hold(q[live], t[live], n[live], idx[live], d2[live],
             *cuda_nn.nn_argmin_batched_plain(q[live], t[live], n[live]))
    pay = torch.randn(4, t.shape[1], 9,
                      generator=torch.Generator().manual_seed(d))
    code, idx_m, d2_m, m = _nn_tiled(emulated, q, t, n, pay)
    assert code == 0 and torch.equal(idx_m, idx) and torch.equal(d2_m, d2)
    assert torch.equal(m, cuda_nn._gather_rows(pay, idx))


def _k8(lib, q, targets, phase, split=None):
    """The emulated K8: the tiled search, or with ``split`` the
    one-query-a-thread search at that many target slices -> (code, idx,
    d2, matched)."""
    bsz, nq, _ = q.shape
    nt, p = targets.payload.shape[1:]
    idx = torch.full((bsz, nq), -1, dtype=torch.int32)
    d2 = torch.full((bsz, nq), float("nan"))
    m = torch.full((bsz, nq, p), float("nan"))
    args = (q.data_ptr(), targets.emb.data_ptr(), targets.tn.data_ptr(),
            targets.payload.data_ptr(), targets.n.data_ptr(),
            phase.data_ptr(), idx.data_ptr(), d2.data_ptr(), m.data_ptr(),
            bsz, nq, nt, p)
    if split is None:
        code = lib.se3icp_nn_match_packed_batched(*args, None)
    else:
        code = lib.se3icp_nn_match_packed(*args, split, None)
    return code, idx, d2, m


def _selected(targets, phase):
    """Each pair's phase block of the packed targets [B,Nt,12]."""
    return targets.emb[torch.arange(phase.shape[0]), (phase != 0).long()]


def test_emulated_packed_match_kernel_matches_plain(emulated):
    """K8 (the tiled search on packed targets) against its plain version,
    and the one-query-a-thread search on the packed targets at S = 1 and
    3 with the same bits."""
    q, t_a, n = _nn_inputs(12, 1)
    t_b = t_a.clone()
    t_b[..., :9] = 0.0
    pay = torch.randn(2, 333, 9)
    targets = cuda_knn.pack_match_targets(t_a, t_b, pay, n)
    phase = torch.tensor([1, 0], dtype=torch.int32)
    code, *out = _k8(emulated, q, targets, phase)
    assert code == 0
    idx, d2, m = out
    idx_p, d2_p, _ = cuda_nn.nn_match_packed_plain(q, targets, phase)
    _nn_hold(q, torch.stack([t_b[0], t_a[1]]), n, idx, d2, idx_p, d2_p)
    assert torch.equal(m, cuda_nn._gather_rows(pay, idx))
    for split in (1, 3):
        code, *ref = _k8(emulated, q, targets, phase, split)
        assert code == 0
        assert all(torch.equal(a, b) for a, b in zip(out, ref)), split


@pytest.mark.parametrize("case", ["planted-ties", "one-point", "given-tn"])
def test_emulated_tiled_packed_match_returns_the_untiled_bits(emulated,
                                                              case):
    """K8 (the tiled search on packed targets, a phase block per pair)
    against the one-query-a-thread search at S = 1, bit for bit: the
    tiled case (ragged tiles, counts of every row, none, 201 and 129,
    planted ties or one point) packed with phases 0, 1, 1, 0 and the
    wrong block one row off; the planted answers; the pair with no valid
    target gives row 0 and 3.4e38 + |q|^2; matched rows are copies of the
    payload rows; the plain version within the kernels' tolerance.
    ``given-tn``: a tied row's given |t|^2 one ulp below the other's wins
    the tie -- a search that recomputes |t|^2 in its scan or in its
    epilogue does not return these bits."""
    q, targets, phase, answers = kcases.packed_case(
        one_point=case == "one-point", nudge=case == "given-tn")
    code, *out = _k8(emulated, q, targets, phase)
    assert code == 0
    code, *ref = _k8(emulated, q, targets, phase, split=1)
    assert code == 0
    for (b, i), j in answers.items():
        assert int(ref[0][b, i]) == j, (b, i)      # the reference's answer
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    idx, d2, m = out
    for (b, i), j in answers.items():
        assert int(idx[b, i]) == j, (b, i)
    qn = torch.zeros(q.shape[:2])
    for k in range(q.shape[2]):              # the kernel's |q|^2 chain
        qn = torch.addcmul(qn, q[..., k], q[..., k])
    assert bool((idx[1] == 0).all())
    assert torch.equal(d2[1], torch.tensor(3.4e38) + qn[1])
    assert torch.equal(m, cuda_nn._gather_rows(targets.payload, idx))
    live, n = targets.n > 0, targets.n
    idx_p, d2_p, _ = cuda_nn.nn_match_packed_plain(q, targets, phase)
    _nn_hold(q[live], _selected(targets, phase)[live], n[live], idx[live],
             d2[live], idx_p[live], d2_p[live])


@pytest.mark.parametrize("d", [3, 12])
def test_emulated_split_search_returns_the_unsplit_bits(emulated, d):
    """The targets split into S = 2, 3 and 8 slices of a query tile (a
    cluster of S blocks, merged on rank 0): the bits of S = 1 and the
    plain version's result, with counts past the rows, inside a slice,
    at a slice boundary and of one target, slices with no valid target
    (S = 8 everywhere, S = 3 at one target), and exact ties across a
    slice boundary and inside a count (the lower index wins); the tiled
    K6 and K7 give the same bits."""
    q, t, n = kcases.split_case(d)
    code, idx, d2 = _nn_untiled(emulated, q, t, n, 1)
    assert code == 0
    for split in (2, 3, 8):
        code, idx_s, d2_s = _nn_untiled(emulated, q, t, n, split)
        assert code == 0
        assert torch.equal(idx_s, idx) and torch.equal(d2_s, d2), split
    assert int(idx[0, 0]) == kcases.TIE_LO and int(idx[1, 1]) == 20
    assert bool((idx[3] == 0).all())              # one valid target
    n_eff = n.clamp(max=t.shape[1])
    _nn_hold(q, t, n_eff, idx, d2,
             *cuda_nn.nn_argmin_batched_plain(q, t, n_eff))
    pay = torch.randn(4, t.shape[1], 5,
                      generator=torch.Generator().manual_seed(d))
    code, idx_m, d2_m, m = _nn_tiled(emulated, q, t, n, pay)
    assert code == 0 and torch.equal(idx_m, idx) and torch.equal(d2_m, d2)
    assert torch.equal(m, cuda_nn._gather_rows(pay, idx))
    code, idx_t, d2_t = _nn_tiled(emulated, q, t, n)
    assert code == 0 and torch.equal(idx_t, idx) and torch.equal(d2_t, d2)
    # slice counts the kernel does not take are refused, not run
    for split in (0, 9):
        assert _nn_untiled(emulated, q, t, n, split)[0] != 0


# --------------------------------------------------------------- K5

def _k5(lib, srcT, mt, pf, cov6, conf, kw, cluster):
    bsz, _, n = srcT.shape
    A = torch.full((bsz, 6, 6), float("nan"))
    b = torch.full((bsz, 8), float("nan"))
    st = torch.full((bsz, 8), float("nan"))
    code = lib.se3icp_loop_epilogue(
        srcT.data_ptr(), mt.data_ptr(), pf.data_ptr(),
        None if cov6 is None else cov6.data_ptr(),
        None if conf is None else conf.data_ptr(), A.data_ptr(),
        b.data_ptr(), st.data_ptr(), bsz, n, mt.shape[1],
        cuda_loop._VARIANT_CODE[kw["variant"]], int(kw["is_se3"]),
        int(kw["use_cf"]), int(kw["do_trim"]), kw["off_tr"], kw["off_nrm"],
        kw["off_cov"], kw["off_conf"], cuda_loop.index_steps(n), cluster,
        None)
    return code, (A, b, st)


@pytest.mark.parametrize("variant,is_se3,use_cf,overlap,ties", [
    ("pt2pl", True, False, 1.0, False),
    ("pt2pl", True, False, 0.75, False),
    ("pt2pt", True, False, 0.6, True),
    ("pt2pl", False, False, 0.6, True),
    ("gicp", True, True, 0.75, False),
], ids=["pt2pl", "pt2pl-trim", "pt2pt-trim-ties", "icp-pt2pl-trim-ties",
        "gicp-cf-trim"])
def test_emulated_epilogue_kernel_matches_plain_on_every_cluster(
        emulated, variant, is_se3, use_cf, overlap, ties):
    """K5 as a cluster of C = 1, 2 and 4 blocks a pair: the same bits
    for every C, and the plain version's kept count exactly, A, b and the
    MSE within K5's tolerances.  With ``ties`` the trim keys take a few
    values many times each and the keep count falls inside a run of
    equal keys: a kept set other than the lowest indices of the boundary
    band moves the pt2pt means in b and the pt2pl sums in A."""
    case = kcases.epilogue_case(variant, is_se3, use_cf, overlap,
                                ties=ties)
    want = cuda_loop.loop_epilogue_plain(*case[:5], **case[5])
    code, ref = _k5(emulated, *case, 1)
    assert code == 0
    kcases.hold_epilogue(ref, want, variant)
    for cluster in (2, 4):
        code, got = _k5(emulated, *case, cluster)
        assert code == 0
        assert all(torch.equal(a, b) for a, b in zip(got, ref)), cluster
    assert _k5(emulated, *case, 3)[0] != 0        # no such cluster size


@pytest.mark.parametrize("variant,is_se3,overlap,ties", [
    ("pt2pl", True, 0.75, False),
    ("pt2pt", True, 0.6, True),
    ("pt2pl", False, 0.6, True),
], ids=["pt2pl-trim", "pt2pt-trim-ties", "icp-pt2pl-trim-ties"])
def test_emulated_epilogue_sums_in_its_plain_versions_order(
        emulated, variant, is_se3, overlap, ties):
    """K5's plain version adds in the kernel's order (512 lanes of rows
    in index order, a tree within each warp, the warp partials in warp
    order): compiled without FMA contraction, the kernel gives the plain
    version's A, b and st bit for bit for pt2pl and pt2pt (GICP's
    whitening is another eigen-solve, held within K5's tolerance)."""
    case = kcases.epilogue_case(variant, is_se3, False, overlap, ties=ties)
    want = cuda_loop.loop_epilogue_plain(*case[:5], **case[5])
    code, got = _k5(emulated, *case, 2)
    assert code == 0
    for name, a, b in zip(("A", "b", "st"), got, want):
        assert torch.equal(a, b), name


def _k_level_trim(keys, valid, count, levels):
    """The kernel's trim (``csrc/loop_epilogue.cu``) on one pair in numpy
    float32: the value bisection and the index bisection, each counting
    the 2^levels - 1 mids of ``levels`` tree levels in one pass and then
    walking them.  Returns (lo, hi, #(d <= lo) from the walk, kept)."""
    f = np.float32
    n = len(keys)
    d = np.where(valid, keys, f(3.4e38)).astype(np.float32)
    col = np.arange(n, dtype=np.float32)

    def mids(a, b, index):
        out, br = [], [(a, b)]
        for h in range((1 << levels) - 1):
            lo_h, hi_h = br[h]
            m = f(0.5) * (lo_h + hi_h)
            m = np.floor(m) if index else m
            out.append(m)
            br += [(lo_h, m), (m, hi_h)]
        return out

    def walk(a, b, steps, counts, target, index):
        low_count, done = 0, 0
        while done < steps:
            m = mids(a, b, index)
            c = counts(m)
            h = 0
            for _ in range(min(levels, steps - done)):
                if c[h] >= target:
                    b, h = m[h], 2 * h + 1
                else:
                    a, low_count, h = m[h], c[h], 2 * h + 2
            done += levels
        return a, b, low_count

    hi0 = f(max(0.0, float(d[valid].max()))) if valid.any() else f(0)
    lo, hi, clo = walk(f(-1), hi0, trim._STEPS,
                       lambda m: [int((d <= x).sum()) for x in m], count,
                       False)
    band = (d > lo) & (d <= hi)
    _, hii, _ = walk(f(-1), f(n - 1), cuda_loop.index_steps(n),
                     lambda m: [int((band & (col <= x)).sum()) for x in m],
                     count - clo, True)
    return lo, hi, clo, (d <= lo) | (band & (col <= hii))


@pytest.mark.parametrize("levels", [2, 3, 4])
def test_k_level_trim_walk_gives_the_sequential_brackets(levels):
    """Counting several bisection levels a pass reaches the brackets and
    the kept set of the sequential bisection (``trim._value_brackets``,
    ``cuda_loop._kept_mask``) on keys with long runs of equal values,
    duplicates at the keep boundary, zeros, and padded rows."""
    rng = np.random.default_rng(levels)
    n = 700
    rows = [
        rng.integers(0, 6, n).astype(np.float32) * np.float32(0.25),
        np.sqrt(rng.integers(0, 12, n).astype(np.float32) * 0.25),
        np.repeat(np.float32(1.5), n),
        rng.random(n, dtype=np.float32),
    ]
    for r, keys in enumerate(rows):
        for n_valid in (n, 601, 3):
            valid = np.arange(n) < n_valid
            for count in sorted({1, n_valid // 2, (3 * n_valid) // 4,
                                 n_valid}):
                lo, hi, clo, kept = _k_level_trim(keys, valid, count,
                                                  levels)
                kt, vt = torch.as_tensor(keys)[None], torch.as_tensor(
                    valid)[None]
                ct = torch.tensor([[float(count)]])
                _, lo_s, hi_s = trim._value_brackets(kt, vt, ct)
                assert (lo, hi) == (float(lo_s), float(hi_s)), (r, count)
                d = np.where(valid, keys, np.float32(3.4e38))
                assert clo == int((d <= lo).sum())
                want = cuda_loop._kept_mask(kt, vt, ct, n)[0].numpy()
                assert np.array_equal(kept, want), (r, n_valid, count)
                assert int(kept.sum()) == count

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
