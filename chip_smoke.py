#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``se3_icp_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU (written
for an H100, sm_90a) and the CUDA toolkit:

    python3 chip_smoke.py

It builds the CUDA kernels from ``se3_icp_tpu_torch/csrc`` (printing
ptxas's registers, spills and shared memory of K4, K1, K2, K3 and the
tiled 1-NN search of K6/K7/K8 on a ``ptxas`` line), holds each kernel
against its plain PyTorch version on the card at the main path's shapes
(64 pairs, 4608-point bucket; the glue kernels G1-G4 bit for bit, G4,
the setup's centring and scaling, also at 1 x 15872): the setup kernels
K1-K3 of the sort-free threshold route (K2 and K3 also bit for bit
between the spatial query
order and the index order, K2's one-ball instance against its three-ball
block, both also at the KITTI bucket, 8 x 15360) and the loop kernels K4
(also at 8 x 15360, and with its R3-phase chain held bit for bit against
its 12-FMA chain), K5 (also at 8 x 15360, each phase, whole and trimmed;
its launch on the chosen cluster of blocks a pair held bit for bit
against one block a pair). It then drives the main path through the
public entry points (``register_pairs`` with ``se3_pt2pl`` / ``GOLDEN``
on 64 seed-made golden-shape pairs, on the default threshold route and
again with ``exact_knn=True``), then smaller batches of the other
algorithms (the pt2pt variants among them, on the captured program),
then the CLI as a subprocess.
Then the paths of the 1-NN kernels K6-K9: the multistart restart fleet
(8 pairs x 8 starts), FGR + FPFH through ``register_pairs(..., "fgr")``
(64 pairs, a replay of FGR's captured program, held bit for bit with its
per-pair counts against the eager function on these clouds and on moved
ones), the metrics on the main path's results, the public 1-NN
ops, ``run fgr`` and ``run --multi-start`` of the CLI, and K6-K9 against
their plain versions (K9 at 4608 points, D = 3, and 15360, D = 12, its
targets split over several blocks a query tile and held bit for bit
against the unsplit search; K6, K7 and K8, the register-tiled search,
held bit for bit against the one-query-a-thread search at S = 1 on the
same batch, K8 on the engine's packed targets at 64 x 4608 and 8 x
15360).  K5's and K6-K9's cases report the kernel alone
(torch.profiler) beside the time through the wrapper.  It gates
every result at 2 deg / 0.25, and shows
from the wrappers' launch counts that each path went through its
kernels.  The counts are kept on the card, each added to beside its
kernel's launch (``ops/_build.count_launch``), so on the captured CUDA
graph the engine runs as (``models/program.py``) a replay counts the
launches it ran, the loop kernels once a step that ran; one replayed
main-path call is also profiled and the profiler must see the launches
the counters saw.  Every path on the
captured program is run again on the eager polled loop and must give
its bits (``program`` line, with the cost of a skipped group of steps);
a ``serving`` phase sends 4 scan-to-model batches of 64 pairs through
``register_pairs_async`` with one in flight and holds them against
``register_pairs`` one batch at a time.  A ``protocols`` phase writes
the seed-made lounge and KITTI fixtures, holds K1-K5 against their plain
versions at the KITTI protocol's shapes (32 x 16384 batched, B = 1
online), and runs the bench protocols of ``se3_icp_tpu_torch/bench``
through their entry points and the CLI (79 lounge pairs at the 4608
bucket, three runs, every pair gated; 40 KITTI pairs of ~15.3k points
on the resampled road, batched and online, every pair gated; the same
40 pairs of the hard ring-scan fixture, 12.3k-16.1k points, batched and
online for their program keys and times, the online results held
against the eager loop; the KITTI gates of the JAX package's own tests
on its tests' fixtures; the analyses; two-alpha sweeps that must
capture nothing for their second alpha; ``lrf-quality``, ``eval-traj``,
``test-se3-pure``), each run's ``protocol`` line with its captures,
program keys, reserved memory and launches.  A ``bunny`` phase writes
the seed-made bunny stand-in (``fixtures.write_bunny_standin``, named by
``SE3_ICP_TPU_BUNNY``) and runs the bunny protocols: ``create-problem``,
``example`` and ``example-fgr`` of the CLI in a subprocess;
``bench-synthetic`` (30 cases each of easy and moderate at the 4608
bucket, every case held against the JAX package's survey
``tests/data/bunny_survey.json``; one ``--multi-start 8`` run; a
two-alpha sweep); ``bench-extreme-noise`` (11 levels of 30 runs, level
0.0 gated run by run); ``bench-scaling --per-device 64``.  Then SHOT
frames (64 x 4608 exact, 8 pairs capped) and Anderson acceleration
(``anderson_m`` 0, 3, 5 at 64 x 4608) on the captured program, each
held bit for bit against the eager loop with no host sync.  A
``scaleout`` phase runs the pairs mesh over meshes that name the one
card 2 and 4 times (64 pairs, and 62 padded over 4: every pair the
unsharded call's bits; the setup checksum sharded against unsharded,
bitwise; ``bench-scaling``'s ladder, run by the bunny phase over the
cards present, is quoted), holds 8 pairs of ``se3_pt2pl``,
``se3_gicp``, ``se3_pt2pt`` and ``pt2pl`` whole against shards of 4, 2
and 1 and against the first 8 of a 64-pair batch (every pair the same
bits and counts), K1-K4's
row-slice instances at R = 2, 4 on 64 x 4608 and one KITTI road pair
(1 x 15872; concatenated the whole call's bits, each slice held against
its plain version), and on a world-1 NCCL group the points route (the
golden pair, the road pair: a replay of its captured program, the
all_gathers inside the graph), the 2-D layout (1 x 1, 32 road pairs) and
``register_pairs_multihost`` (64 pairs), each against the eager loop's
or ``register_pairs``' bits, with ms a call and launches beside the
points route's eager loop and ``register_arrays``'.  The ``program``
line, printed last, lists every path's hold.  Every phase
prints one JSON line; any failed phase raises, so the exit code is
non-zero and the final ``{"ok": true, ...}`` line is not printed.
Without a CUDA device it exits with code 2 and prints no result.
The ``profile`` line (device time by kernel name, the device's idle
share) of one main-path call is always printed; ``--profile`` adds one
multistart call's.
"""

from __future__ import annotations

import copy
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# Published peaks of one H100 SXM (NVIDIA data sheet, dense): float32
# outside the tensor cores, and HBM3 bandwidth.  The float32 rate counts
# an FMA as two operations; a plain add, multiply, min or compare issues
# at the same instruction rate, so such operations run at half of it.
PEAK_F32_FLOPS = 67e12
PEAK_F32_OPS_NO_FMA = PEAK_F32_FLOPS / 2
PEAK_BYTES_PER_S = 3.35e12

N_PAIRS = 64                 # the main path's batch
SMALL_BATCH = 8              # the other algorithms' batch
K4_D2_TOL = 1e-4             # abs; d2 sums ~40-magnitude float32 terms
# ... of the golden clouds, whose max |q|^2 + max |t|^2 is at most ~72
# (scaled SE(3) frame and icp frame alike); a pair with larger terms
# (the icp variants' unscaled KITTI metres, ~2e3) is held to the same
# share of them
K4_D2_TERMS = 72.0
K4_FLIP_SHARE = 0.01         # rows whose two nearest targets tie in rounding
K5_REL_TOL = {"pt2pt": 1e-5, "pt2pl": 1e-5, "gicp": 1e-4}
K2_REL_TOL = 1e-5            # of each row's largest entry: f32 sums, other order
K3_REL_TOL = 1e-4            # weights are products of four rounded factors
# K6-K9: |d2 - d2_plain| over |q|^2 + max |t|^2 of the pair, the terms the
# shifted form |t|^2 - 2 q.t + |q|^2 cancels (a few float32 ulps of them);
# at most 1% of rows may pick another target, each within that of the
# plain version's in float64
NN_D2_REL = 1e-5
NN_FLIP_SHARE = 0.01
MS_PAIRS, MS_STARTS = 8, 8   # the multistart fleet: 64 flat registrations


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def time_ms(fn, reps: int = 7) -> float:
    """Median time of one call, CUDA events, after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def alone_ms(fn, tag: str, reps: int = 20, tries: int = 5) -> float:
    """Device time of one launch of the kernel whose name holds ``tag``,
    alone: torch.profiler's CUDA time of ``reps`` calls of ``fn`` (each
    launching it once) after a warm-up call, the mean over the launches
    the profiler recorded.  It drops records, at times more than half of
    a round's, so rounds of ``reps`` calls are pooled until at least
    ``reps`` / 2 launches were recorded, in at most ``tries`` rounds."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    calls, total = 0, 0.0
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and tag in e.key]
        calls += sum(e.count for e in rows)
        total += sum(e.device_time_total for e in rows)
        if 2 * calls >= reps:
            return total / calls / 1e3
    raise RuntimeError(f"chip_smoke: {tag}: {calls} profiled launches of "
                       f"{tries * reps} in {tries} rounds")


def gate(problems, results, what: str):
    from se3_icp_tpu_torch.utils import metrics_host as mh
    worst_rot = worst_tra = 0.0
    for i, (p, r) in enumerate(zip(problems, results)):
        T = r.transformation
        check(T.shape == (4, 4) and np.isfinite(T).all(),
              f"{what}: pair {i} transform not finite")
        rot = mh.angular_error_so3(T[:3, :3], p.T_gt[:3, :3])
        tra = mh.translation_error(T[:3, 3], p.T_gt[:3, 3])
        worst_rot, worst_tra = max(worst_rot, rot), max(worst_tra, tra)
        check(mh.success(p.T_gt, T),
              f"{what}: pair {i} fails the 2 deg / 0.25 gate "
              f"({rot:.4f} deg, {tra:.4f})")
    return worst_rot, worst_tra


def device_phase() -> dict:
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit("device", kind=kind, count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)
    return {"platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}


def ptxas_resources(log: str) -> dict:
    """Registers, spill bytes and static shared memory of every kernel
    entry in ``nvcc -Xptxas -v`` output, by (mangled) entry name."""
    import re
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$]+)'?", line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur.update(spill_stores=int(m.group(1)),
                       spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            cur["smem_bytes"] = int(sm.group(1)) if sm else 0
    return out


def build_phase() -> None:
    import contextlib
    import io
    from se3_icp_tpu_torch.ops import _build
    t0 = time.perf_counter()
    # forced: a library left by an earlier run must not hide a source
    # that no longer builds
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        lib_path = _build.build(force=True, verbose=True)
    print(log.getvalue(), flush=True)
    _build.load()
    emit("build", seconds=round(time.perf_counter() - t0, 3),
         sources=[os.path.relpath(s, ROOT) for s in _build.sources()],
         library=os.path.relpath(lib_path, ROOT))
    # K4, K1's instances by the number of counts T and K2's by the number
    # of balls (template arguments), K3; the tiled 1-NN search (K6, K7,
    # K8) by width, with its dynamic shared memory a block
    import re
    res = ptxas_resources(log.getvalue())
    lib = _build.load()

    def tiled(pay, packed):
        """nn_tiled_kernel<D, kPay, kPacked> by D."""
        out = {}
        for k, v in res.items():
            m = re.search(r"nn_tiled_kernelILi(\d+)ELb(\d)ELb(\d)E", k)
            if m and (int(m.group(2)), int(m.group(3))) == (pay, packed):
                d = int(m.group(1))
                out[f"D={d}"] = dict(v, dynamic_smem_bytes=(
                    lib.se3icp_nn_tiled_smem(d, packed)))
        return out
    emit("ptxas", nn_match_affine={k: v for k, v in res.items()
                                   if "match_affine_kernel" in k},
         nn_argmin_batched=tiled(0, 0), nn_match_batched=tiled(1, 0),
         nn_match_packed=tiled(1, 1),
         neighborhood_thresholds_batched={
             f"T={k.split('thresholds_kernelILi')[1][0]}": v
             for k, v in res.items() if "thresholds_kernelILi" in k},
         moments_batched={
             f"balls={k.split('moments_kernelILi')[1][0]}": v
             for k, v in res.items() if "moments_kernelILi" in k},
         axis_sums_batched={k: v for k, v in res.items()
                            if "axis_kernel" in k},
         frame_inputs={f"mode={k.split('frame_inputs_kernelILi')[1][0]}": v
                       for k, v in res.items()
                       if "frame_inputs_kernelILi" in k},
         frame_assembly={k: v for k, v in res.items()
                         if "frame_assembly_kernel" in k},
         step_update={("pt2pt" if "kernelILb1" in k else "6x6"): v
                      for k, v in res.items() if "step_update_kernel" in k},
         center_scale={k: v for k, v in res.items() if "prep_kernel" in k})


def golden_pairs(n_pairs, **kw):
    from se3_icp_tpu_torch.datasets import fixtures
    return [fixtures.golden_shape_problem(seed=s, **kw)
            for s in range(1, n_pairs + 1)]


def hyper_on(cfg):
    """The traced hyperparameters of ``cfg`` as the engine reads them:
    views of one float32 vector on the card."""
    from se3_icp_tpu_torch.models import registration as reg
    return reg.hyper(reg.split_cfg(cfg, torch.float32, "cuda")[0])


def match_state(problems, cfg, algorithm):
    """Setup on the card, as the main path runs it."""
    from se3_icp_tpu_torch.models import registration as reg
    from se3_icp_tpu_torch.parallel import pairs
    from se3_icp_tpu_torch.utils.config import parse_algorithm
    mode, variant = parse_algorithm(algorithm)
    src, n_src, tgt, n_tgt = pairs.pack_pairs(
        [(p.source, p.target) for p in problems])
    t = lambda a: torch.as_tensor(a, device="cuda")
    with torch.no_grad():
        ms, pre = reg.setup(t(src), t(n_src), t(tgt), t(n_tgt), cfg, mode,
                            variant, hyper_on(cfg))
    return ms, pre


def loop_inputs(ms, cfg, switched, done, T):
    """W, phase and pf of one iteration at pose T, as the loop makes
    them."""
    from se3_icp_tpu_torch.models import registration as reg
    W, phase, pf = reg.iteration_inputs(ms, cfg, T, switched, done,
                                        hyper_on(cfg))
    return W.contiguous(), phase.contiguous(), pf.contiguous()


def near_gt_pose(problems, pre, dev):
    """A pose a little off the ground truth, in the preprocessed frame
    (where the loop works): realistic distances for the trim."""
    from se3_icp_tpu_torch.datasets import fixtures
    T = []
    for p in problems:
        Tp = p.T_gt.copy()
        Tp[:3, :3] = Tp[:3, :3] @ fixtures.rot_3d(0.02, -0.015, 0.01)
        T.append(Tp)
    T = torch.as_tensor(np.stack(T), dtype=torch.float32, device=dev)
    R = T[:, :3, :3]
    tp = (T[:, :3, 3] + (R @ pre.cen_s[..., None])[..., 0]
          - pre.cen_t) * pre.scaling[:, None]
    out = torch.eye(4, device=dev).repeat(len(problems), 1, 1)
    out[:, :3, :3] = R
    out[:, :3, 3] = tp
    return out


def k4_case(name, ms, W, phase):
    """Kernel vs plain version of the match at one set of inputs."""
    from se3_icp_tpu_torch.ops import cuda_knn
    d2_k, mt_k = cuda_knn.nn_match_affine(ms.feat16, W, ms.targets, phase)
    torch.cuda.synchronize()
    d2_p, mt_p = cuda_knn.nn_match_affine_plain(ms.feat16, W, ms.targets,
                                                phase)
    live = phase[:, 1] == 0
    check(bool(live.any()), f"{name}: no active pair")
    check(bool(torch.isfinite(d2_k[live]).all()), f"{name}: d2 not finite")
    err_b = (d2_k[live] - d2_p[live]).abs().amax(1)
    err = float(err_b.max())
    q = (ms.feat16 @ W)[..., :cuda_knn.EMB_DIM]
    tn = ms.targets.tn[torch.arange(len(phase), device=phase.device),
                       phase[:, 0].long()]
    terms = ((q * q).sum(-1).amax(1) + tn.amax(1))[live]
    tol_b = K4_D2_TOL * (terms / K4_D2_TERMS).clamp_min(1.0)
    flips = (mt_k[live] != mt_p[live]).any(1)            # [Blive,Nq]
    share = float(flips.float().mean())
    same = ~flips
    pay_err = float(((mt_k[live] - mt_p[live]).abs().amax(1) * same).max())
    check(bool((err_b <= tol_b).all()),
          f"{name}: d2 differs by {err} > {K4_D2_TOL} (x max(1, max |q|^2 "
          f"+ max |t|^2 over {K4_D2_TERMS}): {float(tol_b.max())})")
    check(share <= K4_FLIP_SHARE,
          f"{name}: {share:.4%} of rows match another target than the "
          f"plain version (limit {K4_FLIP_SHARE:.0%})")
    ms_k = time_ms(lambda: cuda_knn.nn_match_affine(ms.feat16, W, ms.targets,
                                                    phase))
    ms_p = time_ms(lambda: cuda_knn.nn_match_affine_plain(
        ms.feat16, W, ms.targets, phase), reps=3)
    # least time: FMAs of the active pairs over valid targets, and every
    # input once (the selected phase's embedding) plus the outputs
    bsz, nq, _ = ms.feat16.shape
    nt, p = ms.targets.payload.shape[1:]
    n_live = int(live.sum())
    # 12 FMAs per (query, target) in the SE(3) phase; 3 in the R3 phase,
    # where the rotation block of query and target is zero
    width = torch.where(phase[:, 0] == 1, 3.0, 12.0).double()
    pair_ops = float((width * ms.targets.n.double() * nq)[live].sum())
    t_ops = 2 * pair_ops / PEAK_F32_FLOPS
    nbytes = 4 * n_live * (nq * 16 + 256 + nt * 12 + nt + nt * p + nq
                           + p * nq)
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return dict(name=name, max_abs_err=err, matched_payload_max_abs_err=pay_err,
                near_tie_rows=int(flips.sum()), near_tie_share=share,
                tolerance=float(tol_b.max()), terms=float(terms.max()),
                ms=ms_k, plain_ms=ms_p,
                bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                library_ms=None, shape=dict(B=bsz, Nq=nq, Nt=nt, P=p),
                active_pairs=n_live)


def k4_r3_bits(name, ms, W, phase):
    """The R3 phase's 3-FMA chain against the 12-FMA chain that the SE(3)
    path runs on the same targets (the phase-B embedding packed as both
    phases): the same d2 bits and the same matched rows."""
    from se3_icp_tpu_torch.ops import cuda_knn
    t = ms.targets
    same = cuda_knn.MatchTargets(
        emb=t.emb[:, 1:2].expand(-1, 2, -1, -1).contiguous(),
        tn=t.tn[:, 1:2].expand(-1, 2, -1).contiguous(),
        payload=t.payload, n=t.n)
    r3 = (phase[:, 0] == 1) & (phase[:, 1] == 0)
    check(bool(r3.any()), f"{name}: no live R3-phase pair")
    d2, mt = cuda_knn.nn_match_affine(ms.feat16, W, t, phase)
    as_se3 = phase.clone()
    as_se3[:, 0] = 0
    d2_s, mt_s = cuda_knn.nn_match_affine(ms.feat16, W, same, as_se3)
    torch.cuda.synchronize()
    differ = int((d2[r3] != d2_s[r3]).sum())
    check(differ == 0 and bool((mt[r3] == mt_s[r3]).all()),
          f"{name}: the R3 chain differs from the 12-FMA chain in {differ} "
          "distances")
    return dict(r3_pairs=int(r3.sum()), r3_bits_equal_12_fma_chain=True)


def k5_case(name, ms, cfg, matched_T, pf):
    from se3_icp_tpu_torch.ops import cuda_loop
    from se3_icp_tpu_torch.models import registration as reg
    kw = reg.epilogue_options(ms, cfg)
    args = (ms.src_cT, matched_T, pf, ms.cov_src6, ms.conf_src)
    out_k = cuda_loop.loop_epilogue_batched(*args, **kw)
    torch.cuda.synchronize()
    out_p = cuda_loop.loop_epilogue_plain(*args, **kw)
    rel = K5_REL_TOL[ms.variant]
    errs = {}
    for key, k, p in zip(("A", "b", "st"), out_k, out_p):
        check(bool(torch.isfinite(k).all()), f"{name}: {key} not finite")
        errs[key] = float((k - p).abs().max())
    A_k, b_k, st_k = out_k
    A_p, b_p, st_p = out_p
    # the kept set is the same set: equal counts, exactly
    check(bool((st_k[:, 1] == st_p[:, 1]).all()),
          f"{name}: kept counts differ from the plain version")
    scale_A = A_p.abs().flatten(1).amax(1).clamp_min(1.0)
    scale_b = b_p.abs().amax(1).clamp_min(1.0)
    rel_A = float(((A_k - A_p).abs().flatten(1).amax(1) / scale_A).max())
    rel_b = float(((b_k - b_p).abs().amax(1) / scale_b).max())
    rel_mse = float(((st_k[:, 0] - st_p[:, 0]).abs()
                     / st_p[:, 0].abs().clamp_min(1e-6)).max())
    check(rel_A <= rel and rel_b <= rel and rel_mse <= 1e-5,
          f"{name}: A/b/mse differ by {rel_A:.2e}/{rel_b:.2e}/"
          f"{rel_mse:.2e} (limit {rel:.0e}, mse 1e-5)")
    # the plain version adds in the kernel's order: which outputs keep
    # its bits (the kernel contracts products into FMAs, the plain
    # version rounds each)
    bit_equal = dict(
        A=int((A_k == A_p).all(0).sum()), b=int((b_k == b_p).all(0).sum()),
        mse=bool((st_k[:, 0] == st_p[:, 0]).all()))
    # two runs give the same bits (fixed-order sums, no atomics), and a
    # pair on one block (C = 1) the same bits as on the chosen cluster
    again = cuda_loop.loop_epilogue_batched(*args, **kw)
    check(all(bool((a == b).all()) for a, b in zip(out_k, again)),
          f"{name}: two runs of the kernel differ")
    one = cuda_loop.loop_epilogue_batched(*args, **kw, cluster=1)
    check(all(same_bits(a, b) for a, b in zip(out_k, one)),
          f"{name}: C = 1 gives other bits than the chosen cluster")
    cluster = cuda_loop.cluster_size(ms.src_cT.shape[0], ms.src_cT.device,
                                     kw["do_trim"])
    ms_k = time_ms(lambda: cuda_loop.loop_epilogue_batched(*args, **kw))
    ms_alone = alone_ms(lambda: cuda_loop.loop_epilogue_batched(*args, **kw),
                        "epilogue_kernel")
    ms_p = time_ms(lambda: cuda_loop.loop_epilogue_plain(*args, **kw),
                   reps=3)
    bsz, _, n = ms.src_cT.shape
    p_rows = matched_T.shape[1]
    rows = 3 + p_rows + (6 if ms.variant == "gicp" else 0) \
        + (1 if ms.use_cf else 0)
    nbytes = 4 * bsz * (n * rows + 24 + 36 + 8 + 8)
    flops_pt = {"pt2pt": 60, "pt2pl": 110, "gicp": 450}[ms.variant]
    t_ops = flops_pt * float(ms.n_src.sum()) / PEAK_F32_FLOPS
    t_bytes = nbytes / PEAK_BYTES_PER_S
    # max_abs_err: every output scaled by its pair's largest reference
    # entry (floor 1), since JtJ entries run to 1e6; raw values beside it
    return dict(name=name, max_abs_err=max(rel_A, rel_b, rel_mse),
                max_abs_err_unscaled=errs,
                max_rel_err=dict(A=rel_A, b=rel_b, mse=rel_mse),
                tolerance=dict(A_b_rel=rel, mse_rel=1e-5, wsum="exact"),
                entries_bit_equal_in_every_pair=bit_equal,
                bitwise_repeatable=True, cluster=cluster,
                same_bits_as_cluster_1=True, ms=ms_k, kernel_alone_ms=ms_alone,
                plain_ms=ms_p, bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                library_ms=None, shape=dict(B=bsz, N=n, P=p_rows),
                trim=cfg.estimated_overlap)


def bound(ops, nbytes, op_rate=PEAK_F32_FLOPS):
    """The least time for ``ops`` float32 operations at ``op_rate`` and
    ``nbytes`` moved (each input read once, each output written once),
    and what sets it."""
    t_ops, t_bytes = ops / op_rate, nbytes / PEAK_BYTES_PER_S
    return dict(bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def row_rel_err(got, ref, nv):
    """max over (pair, component row) of max |got - ref| / max |ref|, over
    the valid queries; [B,C,N] or [B,N]."""
    if got.dim() == 2:
        got, ref = got[:, None], ref[:, None]
    col = torch.arange(got.shape[-1], device=got.device)
    valid = (col[None, :] < nv[:, None])[:, None, :]
    diff = torch.where(valid, (got - ref).abs(), 0.0).amax(-1)
    scale = torch.where(valid, ref.abs(), 0.0).amax(-1).clamp_min(1e-30)
    return float((diff / scale).max())


def setup_clouds(problems, cfg=None):
    """The main path's setup inputs: the packed pairs on the card,
    centred and scaled as ``registration.preprocess`` does (under
    ``cfg``, by default GOLDEN)."""
    from se3_icp_tpu_torch.models import registration as reg
    from se3_icp_tpu_torch.parallel import pairs
    from se3_icp_tpu_torch.utils.config import GOLDEN
    cfg = cfg or GOLDEN
    src, n_src, tgt, n_tgt = (torch.as_tensor(a, device="cuda")
                              for a in pairs.pack_pairs(
                                  [(p.source, p.target) for p in problems]))
    src_c, tgt_c, _ = reg.preprocess(src, n_src, tgt, n_tgt, cfg, True,
                                     hyper_on(cfg))
    return (src_c, n_src), (tgt_c, n_tgt)


def k1_case(name, points, nv, counts, with_topk=False):
    """K1 against its plain version: the thresholds must be the same
    bits (same rounding steps).  Returns (case, thr)."""
    from se3_icp_tpu_torch.ops import cuda_moments as cm, knn
    cloud = cm.setup_cloud(points, nv)
    bsz, n, _ = points.shape
    cc = torch.tensor(counts, dtype=torch.int32,
                      device=points.device).expand(bsz, -1)
    thr = cm.neighborhood_thresholds_batched(points, nv, cc, cloud=cloud)
    torch.cuda.synchronize()
    thr_p = cm.neighborhood_thresholds_plain(points, nv, cc, cloud=cloud)
    check(bool(torch.isfinite(thr).all()), f"{name}: thresholds not finite")
    n_diff = int((thr != thr_p).sum())
    check(n_diff == 0, f"{name}: {n_diff} thresholds differ from the "
          "plain version's bits")
    # ball sizes the thresholds give (float32 distances, valid rows)
    d2 = knn._pairwise_d2(points[:1, :int(nv[0])], points[:1, :int(nv[0])])
    sizes = (d2[0, :, None, :] <= thr[0, :, :int(nv[0])].mT[:, :, None]) \
        .sum(-1).float()                                       # [n, T]
    ms_k = time_ms(lambda: cm.neighborhood_thresholds_batched(
        points, nv, cc, cloud=cloud))
    ms_p = time_ms(lambda: cm.neighborhood_thresholds_plain(
        points, nv, cc, cloud=cloud), reps=3)
    nvd = nv.double()
    # fold: 8 operations per (valid query, valid target); search: a
    # compare and an add per candidate lane and probe.  None of them is
    # an FMA (every step of the distance is explicitly rounded), so they
    # count at the non-FMA rate, half the float32 FLOP rate
    ops = (8 * float((nvd * nvd).sum())
           + 2 * cm.CAND * sum(cm.plan(len(counts))) * float(nvd.sum()))
    case = dict(name=name, max_abs_err=float((thr - thr_p).abs().max()),
                bit_equal=True, thresholds_differing=n_diff,
                ms=ms_k, plain_ms=ms_p,
                **bound(ops, 4 * bsz * n * (4 + len(counts)),
                        op_rate=PEAK_F32_OPS_NO_FMA),
                library_ms=None,
                counts=list(counts),
                ball_size_pair0=dict(
                    median=sizes.median(0).values.tolist(),
                    min=sizes.amin(0).tolist(), max=sizes.amax(0).tolist()),
                shape=dict(B=bsz, N=n, T=len(counts)),
                n_valid=[int(nv.min()), int(nv.max())])
    if with_topk:
        # context, not a yardstick: the exact route's sorted kNN of the
        # same cloud (one of the two torch.topk calls it makes)
        case["exact_route_topk_ms"] = time_ms(
            lambda: knn.knn_self(points, 91, nv), reps=3)
    return case, thr


def index_order(cloud):
    """A copy of the cloud with K2's and K3's query order set to the row
    order."""
    bsz, _, n = cloud.pts_t.shape
    other = copy.copy(cloud)
    other.order = torch.arange(n, dtype=torch.int32,
                               device=cloud.order.device).repeat(bsz, 1)
    return other


def query_order_case(points, nv, reps=7):
    """Host and device time of K2's and K3's query order
    (``cuda_moments._morton_order``) on one cloud batch.  A sleep kernel
    holds the stream while the host enqueues the order's launches, so the
    host time is the enqueueing alone and the events around the launches
    time their run back to back on the card."""
    from se3_icp_tpu_torch.ops import cuda_moments as cm
    cloud = cm.setup_cloud(points, nv)
    fn = lambda: cm._morton_order(cloud.pts_t, cloud.n)
    check(torch.equal(fn(), cloud.order), "query order not reproducible")
    host, dev = [], []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        a.record()
        t0 = time.perf_counter()
        fn()
        host.append(1e3 * (time.perf_counter() - t0))
        b.record()
        torch.cuda.synchronize()
        dev.append(a.elapsed_time(b))
    return dict(shape=dict(B=points.shape[0], N=points.shape[1]),
                host_ms=statistics.median(host),
                device_ms=statistics.median(dev))


def same_bits(a, b) -> bool:
    """Two results (tensors, tuples or dicts of tensors) hold the same
    bits."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_bits(a[k], b[k]) for k in a)
    if isinstance(a, tuple):
        return all(same_bits(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


def k2_case(name, points, nv, thr3):
    """K2 against its plain version: equal ball counts, sums within
    K2_REL_TOL of each row's largest entry; the same bits in the index
    order as in the spatial order, and the one-ball instance equal to
    its ball's block of the three-ball one.  Returns (case, moments)."""
    from se3_icp_tpu_torch.ops import cuda_moments as cm
    cloud = cm.setup_cloud(points, nv)
    args = (points, nv, *thr3)
    mom = cm.moments_batched(*args, cloud=cloud)
    torch.cuda.synchronize()
    mom_p = cm.moments_plain(*args, cloud=cloud)
    for key in ("cen_cnt", "cov_cnt", "all_cnt"):
        check(bool((mom[key] == mom_p[key]).all()),
              f"{name}: {key} differs from the plain version")
    errs = {k: row_rel_err(mom[k], mom_p[k], nv)
            for k in ("cen_sum", "cen_p9", "cov_sum", "cov_p9", "all_sum")}
    rel = max(errs.values())
    check(rel <= K2_REL_TOL,
          f"{name}: sums differ by {rel:.2e} > {K2_REL_TOL:.0e}")
    by_index = index_order(cloud)
    check(same_bits(cm.moments_batched(*args, cloud=by_index), mom),
          f"{name}: other bits in the index order")
    one = (points, nv, thr3[1])
    check(same_bits(cm.moments_one_ball(*one, cloud=cloud),
                    cm.moments_batched(*one, thr3[1], thr3[1], cloud=cloud)),
          f"{name}: the one-ball instance differs from its block")
    ms_k = time_ms(lambda: cm.moments_batched(*args, cloud=cloud))
    ms_idx = time_ms(lambda: cm.moments_batched(*args, cloud=by_index))
    ms_one = time_ms(lambda: cm.moments_one_ball(*one, cloud=cloud))
    ms_p = time_ms(lambda: cm.moments_plain(*args, cloud=cloud), reps=3)
    bsz, n, _ = points.shape
    nvd = nv.double()
    valid = torch.arange(n, device=nv.device)[None, :] < nv[:, None]
    cnt = [(mom[k] + 1.0) * valid for k in ("cen_cnt", "cov_cnt", "all_cnt")]
    members = sum(float(c.sum()) for c in cnt)
    widest = float(torch.maximum(torch.maximum(cnt[0], cnt[1]), cnt[2]).sum())
    # per (valid query, valid target) the distance (7) and a compare with
    # the largest threshold; per member of the widest ball six products
    # and three compares, per member and ball ten adds.  None is an FMA
    ops = 8 * float((nvd * nvd).sum()) + 9 * widest + 10 * members
    return dict(name=name, max_abs_err=rel, max_rel_err=errs,
                counts_equal=True, tolerance=K2_REL_TOL,
                index_order_bits_equal=True, one_ball_bits_equal=True,
                ms=ms_k, ms_index_order=ms_idx, ms_one_ball=ms_one,
                plain_ms=ms_p,
                **bound(ops, 4 * bsz * n * (4 + 1 + 3 + 30),
                        op_rate=PEAK_F32_OPS_NO_FMA),
                library_ms=None, members_per_query=members / float(
                    nvd.sum()), shape=dict(B=bsz, N=n)), mom


def k3_case(name, points, nv, thr_k, mom):
    """K3 against its plain version at the main path's inputs (the TOLDI
    normals of the moments); the same bits in the index order as in the
    spatial order."""
    from se3_icp_tpu_torch.ops import cuda_moments as cm, lrf
    cloud = cm.setup_cloud(points, nv)
    normal_t, ndotq, radius = lrf.toldi_axis_inputs(mom, thr_k, 30)
    args = (points, nv, normal_t, ndotq, radius, thr_k)
    w_p, w_sum = cm.axis_sums_batched(*args, cloud=cloud)
    torch.cuda.synchronize()
    pw_p, pw_sum = cm.axis_sums_plain(*args, cloud=cloud)
    check(bool(torch.isfinite(w_p).all() and torch.isfinite(w_sum).all()),
          f"{name}: sums not finite")
    rel = max(row_rel_err(w_p, pw_p, nv), row_rel_err(w_sum, pw_sum, nv))
    check(rel <= K3_REL_TOL,
          f"{name}: sums differ by {rel:.2e} > {K3_REL_TOL:.0e}")
    by_index = index_order(cloud)
    check(same_bits(cm.axis_sums_batched(*args, cloud=by_index),
                    (w_p, w_sum)), f"{name}: other bits in the index order")
    ms_k = time_ms(lambda: cm.axis_sums_batched(*args, cloud=cloud))
    ms_idx = time_ms(lambda: cm.axis_sums_batched(*args, cloud=by_index))
    ms_p = time_ms(lambda: cm.axis_sums_plain(*args, cloud=cloud), reps=3)
    bsz, n, _ = points.shape
    nvd = nv.double()
    valid = torch.arange(n, device=nv.device)[None, :] < nv[:, None]
    members = float(((mom["all_cnt"] + 1.0) * valid).sum())
    # distance (7) and a compare per (valid query, valid target); ~20
    # operations per member (sqrt, n.t, weight, three FMAs and an add).
    # None of the per-target ones is an FMA
    ops = 8 * float((nvd * nvd).sum()) + 20 * members
    return dict(name=name, max_abs_err=rel, tolerance=K3_REL_TOL,
                index_order_bits_equal=True, ms=ms_k,
                ms_index_order=ms_idx, plain_ms=ms_p,
                **bound(ops, 4 * bsz * n * (4 + 1 + 6 + 4),
                        op_rate=PEAK_F32_OPS_NO_FMA),
                library_ms=None, members_per_query=members / float(
                    nvd.sum()), shape=dict(B=bsz, N=n))


def setup_kernels_phase():
    """K1-K3 against their plain versions on the main path's clouds (both
    sides of 64 golden-shape pairs, 4167 of 4608 rows valid) with the
    main path's counts {90, 31, 30}; then K1 with GICP's count set and
    with n_valid varying over the batch, and K2, K3 on the sources of 8
    pairs in the KITTI bucket (8 x 15360).  Emits the time of K2's and
    K3's query order on the sources at both shapes."""
    from se3_icp_tpu_torch.ops import cuda_moments as cm
    problems = golden_pairs(N_PAIRS)
    k1, k2, k3, order = [], [], [], []
    for side, (pts, nv) in zip(("", "[target]"), setup_clouds(problems)):
        if not side:
            order.append(query_order_case(pts, nv))
        case, thr = k1_case(f"neighborhood_thresholds_batched{side}", pts,
                            nv, (90, 31, 30), with_topk=True)
        k1.append(case)
        case, mom = k2_case(f"moments_batched{side}", pts, nv,
                            (thr[:, 2], thr[:, 1], thr[:, 0]))
        k2.append(case)
        k3.append(k3_case(f"axis_sums_batched{side}", pts, nv, thr[:, 0],
                          mom))
        if not side:
            k1.append(k1_case("neighborhood_thresholds_batched[gicp, T=4]",
                              pts, nv, (90, 31, 30, 20))[0])
            gen = torch.Generator(device="cpu").manual_seed(0)
            nv_mixed = torch.randint(2048, 4168, (N_PAIRS,), generator=gen,
                                     dtype=torch.int32).to(pts.device)
            k1.append(k1_case(
                "neighborhood_thresholds_batched[n_valid 2048..4167]",
                pts, nv_mixed, (90, 31, 30))[0])
        del thr, mom
        torch.cuda.empty_cache()
    (pts, nv), _ = setup_clouds(golden_pairs(SMALL_BATCH, n=15000))
    order.append(query_order_case(pts, nv))
    emit("query_order", cases=order)
    cc = torch.tensor([90, 31, 30], dtype=torch.int32,
                      device=pts.device).expand(pts.shape[0], -1)
    thr = cm.neighborhood_thresholds_batched(pts, nv, cc)
    shape = f"[{pts.shape[0]}x{pts.shape[1]}]"
    case, mom = k2_case(f"moments_batched{shape}", pts, nv,
                        (thr[:, 2], thr[:, 1], thr[:, 0]))
    k2.append(case)
    k3.append(k3_case(f"axis_sums_batched{shape}", pts, nv, thr[:, 0], mom))
    return k1, k2, k3


def kernels_phase():
    """Each kernel against its plain version at the main path's shapes."""
    from se3_icp_tpu_torch.ops import cuda_knn
    from se3_icp_tpu_torch.utils.config import GOLDEN
    problems = golden_pairs(N_PAIRS)
    dev = torch.device("cuda")
    bsz = N_PAIRS
    false_b = torch.zeros(bsz, dtype=torch.bool, device=dev)
    true_b = ~false_b
    some_done = torch.arange(bsz, device=dev) % 3 == 0
    eye = torch.eye(4, device=dev).repeat(bsz, 1, 1)
    k4_cases, k5_cases = [], []
    for alg in ("se3_pt2pl", "se3_pt2pt", "se3_gicp", "se3_gicp_with_cf",
                "pt2pl"):
        ms, pre = match_state(problems, GOLDEN, alg)
        near = near_gt_pose(problems, pre, dev)
        if alg == "se3_pt2pl":
            # the main path's own call: SE(3) phase from the identity
            W, phase, _ = loop_inputs(ms, GOLDEN, false_b, false_b, eye)
            k4_cases.append(k4_case("nn_match_affine", ms, W, phase))
            W, phase, _ = loop_inputs(ms, GOLDEN, true_b, some_done, near)
            name = "nn_match_affine[R3 phase, 1/3 done]"
            k4_cases.append(k4_case(name, ms, W, phase))
            k4_cases[-1].update(k4_r3_bits(name, ms, W, phase))
        else:
            # the other paths' payload widths, at their own first call
            # (the icp driver starts in the R3 phase)
            start = false_b if ms.is_se3 else true_b
            W, phase, _ = loop_inputs(ms, GOLDEN, start, false_b, eye)
            k4_cases.append(k4_case(
                f"nn_match_affine[{alg}, P={ms.targets.payload.shape[2]}]",
                ms, W, phase))
        for overlap in (1.0, 0.75):
            cfg = GOLDEN.replace(estimated_overlap=overlap)
            # mixed phases, poses near the answer: realistic distances
            switched = torch.arange(bsz, device=dev) % 2 == 1
            W, phase, pf = loop_inputs(ms, cfg, switched, false_b, near)
            _, matched_T = cuda_knn.nn_match_affine(ms.feat16, W,
                                                    ms.targets, phase)
            tag = (f"{ms.variant}{'+cf' if ms.use_cf else ''}"
                   f"{'' if ms.is_se3 else ', icp'}")
            name = ("loop_epilogue_batched"
                    if alg == "se3_pt2pl" and overlap == 1.0
                    else f"loop_epilogue_batched[{tag}, overlap {overlap}]")
            k5_cases.append(k5_case(name, ms, cfg, matched_T, pf))
        del ms
        torch.cuda.empty_cache()
    # the KITTI bucket: 8 pairs of 15,000 points padded to 15360, both
    # phases
    big = golden_pairs(SMALL_BATCH, n=15000)
    ms, pre = match_state(big, GOLDEN, "se3_pt2pl")
    false_8 = torch.zeros(SMALL_BATCH, dtype=torch.bool, device=dev)
    W, phase, _ = loop_inputs(ms, GOLDEN, false_8, false_8,
                              torch.eye(4, device=dev).repeat(SMALL_BATCH,
                                                              1, 1))
    k4_cases.append(k4_case("nn_match_affine[8 x 15360]", ms, W, phase))
    near8 = near_gt_pose(big, pre, dev)
    W, phase, _ = loop_inputs(ms, GOLDEN, ~false_8, false_8, near8)
    name = "nn_match_affine[8 x 15360, R3 phase]"
    k4_cases.append(k4_case(name, ms, W, phase))
    k4_cases[-1].update(k4_r3_bits(name, ms, W, phase))
    # K5 at the KITTI bucket: each phase, whole and trimmed
    for switched, ph in ((false_8, "SE(3)"), (~false_8, "R3")):
        for overlap in (1.0, 0.75):
            cfg = GOLDEN.replace(estimated_overlap=overlap)
            W, phase, pf = loop_inputs(ms, cfg, switched, false_8, near8)
            _, matched_T = cuda_knn.nn_match_affine(ms.feat16, W,
                                                    ms.targets, phase)
            k5_cases.append(k5_case(
                f"loop_epilogue_batched[8 x 15360, {ph} phase, overlap "
                f"{overlap}]", ms, cfg, matched_T, pf))
    del ms
    torch.cuda.empty_cache()
    return k4_cases, k5_cases


def glue_bits(got, want) -> int:
    """Entries of two tensors (or tuples, dicts of them) whose bits
    differ, NaN against NaN counted equal."""
    if isinstance(got, dict):
        return sum(glue_bits(got[k], want[k]) for k in got)
    if isinstance(got, tuple):
        return sum(glue_bits(a, b) for a, b in zip(got, want))
    if got is None or want is None:
        return 0 if got is None and want is None else 1
    want = want.contiguous()
    differ = got != want
    if got.is_floating_point():
        differ &= ~(torch.isnan(got) & torch.isnan(want))
    return int(differ.sum())


def glue_case(name, fn, plain, tag, ops, nbytes, shape):
    """A glue kernel against its plain version on the same inputs: the
    same bits or it fails; ms through the wrapper, the kernel alone
    (torch.profiler), the plain version's ms and the bound."""
    got = fn()
    torch.cuda.synchronize()
    differ = glue_bits(got, plain())
    check(differ == 0, f"{name}: {differ} entries differ from the plain "
          "version's bits")
    return dict(name=name, max_abs_err=0.0, bit_equal=True,
                entries_differing=differ, ms=time_ms(fn),
                kernel_alone_ms=alone_ms(fn, tag),
                plain_ms=time_ms(plain, reps=3),
                **bound(ops, nbytes, op_rate=PEAK_F32_OPS_NO_FMA),
                library_ms=None, shape=shape)


def frame_glue_inputs(pts, nv, fuse):
    """What the setup gives G1 and G2 on one cloud batch: (cloud, the
    thresholds of counts 90, 31, 30 and 20, G1's TOLDI arguments (the
    fused normal with ``fuse``), G2's arguments)."""
    from se3_icp_tpu_torch.ops import cuda_frames, cuda_moments as cm
    cloud = cm.setup_cloud(pts, nv)
    cc = torch.tensor([90, 31, 30, 20], dtype=torch.int32,
                      device=pts.device).expand(pts.shape[0], -1)
    thr = cm.neighborhood_thresholds_batched(pts, nv, cc, cloud=cloud)
    raw = cm.moments_raw(pts, nv, (thr[:, 2], thr[:, 1], thr[:, 0]), cloud)
    args = (raw, pts, cloud.tn, thr[:, 0], 30, 30 if fuse else None)
    normal_t, aux, fused = cuda_frames.frame_inputs(*args)
    w = cm.axis_sums_aux(pts, nv, normal_t, aux, cloud)
    return cloud, thr, args, (raw, pts, normal_t, w, fused)


def frame_glue_cases(tag, pts, nv, fuse):
    """G1 (TOLDI inputs, the fused normal with ``fuse``; the one-ball
    normals and GICP covariances of count 20) and G2 at the inputs the
    setup gives them on one cloud batch."""
    from se3_icp_tpu_torch.ops import cuda_frames, cuda_moments as cm
    bsz, n, _ = pts.shape
    cloud, thr, args, a2 = frame_glue_inputs(pts, nv, fuse)
    queries = float(nv.sum())
    shape = dict(B=bsz, N=n)
    # G1: ~300 operations a query for the covariance and its eigenvector
    # (the fused normal as many again); reads the covariance ball's 10
    # sums, the centroid ball's 3 (10 fused), the query, |q|^2 and its
    # threshold (5), writes 6 rows (9 fused)
    g1 = [glue_case(f"frame_inputs[{tag}{', fused normal' if fuse else ''}]",
                    lambda: cuda_frames.frame_inputs(*args),
                    lambda: cuda_frames.frame_inputs_plain(*args),
                    "frame_inputs_kernel", (600 if fuse else 300) * queries,
                    4 * bsz * n * (25 + 9 if fuse else 18 + 6), shape)]
    g2 = [glue_case(f"frame_assembly[{tag}]",
                    lambda: cuda_frames.frame_assembly(*a2),
                    lambda: cuda_frames.frame_assembly_plain(*a2),
                    "frame_assembly_kernel", 60 * queries,
                    4 * bsz * n * (14 + 18 + (6 if fuse else 0)), shape)]
    one = cm.moments_raw(pts, nv, (thr[:, 3],), cloud)
    for eps in (None, 1e-3):
        a1 = (one, pts, 20, 0, eps)
        g1.append(glue_case(
            f"frame_inputs[{tag}, one ball, "
            f"{'normals' if eps is None else 'gicp covariances'}]",
            lambda _a=a1: cuda_frames.ball_normals(*_a),
            lambda _a=a1: cuda_frames.ball_normals_plain(*_a),
            "frame_inputs_kernel", 300 * queries,
            4 * bsz * n * (13 + (3 if eps is None else 6)), shape))
    return g1, g2


def step_glue_configs():
    """[(algorithm, config)] of the G3 cases: pt2pl, GICP trimmed to
    0.75, pt2pt."""
    from se3_icp_tpu_torch.utils.config import GOLDEN
    return [("se3_pt2pl", GOLDEN),
            ("se3_gicp", GOLDEN.replace(estimated_overlap=0.75)),
            ("se3_pt2pt", GOLDEN)]


def step_glue_inputs(problems, alg, cfg):
    """G3's inputs two steps into the loop of ``problems`` under ``alg``
    and ``cfg``, a fifth of the pairs done: (ms, loop state s, loop
    constants c, A, b, st, the state {name: tensor} in the C entry's
    order, the step's keyword arguments)."""
    from se3_icp_tpu_torch.models import registration as reg
    from se3_icp_tpu_torch.ops import cuda_step
    from se3_icp_tpu_torch.utils.config import parse_algorithm
    mode, _ = parse_algorithm(alg)
    ms, pre = match_state(problems, cfg, alg)
    with torch.no_grad():
        s, c = reg.init_loop(ms, pre.scaling, cfg, mode, hyper_on(cfg),
                             record_history=True)
        for _ in range(2):
            s = reg.loop_step(s, ms, c)
        s.done[::5] = True
        A, b, st = reg._match_and_epilogue(s, ms, c, s.W, s.ph2, s.pf)
    state = {k: getattr(s, k)
             for k in cuda_step.STATE + ("hist", "W", "ph2", "pf")}
    kw = dict(variant=ms.variant, is_se3=ms.is_se3, hybrid=c.hybrid,
              do_trim=c.ep_kw["do_trim"], max_iters=c.max_iters,
              max_se3_iters=cfg.max_num_se3_iterations)
    return ms, s, c, A, b, st, state, kw


def step_glue_case(name, problems, alg, cfg):
    """G3 against ``cuda_step.step_update_plain`` two steps into the
    loop, a fifth of the pairs done; beside it the torch glue it replaced
    (``registration.torch_glue_update``) on the same inputs."""
    from se3_icp_tpu_torch.models import registration as reg
    from se3_icp_tpu_torch.ops import cuda_step
    ms, s, c, A, b, st, state, kw = step_glue_inputs(problems, alg, cfg)
    keys = tuple(state)
    with torch.no_grad():
        work = {k: v.clone() for k, v in state.items()}

        def run(fn, st_=None):
            return {k: v for k, v in fn(
                A, b, st, st_ or {k: v.clone() for k, v in state.items()},
                c.hv, c.stop_thresh, c.n_src_f, **kw).items() if k in keys}
        bsz = A.shape[0]
        # per pair: the 6x6 elimination, retraction and update ~600
        # operations, pt2pt's 24 squarings ~1,900; reads A, b, st and the
        # state (~80 floats), writes the state, the history row, W, ph2
        # and pf (~320)
        ops = (1900 if ms.variant == "pt2pt" else 600) * bsz
        case = glue_case(name, lambda: run(cuda_step.step_update, work),
                         lambda: run(cuda_step.step_update_plain),
                         "step_update_kernel", ops, 4 * bsz * 400,
                         dict(B=bsz, variant=ms.variant, hybrid=c.hybrid))
        case["replaced_glue_ms"] = time_ms(
            lambda: reg.torch_glue_update(s, A, b, st, ms, c), reps=3)
        case["done_pairs"] = int(s.done.sum())
    return case


def prep_glue_inputs(problems):
    """G4's arguments on the packed pairs: (src, n_src, tgt, n_tgt,
    scale_preprocessing) on the card."""
    from se3_icp_tpu_torch.parallel import pairs
    from se3_icp_tpu_torch.utils.config import GOLDEN
    src, n_src, tgt, n_tgt = (torch.as_tensor(a, device="cuda")
                              for a in pairs.pack_pairs(
                                  [(p.source, p.target) for p in problems]))
    return src, n_src, tgt, n_tgt, hyper_on(GOLDEN).scale_preprocessing


def prep_glue_case(tag, problems):
    """G4 against its plain version on the packed pairs, bit for bit, at
    the cluster size its wrapper picks and at every other; beside it,
    for context, ``torch.sum`` of the masked source cloud (the
    centroid's sum alone, in torch's order: no PyTorch call computes the
    whole function)."""
    from se3_icp_tpu_torch.ops import cuda_prep
    args = prep_glue_inputs(problems)
    src, n_src, tgt, n_tgt, _ = args
    bsz, ns, _ = src.shape
    nt = tgt.shape[1]
    # per valid row: 3 sums (centroid); 3 differences, 3 squares, 2
    # sums, a sqrt and a max (radius); 3 differences and 3 products (the
    # write): 19.  Reads each cloud's valid rows once (padded rows are
    # written as 0, never read), the two counts a pair and the scale;
    # writes both clouds centred at their padded widths and 7 floats a
    # pair
    rows = int(n_src.sum() + n_tgt.sum())
    case = glue_case(f"center_scale[{tag}]",
                     lambda: cuda_prep.center_scale(*args),
                     lambda: cuda_prep.center_scale_plain(*args),
                     "prep_kernel", 19 * rows,
                     4 * (3 * rows + 3 * bsz * (ns + nt) + 9 * bsz + 1),
                     dict(B=bsz, Ns=ns, Nt=nt))
    case["cluster"] = cuda_prep.cluster_size(bsz, src.device)
    want = cuda_prep.center_scale_plain(*args)
    for c in cuda_prep.CLUSTERS:
        differ = glue_bits(cuda_prep.center_scale(*args, cluster=c), want)
        check(differ == 0, f"center_scale[{tag}] at C = {c}: {differ} "
              "entries differ from the plain version's bits")
    case["clusters_bit_equal"] = list(cuda_prep.CLUSTERS)
    valid = torch.arange(ns, device="cuda")[None] < n_src[:, None]
    masked = torch.where(valid[..., None], src, torch.zeros_like(src))
    case["context_ms_torch_sum_masked_source"] = time_ms(
        lambda: masked.sum(1))
    return case


def glue_kernels_phase():
    """G1-G4 against their plain versions, bit for bit, at the main
    path's shapes (both sides of its 64 golden-shape pairs, the target's
    TOLDI pass with the fused pt2pl normal) and at the KITTI road's
    bucket (1 x 15872); G3 for pt2pl, GICP and pt2pt at 64 pairs."""
    problems = golden_pairs(N_PAIRS)
    g1, g2, g3 = [], [], []
    g4 = [prep_glue_case("64 pairs, 4608", problems),
          prep_glue_case("1 pair, 15872", golden_pairs(1, n=15500)),
          prep_glue_case("1 pair, 4608", problems[:1])]
    for side, (pts, nv) in zip(("64x4608", "64x4608, target"),
                               setup_clouds(problems)):
        a, b = frame_glue_cases(side, pts, nv, fuse=bool("target" in side))
        g1.extend(a)
        g2.extend(b)
    (pts, nv), _ = setup_clouds(golden_pairs(1, n=15500))
    a, b = frame_glue_cases(f"1x{pts.shape[1]}", pts, nv, fuse=False)
    g1.extend(a)
    g2.extend(b)
    for alg, cfg in step_glue_configs():
        g3.append(step_glue_case(
            f"step_update[{alg}, 64 pairs"
            f"{', trimmed' if cfg.estimated_overlap < 1 else ''}]",
            problems, alg, cfg))
    torch.cuda.empty_cache()
    return g1, g2, g3, g4


def protocol_kernel_cases(folder, max_index):
    """K1-K5 against their plain versions at the KITTI protocol's own
    shapes, on its scans: the batched run's first chunk (32 pairs packed
    as ``run_pairs`` packs them, ``se3_pt2pl`` under KITTI_SE3: K1 with
    its source and target counts, K2 and K3, K4 in both phases, K5
    trimmed to 0.7), and the online run's B = 1 (pair 0, each cloud in
    its own bucket, ``pt2pl`` under KITTI_VANILLA: K1 with the target's
    normals count and with KITTI_SE3's source counts, K4, K5 trimmed to
    0.8).  Returns {kernel: [cases]}."""
    from se3_icp_tpu_torch.bench import kitti_bench
    from se3_icp_tpu_torch.models import registration as reg
    from se3_icp_tpu_torch.ops import cuda_knn
    from se3_icp_tpu_torch.utils.config import KITTI_SE3, KITTI_VANILLA
    clouds, poses = kitti_bench.load_kitti(folder, max_index=max_index)
    probs = [types.SimpleNamespace(
        source=clouds[i + 1], target=clouds[i],
        T_gt=np.linalg.inv(poses[i]) @ poses[i + 1])
        for i in range(len(clouds) - 1)]
    dev = torch.device("cuda")
    out = {k: [] for k in ("k1", "k2", "k3", "k4", "k5")}
    for batch, cfg, alg, tag in ((probs[:32], KITTI_SE3, "se3_pt2pl",
                                  "kitti batched"),
                                 (probs[:1], KITTI_VANILLA, "pt2pl",
                                  "kitti online")):
        bsz = len(batch)
        is_se3 = alg.startswith("se3")
        (src, n_src), (tgt, n_tgt) = setup_clouds(batch, cfg)
        c_src, c_tgt = reg._count_sets(cfg, is_se3, True, False)
        if not is_se3:      # the SE(3) variant's source counts at B = 1
            c_src = reg._count_sets(KITTI_SE3, True, True, False)[0]
        shape = f"{bsz} x {src.shape[1]}"
        case, thr = k1_case(f"neighborhood_thresholds_batched[{tag}, "
                            f"{shape}]", src, n_src, tuple(c_src))
        out["k1"].append(case)
        if is_se3:
            case, mom = k2_case(f"moments_batched[{tag}, {shape}]", src,
                                n_src, (thr[:, 2], thr[:, 1], thr[:, 0]))
            out["k2"].append(case)
            out["k3"].append(k3_case(f"axis_sums_batched[{tag}, {shape}]",
                                     src, n_src, thr[:, 0], mom))
            del mom
        del thr
        out["k1"].append(k1_case(
            f"neighborhood_thresholds_batched[{tag}, target, {bsz} x "
            f"{tgt.shape[1]}]", tgt, n_tgt, tuple(c_tgt))[0])
        del src, tgt
        torch.cuda.empty_cache()
        ms, pre = match_state(batch, cfg, alg)
        false_b = torch.zeros(bsz, dtype=torch.bool, device=dev)
        eye = torch.eye(4, device=dev).repeat(bsz, 1, 1)
        near = near_gt_pose(batch, pre, dev)
        shape = (f"{bsz} x {ms.feat16.shape[1]} -> "
                 f"{ms.targets.payload.shape[1]}")
        # the first call (SE(3) phase from the identity; the icp driver
        # starts in the R3 phase), then near the answer in the R3 phase
        start = false_b if is_se3 else ~false_b
        W, phase, _ = loop_inputs(ms, cfg, start, false_b, eye)
        out["k4"].append(k4_case(f"nn_match_affine[{tag}, {shape}]", ms,
                                 W, phase))
        if is_se3:
            W, phase, _ = loop_inputs(ms, cfg, ~false_b, false_b, near)
            name = f"nn_match_affine[{tag}, {shape}, R3 phase]"
            out["k4"].append(k4_case(name, ms, W, phase))
            out["k4"][-1].update(k4_r3_bits(name, ms, W, phase))
        for switched, ph in (((false_b, "SE(3)"), (~false_b, "R3"))
                             if is_se3 else ((~false_b, "R3"),)):
            W, phase, pf = loop_inputs(ms, cfg, switched, false_b, near)
            _, matched_T = cuda_knn.nn_match_affine(ms.feat16, W,
                                                    ms.targets, phase)
            out["k5"].append(k5_case(
                f"loop_epilogue_batched[{tag}, {shape}, {ph} phase, "
                f"overlap {cfg.estimated_overlap}]", ms, cfg, matched_T,
                pf))
        del ms, pre
        torch.cuda.empty_cache()
    return out


class SetupSplit:
    """Host time of each setup kernel wrapper inside one setup call:
    the wrappers are wrapped (within the ``with`` block only) so that
    each call is bracketed by synchronizations."""

    NAMES = (("cuda_moments", "neighborhood_thresholds_batched"),
             ("cuda_moments", "moments_raw"),
             ("cuda_moments", "axis_sums_aux"),
             ("cuda_frames", "frame_inputs"),
             ("cuda_frames", "ball_normals"),
             ("cuda_frames", "frame_assembly"))

    def __enter__(self):
        from se3_icp_tpu_torch.ops import cuda_frames, cuda_moments
        mods = dict(cuda_moments=cuda_moments, cuda_frames=cuda_frames)
        self.orig = {}
        self.seconds = {name: 0.0 for _, name in self.NAMES}
        for mod, name in self.NAMES:
            fn = self.orig[(mods[mod], name)] = getattr(mods[mod], name)

            def timed(*a, _fn=fn, _name=name, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = _fn(*a, **kw)
                torch.cuda.synchronize()
                self.seconds[_name] += time.perf_counter() - t0
                return out
            setattr(mods[mod], name, timed)
        return self

    def __exit__(self, *exc):
        for (mod, name), fn in self.orig.items():
            setattr(mod, name, fn)


def phases_line(problems):
    """Where one main-path call spends its time: the same batch through
    setup and loop separately, each ended by a synchronize.  Setup is
    split into the thresholds (K1), the moments and axis sums (K2, K3)
    and the glue around them; the exact route's setup is timed beside
    it."""
    from se3_icp_tpu_torch.models import registration as reg
    from se3_icp_tpu_torch.ops import knn
    from se3_icp_tpu_torch.parallel import pairs
    from se3_icp_tpu_torch.utils.config import GOLDEN

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    pair_list = [(p.source, p.target) for p in problems]
    packed, _ = timed(lambda: pairs.pack_pairs(pair_list))
    dev, upload_s = timed(lambda: [torch.as_tensor(a, device="cuda")
                                   for a in packed])
    src, n_src, tgt, n_tgt = dev
    # the engine's own arguments: the traced floats as a card vector
    # and the static config
    h, cfg = hyper_on(GOLDEN), reg.static_cfg(GOLDEN)
    with torch.no_grad():
        (ms, pre), setup_s = timed(lambda: reg.setup(
            src, n_src, tgt, n_tgt, cfg, "se3", "pt2pl", h))
        with SetupSplit() as split:
            _, split_s = timed(lambda: reg.setup(
                src, n_src, tgt, n_tgt, cfg, "se3", "pt2pl", h))
        _, exact_s = timed(lambda: reg.setup(
            src, n_src, tgt, n_tgt, cfg, "se3", "pt2pl", h, exact_knn=True))
        src_c, tgt_c, _ = reg.preprocess(src, n_src, tgt, n_tgt, cfg, True,
                                         h)
        _, knn_s = timed(lambda: (knn.knn_self(src_c, 91, n_src),
                                  knn.knn_self(tgt_c, 91, n_tgt)))
        stats = {}
        _, loop_s = timed(lambda: reg.run_loop(ms, pre.scaling, cfg, "se3",
                                               h, stats=stats))
    sec = split.seconds
    kernels_s = sum(sec.values())
    # the captured route, as register_pairs runs it (medians of 7): both
    # sides packed max-padded into pinned buffers and uploaded, memo off
    # (host time, then to the end of the copies); the dispatch (copies
    # into the program's buffers, the replay, the output clones: host
    # time, then to the end of the replay on the card); the one fetch
    def median_split(fn):
        host, done = [], []
        for _ in range(7):
            pairs._cloud_cache.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            host.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
            done.append(time.perf_counter() - t0)
        return out, statistics.median(host), statistics.median(done)

    sides = ([s for s, _ in pair_list], [t for _, t in pair_list])
    (s_dev, t_dev), up_host, up_done = median_split(lambda: [
        pairs._device_clouds(side, np.float32, "cuda") for side in sides])
    dispatched = []
    _, disp_host, disp_done = median_split(lambda: dispatched.append(
        pairs._dispatch_batch(*s_dev, *t_dev, GOLDEN, "se3_pt2pl")))
    for d in dispatched:
        d.settle()
    _, fetch_s, _ = median_split(lambda: pairs.PendingBatch(
        pairs._dispatch_batch(*s_dev, *t_dev, GOLDEN, "se3_pt2pl"),
        N_PAIRS).result())
    pack_s = statistics.median(
        timed(lambda: pairs.pack_pairs(pair_list))[1] for _ in range(7))
    program_split = dict(pack_upload_host_seconds=up_host,
                         pack_upload_seconds=up_done,
                         dispatch_host_seconds=disp_host,
                         dispatch_to_done_seconds=disp_done,
                         dispatch_and_fetch_seconds=fetch_s)
    emit("phases", pairs=len(problems), host_pack_seconds=pack_s,
         program_split=program_split,
         upload_seconds=upload_s, setup_seconds=setup_s,
         setup_split=dict(
             seconds=split_s,
             thresholds_seconds=sec["neighborhood_thresholds_batched"],
             moments_axis_seconds=sec["moments_raw"] + sec["axis_sums_aux"],
             glue_kernels_seconds=(sec["frame_inputs"] + sec["ball_normals"]
                                   + sec["frame_assembly"]),
             glue_seconds=split_s - kernels_s),
         setup_exact_seconds=exact_s, setup_exact_knn_seconds=knn_s,
         loop_seconds=loop_s, loop_steps=stats["loop_steps"],
         loop_ms_per_step=1e3 * loop_s / stats["loop_steps"])


def device_busy_ms(prof) -> float:
    """The union of the device kernels' intervals in a profile, ms."""
    from torch.autograd import DeviceType
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3


def profile_line(call, phase="profile", emit_line=True):
    """Device time of one ``call()`` by kernel name (torch.profiler),
    the ten largest, the call's wall time and the device's idle share
    of it (1 - the union of the kernels' intervals over the wall time,
    both under the profiler); returns the line's fields."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device kernels only: an operator's row repeats its kernels' time
    rows = sorted(((e.device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)
    total = sum(r[0] for r in rows)
    own = {tag: dict(ms=sum(r[0] for r in rows if tag in r[2]) / 1e3,
                     calls=sum(r[1] for r in rows if tag in r[2]))
           for tag in ("thresholds_kernel", "moments_kernel", "axis_kernel",
                       "match_affine_kernel", "epilogue_kernel", "nn_kernel",
                       "nn_tiled_kernel", "set_if_kernel",
                       "frame_inputs_kernel", "frame_assembly_kernel",
                       "step_update_kernel", "prep_kernel")}
    busy = device_busy_ms(prof)
    line = dict(device_ms_total=total / 1e3, device_busy_ms=busy,
                wall_ms_profiled=1e3 * wall,
                idle_share=1.0 - busy / (1e3 * wall),
                device_kernel_launches=sum(r[1] for r in rows),
                hand_written=own,
                top=[dict(ms=r[0] / 1e3, calls=r[1], name=r[2][:80])
                     for r in rows[:10]])
    if emit_line:
        emit(phase, **line)
    return line


class EagerLoop:
    """Within the block every registration takes the eager polled loop
    (``registration.loop_route`` answers "eager"): the captured
    program's reference, bit for bit."""

    def __enter__(self):
        from se3_icp_tpu_torch.models import registration as reg
        self.reg, self.orig = reg, reg.loop_route
        reg.loop_route = lambda *a, **kw: "eager"
        return self

    def __exit__(self, *exc):
        self.reg.loop_route = self.orig


def same_results(a, b) -> bool:
    """Two RegistrationResult lists: the same iteration counts and the
    same transform bits, pair by pair."""
    return len(a) == len(b) and all(
        x.num_iterations == y.num_iterations
        and x.num_pure_se3_iterations == y.num_pure_se3_iterations
        and np.array_equal(x.transformation, y.transformation)
        for x, y in zip(a, b))


# what each path's captured run showed: filled by the phases, printed
# by ``program_phase``
PROGRAM_HOLDS = []


def hold_against_eager(path, call, results, stats, route="graph"):
    """``call()`` again under ``EagerLoop``: its results must be the
    captured run's ``results`` bit for bit (any difference fails); the
    eager call's wall time is recorded."""
    eager_stats = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with EagerLoop():
        ref = call(eager_stats)
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    same = same_results(results, ref)
    check(same, f"{path}: the captured program's results differ from the "
          "eager loop's")
    if route == "graph":
        check(stats["loop_steps"] == eager_stats["loop_steps"]
              and stats["host_syncs"] == 0,
              f"{path}: {stats} on the captured program, "
              f"{eager_stats} eager")
    PROGRAM_HOLDS.append(dict(
        path=path, route=route, same_bits=same,
        loop_steps=stats["loop_steps"], host_syncs=stats["host_syncs"],
        eager_loop_steps=eager_stats["loop_steps"],
        eager_host_syncs=eager_stats["host_syncs"], eager_seconds=eager_s))


def zero_launches() -> None:
    """Every wrapper's launch count on the card set to 0 (in stream
    order: after the work queued so far)."""
    from se3_icp_tpu_torch.ops import _build
    _build.zero_launches()


def read_launches() -> dict:
    """The wrappers' launch counts, read back from the card: each is
    added to beside its kernel's launch, inside a captured graph too."""
    from se3_icp_tpu_torch.ops import _build
    return _build.launches()


def check_glue_launches(what, launches, steps):
    """The glue kernels went with their neighbours: G1 once after each
    K2 launch (its sums' frame inputs, normals or covariances), G2 once
    after each K3 launch (the frames), G3 ``steps`` times (once a loop
    step; 0 on the Anderson route, whose step is torch glue)."""
    for name, n in (("frame_inputs", launches["moments_batched"]),
                    ("frame_assembly", launches["axis_sums_batched"]),
                    ("step_update", steps)):
        check(launches[name] == n,
              f"{what} launched {name} {launches[name]} times, not {n}")


def check_launches(what, launches, loop_steps, setup, prep=1):
    """The loop kernels launch once per loop step (K4, K5, G3); the setup
    kernels ``setup`` = (K1, K2, K3) times, as the count sets give, G1,
    G2 with K2, K3, and G4 ``prep`` times (once a registration call of
    an SE(3) mode: its centring and scaling)."""
    check(launches["center_scale"] == prep,
          f"{what} launched center_scale {launches['center_scale']} times, "
          f"not {prep}")
    for name in ("nn_match_affine", "loop_epilogue_batched", "step_update"):
        check(launches[name] == loop_steps > 0,
              f"{what} launched {name} {launches[name]} times in "
              f"{loop_steps} loop steps")
    want = dict(zip(("neighborhood_thresholds_batched", "moments_batched",
                     "axis_sums_batched"), setup))
    for name, n in want.items():
        check(launches[name] == n,
              f"{what} launched {name} {launches[name]} times, not {n}")
    check_glue_launches(what, launches, loop_steps)


def main_path_run(pair_list, problems, exact_knn):
    """One timed 64-pair call of the main path, gated, with its launch
    counts: (line fields, launches)."""
    from se3_icp_tpu_torch.parallel import pairs
    from se3_icp_tpu_torch.utils.config import GOLDEN
    zero_launches()
    stats = {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    results = pairs.register_pairs(pair_list, "se3_pt2pl", GOLDEN,
                                   stats=stats, exact_knn=exact_knn)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    route = "exact_knn" if exact_knn else "threshold"
    rot, tra = gate(problems, results, f"main path se3_pt2pl ({route})")
    iters = [r.num_iterations for r in results]
    check(stats["loop_steps"] >= max(iters), "loop steps < iterations")
    # threshold route: K1 once per cloud; K2 once per cloud (the target's
    # normals ride its TOLDI pass); K3 once per cloud
    check_launches(f"main path ({route})", launches, stats["loop_steps"],
                   (0, 0, 0) if exact_knn else (2, 2, 2))
    return dict(route=route, algorithm="se3_pt2pl", config="GOLDEN",
                pairs=N_PAIRS, points=4167, bucket=4608, seconds=wall,
                pairs_per_s=N_PAIRS / wall,
                mean_iterations=float(np.mean(iters)),
                max_iterations=max(iters), loop_steps=stats["loop_steps"],
                host_syncs=stats["host_syncs"], launches=launches,
                worst_rot_deg=rot, worst_trans=tra,
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9), \
        launches, results


# K1/K2/K3 launches of one call per algorithm, from its count sets
ALGORITHM_SETUP_LAUNCHES = {
    "se3_gicp": (2, 4, 2),          # frames, then the GICP normals' pass
    "se3_gicp_with_cf": (2, 4, 2),
    "se3_pt2pt": (2, 2, 2),
    "se3_pure_pt2pt": (2, 2, 2),
    "pt2pl": (1, 1, 0),             # target normals only, no frames
    "pt2pt": (0, 0, 0),             # no neighbourhoods at all
}


def main_path_phase():
    """The port's main path through its public entry points, on the
    threshold route (the default) and on the exact route."""
    from se3_icp_tpu_torch.datasets.fixtures import NOISY, SMALL_POSE
    from se3_icp_tpu_torch.parallel import pairs
    from se3_icp_tpu_torch.utils.config import GOLDEN, LOUNGE, parse_algorithm
    PURE = GOLDEN.replace(alpha_rot=0.1, max_num_se3_iterations=60)

    problems = golden_pairs(N_PAIRS)
    pair_list = [(p.source, p.target) for p in problems]
    check(all(len(p.source) == 4167 for p in problems), "cloud size")
    # warm-up calls at the counted calls' shapes, not counted: the
    # libraries' handles and each route's captured program
    from se3_icp_tpu_torch.models import program
    t0 = time.perf_counter()
    for exact in (False, True):
        pairs.register_pairs(pair_list, "se3_pt2pl", GOLDEN,
                             exact_knn=exact)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    capture_s = program.info()["capture_seconds"]

    line, launches, results = main_path_run(pair_list, problems,
                                            exact_knn=False)
    emit("main_path", warmup_seconds=warm_s,
         captures_seconds_in_warmup=capture_s, **line)
    hold_against_eager(
        "main path", lambda st: pairs.register_pairs(
            pair_list, "se3_pt2pl", GOLDEN, stats=st), results, line)
    line, _, exact_results = main_path_run(pair_list, problems,
                                           exact_knn=True)
    emit("main_path_exact", **line)
    hold_against_eager(
        "main path (exact_knn)", lambda st: pairs.register_pairs(
            pair_list, "se3_pt2pl", GOLDEN, stats=st, exact_knn=True),
        exact_results, line)

    phases_line(problems)
    replayed_launches_line(pair_list)

    # the card and the CPU route agree on a small input
    small = golden_pairs(2, n=600)
    small_list = [(p.source, p.target) for p in small]
    on_card = pairs.register_pairs(small_list, "se3_pt2pl", GOLDEN)
    on_cpu = pairs.register_pairs(small_list, "se3_pt2pl", GOLDEN,
                                  device="cpu")
    from se3_icp_tpu_torch.utils import metrics_host as mh
    for a, b in zip(on_card, on_cpu):
        check(a.num_iterations == b.num_iterations,
              "card and CPU plain route take different iteration counts")
        check(mh.angular_error_so3(a.transformation[:3, :3],
                                   b.transformation[:3, :3]) < 1e-3
              and mh.translation_error(a.transformation[:3, 3],
                                       b.transformation[:3, 3]) < 1e-4,
              "card and CPU plain route disagree")
    emit("card_vs_cpu", route="threshold", pairs=2, points=600,
         iterations=[r.num_iterations for r in on_card], agree=True)

    # the other algorithms, smaller batches, same entry point and gate;
    # the pt2pt variants on the captured program too (``solve.kabsch3``)
    for alg, cfg, cfg_name, kw in (
            ("se3_gicp", GOLDEN, "GOLDEN", {}),
            ("se3_gicp_with_cf", LOUNGE, "LOUNGE", NOISY),
            ("se3_pt2pt", GOLDEN, "GOLDEN", {}),
            ("se3_pure_pt2pt", PURE, "GOLDEN, alpha_rot 0.1, 60 SE(3) "
             "iterations", {}),
            ("pt2pt", GOLDEN, "GOLDEN", SMALL_POSE),
            ("pt2pl", GOLDEN, "GOLDEN", SMALL_POSE)):
        probs = golden_pairs(SMALL_BATCH, **kw)
        plist = [(p.source, p.target) for p in probs]
        walls = []
        for _ in range(2):      # the first call pays one-off library set-up
            st = {}             # and the capture of its program
            zero_launches()
            t0 = time.perf_counter()
            res = pairs.register_pairs(plist, alg, cfg, stats=st)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        alg_launches = read_launches()
        from se3_icp_tpu_torch.models import registration as reg
        route = reg.loop_route("cuda", *parse_algorithm(alg))
        hold_against_eager(
            alg, lambda st, _a=alg, _c=cfg, _l=plist: pairs.register_pairs(
                _l, _a, _c, stats=st), res, st, route)
        rot, tra = gate(probs, res, alg)
        iters = [r.num_iterations for r in res]
        check(st["loop_steps"] >= max(iters), f"{alg}: loop steps")
        check_launches(alg, alg_launches, st["loop_steps"],
                       ALGORITHM_SETUP_LAUNCHES[alg],
                       prep=int(parse_algorithm(alg)[0] != "icp"))
        emit("algorithm_run", algorithm=alg, config=cfg_name, pairs=SMALL_BATCH,
             loop_route=route, first_call_seconds=walls[0], seconds=walls[1],
             mean_iterations=float(np.mean(iters)), max_iterations=max(iters),
             loop_steps=st["loop_steps"], host_syncs=st["host_syncs"],
             launches=alg_launches, worst_rot_deg=rot, worst_trans=tra)
    return launches, results


PROGRAM_PROFILE = {}


def replayed_launches_line(pair_list):
    """One replayed main-path call under the profiler: device time, the
    device's idle share, and its launches counted twice -- on the card
    by the wrappers' counters (K4 and K5 once a device-counted loop
    step, K1-K3 twice each) and by the profiler in the same run, which
    must see the same launches and the conditional node's predicate
    kernel once a group of steps the loop may run.  The counters must
    agree on every try; the profiler drops a record now and then, so a
    try whose profile saw fewer launches (never more) is made again, at
    most three in all."""
    from se3_icp_tpu_torch.models import registration as reg
    from se3_icp_tpu_torch.parallel import pairs
    from se3_icp_tpu_torch.utils.config import GOLDEN
    groups = -(-(max(GOLDEN.max_num_iterations,
                     GOLDEN.max_num_se3_iterations) + 1) // reg._POLL_EVERY)
    tag = dict(match_affine_kernel="nn_match_affine",
               epilogue_kernel="loop_epilogue_batched",
               thresholds_kernel="neighborhood_thresholds_batched",
               moments_kernel="moments_batched",
               axis_kernel="axis_sums_batched",
               frame_inputs_kernel="frame_inputs",
               frame_assembly_kernel="frame_assembly",
               step_update_kernel="step_update",
               prep_kernel="center_scale")
    tries = []
    for _ in range(3):
        st = {}
        zero_launches()
        line = profile_line(lambda: pairs.register_pairs(
            pair_list, "se3_pt2pl", GOLDEN, stats=st), emit_line=False)
        counted = read_launches()
        check_launches("profiled main path", counted, st["loop_steps"],
                       (2, 2, 2))
        own = line["hand_written"]
        got = {k: own[k]["calls"] for k in (*tag, "set_if_kernel")}
        want = {k: counted[name] for k, name in tag.items()}
        want["set_if_kernel"] = groups
        tries.append(dict(profiled=got, counted=want))
        if got == want:
            break
        check(all(got[k] <= want[k] for k in want),
              f"the profiler saw launches {got} that the counters "
              f"{want} did not")
    check(got == want, f"profiled launches of a replayed call {tries} "
          "differ from the device-counted ones")
    PROGRAM_PROFILE.update(tries=tries, device_loop_steps=st["loop_steps"],
                           host_syncs=st["host_syncs"])
    before = glue_as_torch_profile(pair_list)
    emit("profile", route="graph", device_loop_steps=st["loop_steps"],
         host_syncs=st["host_syncs"], launches=counted, launches_agree=True,
         profiled_tries=len(tries), glue_as_torch_ops=before,
         device_ms_vs_torch_glue=line["device_ms_total"]
         / before["device_ms_total"],
         launches_vs_torch_glue=line["device_kernel_launches"]
         / before["device_kernel_launches"], **line)


class GlueAsTorch:
    """Within the block the main path runs its glue as torch ops, as the
    port did before G1-G4: G1's, G2's and G4's plain versions (G1's and
    G2's the same torch code, the same bits; G4's its fixed order as
    elementwise slabs, where the port before it took torch's ``sum`` and
    ``linalg.norm``) and ``registration.torch_glue_loop_step`` (the
    operands by ``loop_inputs``, the 6x6 by ``torch.linalg.solve_ex``,
    ``T_i @ T``, ``linalg.norm``).  The program cache is cleared on entry
    and exit, so neither route replays the other's capture."""

    NAMES = (("cuda_frames", "frame_inputs"), ("cuda_frames", "ball_normals"),
             ("cuda_frames", "frame_assembly"), ("cuda_prep", "center_scale"))

    def __enter__(self):
        from se3_icp_tpu_torch.models import program, registration as reg
        from se3_icp_tpu_torch.ops import cuda_frames, cuda_prep
        self.mods = dict(cuda_frames=cuda_frames, cuda_prep=cuda_prep)
        self.reg, self.program = reg, program
        self.orig = {(m, n): getattr(self.mods[m], n) for m, n in self.NAMES}
        self.step = reg.loop_step
        program.clear()
        for m, n in self.NAMES:
            setattr(self.mods[m], n, getattr(self.mods[m], n + "_plain"))
        reg.loop_step = reg.torch_glue_loop_step
        return self

    def __exit__(self, *exc):
        for (m, n), fn in self.orig.items():
            setattr(self.mods[m], n, fn)
        self.reg.loop_step = self.step
        self.program.clear()


def glue_as_torch_profile(pair_list):
    """The main path's replayed call (captured, as ``register_pairs``
    runs it) with its glue as torch ops (``GlueAsTorch``), under the
    profiler: the device time and launches the glue kernels took away."""
    from se3_icp_tpu_torch.parallel import pairs
    from se3_icp_tpu_torch.utils.config import GOLDEN
    with GlueAsTorch():
        pairs.register_pairs(pair_list, "se3_pt2pl", GOLDEN)   # capture
        st = {}
        line = profile_line(lambda: pairs.register_pairs(
            pair_list, "se3_pt2pl", GOLDEN, stats=st), emit_line=False)
    return dict({k: line[k] for k in (
        "device_ms_total", "device_busy_ms", "wall_ms_profiled",
        "idle_share", "device_kernel_launches")},
        device_loop_steps=st["loop_steps"], top=line["top"][:5])


def serving_phase():
    """Scan-to-model serving: 4 consecutive 64-pair batches whose target
    side is one list of arrays (3 memo hits a run) and whose sources are
    fresh arrays each batch (the golden sources with 1e-3 of noise),
    through ``register_pairs_async`` with one batch in flight, held bit
    for bit against ``register_pairs`` one batch at a time; wall times
    of both, and the device's idle share of each under the profiler."""
    from se3_icp_tpu_torch.parallel import pairs
    from se3_icp_tpu_torch.utils.config import GOLDEN
    problems = golden_pairs(N_PAIRS)
    targets = [p.target for p in problems]
    rng = np.random.default_rng(9)

    def fresh_sources():
        return [[p.source + rng.normal(scale=1e-3, size=p.source.shape)
                 for p in problems] for _ in range(4)]

    def sequential(srcs):
        return [pairs.register_pairs(list(zip(s, targets)), "se3_pt2pl",
                                     GOLDEN) for s in srcs]

    def pipelined(srcs):
        out, pending = [], None
        for s in srcs:
            nxt = pairs.register_pairs_async(list(zip(s, targets)),
                                             "se3_pt2pl", GOLDEN)
            if pending is not None:
                out.append(pending.result())
            pending = nxt
        out.append(pending.result())
        return out

    def run(fn, srcs):
        pairs._cloud_cache.clear()
        before = dict(pairs.cloud_cache_counts)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn(srcs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        memo = {k: pairs.cloud_cache_counts[k] - before[k] for k in before}
        return res, wall, memo

    srcs = fresh_sources()
    seq, seq_s, seq_memo = run(sequential, srcs)
    pip, pip_s, pip_memo = run(pipelined, srcs)
    same = all(same_results(a, b) for a, b in zip(pip, seq))
    check(same, "serving: pipelined batches differ from sequential ones")
    check(pip_memo == {"hits": 3, "uploads": 5} == seq_memo,
          f"serving: memo {pip_memo} pipelined, {seq_memo} sequential; "
          "want 3 hits and 5 uploads (1 target side, 4 source sides)")
    check(all(np.isfinite(r.transformation).all() for b in pip for r in b),
          "serving: a transform is not finite")
    idle = {}
    for name, fn in (("sequential", sequential), ("pipelined", pipelined)):
        line = profile_line(lambda _f=fn: run(_f, fresh_sources()),
                            emit_line=False)
        idle[name] = dict(idle_share=line["idle_share"],
                          device_busy_ms=line["device_busy_ms"],
                          wall_ms_profiled=line["wall_ms_profiled"])
    emit("serving", batches=4, pairs_per_batch=N_PAIRS, in_flight=1,
         algorithm="se3_pt2pl", config="GOLDEN",
         sequential_seconds=seq_s, pipelined_seconds=pip_s,
         sequential_pairs_per_s=4 * N_PAIRS / seq_s,
         pipelined_pairs_per_s=4 * N_PAIRS / pip_s,
         memo_pipelined=pip_memo, memo_sequential=seq_memo,
         same_bits_as_sequential=same, profiled=idle)


def skipped_tail():
    """What a skipped group of loop steps costs: the main path's 64
    pairs with every pair done after its second step (mse and the
    switch threshold 1e9), once with the GOLDEN caps (151 steps: one
    group runs, 37 are skipped) and once with caps of 3 (4 steps: the
    one group, none skipped); CUDA events around each call (after a
    warm-up that captures its program), medians of 15."""
    from se3_icp_tpu_torch.models import registration as reg
    from se3_icp_tpu_torch.parallel import pairs
    from se3_icp_tpu_torch.utils.config import GOLDEN
    problems = golden_pairs(N_PAIRS)
    arrs = [torch.as_tensor(a, device="cuda") for a in pairs.pack_pairs(
        [(p.source, p.target) for p in problems])]
    quick = GOLDEN.replace(mse=1e9, mse_switch_error=1e9)
    out = {}
    for name, cfg in (("caps_150", quick),
                      ("caps_3", quick.replace(max_num_iterations=3,
                                               max_num_se3_iterations=3))):
        st = {}
        ms = time_ms(lambda _c=cfg: reg.register_arrays(
            *arrs, _c, "se3", "pt2pl", stats=st), reps=15)
        groups = -(-(max(cfg.max_num_iterations,
                         cfg.max_num_se3_iterations) + 1) // reg._POLL_EVERY)
        out[name] = dict(ms=ms, groups=groups,
                         loop_steps_a_call=st["loop_steps"] // 16)
    skipped = out["caps_150"]["groups"] - out["caps_3"]["groups"]
    check(out["caps_150"]["loop_steps_a_call"] == reg._POLL_EVERY
          == out["caps_3"]["loop_steps_a_call"], f"skipped tail: {out}")
    return dict(out, skipped_groups=skipped,
                ms_per_skipped_group=(out["caps_150"]["ms"]
                                      - out["caps_3"]["ms"]) / skipped)


def program_phase():
    """The captured program's line: the cache (the bytes of its shared
    pools, each entry with what its capture added to them, before the
    skipped tail's two programs join it), the captures, the form built,
    every path's hold against the eager loop, and the cost of the
    skipped tail."""
    from se3_icp_tpu_torch.models import program
    check(PROGRAM_HOLDS and all(h["same_bits"] for h in PROGRAM_HOLDS),
          "a path's captured results differ from the eager loop's")
    cache = program.info()
    tail = skipped_tail()
    emit("program", **cache, holds=PROGRAM_HOLDS,
         replayed_launches=PROGRAM_PROFILE, skipped_tail=tail,
         memory_reserved_gb=torch.cuda.memory_reserved() / 1e9,
         max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)


def cli_phase():
    from se3_icp_tpu_torch.utils import ply
    prob = golden_pairs(1)[0]
    with tempfile.TemporaryDirectory() as tmp:
        src, tgt = os.path.join(tmp, "source.ply"), os.path.join(tmp,
                                                                 "target.ply")
        ply.write_ply(src, prob.source)
        ply.write_ply(tgt, prob.target)
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "se3_icp_tpu_torch", "run", "se3_pt2pl",
             src, tgt], cwd=ROOT, capture_output=True, text=True,
            timeout=600)
        wall = time.perf_counter() - t0
    check(out.returncode == 0, f"CLI exited {out.returncode}: {out.stderr}")
    lines = out.stdout.strip().splitlines()
    at = lines.index("Estimated transformation = ")
    T = np.asarray([[float(v) for v in ln.split()]
                    for ln in lines[at + 1:at + 5]])
    rot, tra = gate([prob], [types.SimpleNamespace(transformation=T)],
                    "CLI run se3_pt2pl")
    emit("cli", seconds=wall, worst_rot_deg=rot, worst_trans=tra)


# --------------------------------------------------------------------
# The paths of the 1-NN kernels K6-K9 (multistart, FGR, metrics, the
# public ops) and the kernels against their plain versions.

def nn_check(name, q, t, n, idx_k, d2_k, idx_p, d2_p, n_q=None):
    """A 1-NN result of the kernel against the plain version's on the
    same inputs: q [B,Nq,D], t [B,Nt,D] the searched targets, n [B];
    ``n_q`` [B]: compare only the first n_q queries (FGR's padded query
    rows sit at 1e6, equally far from every target)."""
    check(bool(torch.isfinite(d2_k).all()), f"{name}: d2 not finite")
    check(bool((idx_k >= 0).all() and (idx_k < n[:, None]).all()),
          f"{name}: an index outside the valid targets")
    bsz, nt = t.shape[0], t.shape[1]
    col = torch.arange(nt, device=t.device)
    tn = torch.where(col[None] < n[:, None], (t * t).sum(-1), 0.0)
    scale = (q * q).sum(-1) + tn.amax(-1, keepdim=True) + 1.0   # [B,Nq]
    rows = torch.ones_like(idx_k, dtype=torch.bool)
    if n_q is not None:
        rows = torch.arange(q.shape[1], device=q.device)[None] < n_q[:, None]
    rel = float(torch.where(rows, (d2_k - d2_p).abs() / scale, 0.0).max())
    check(rel <= NN_D2_REL,
          f"{name}: d2 differs by {rel:.2e} of |q|^2+|t|^2 > {NN_D2_REL}")
    differ = (idx_k != idx_p) & rows
    share = float(differ.sum()) / float(rows.sum())
    check(share <= NN_FLIP_SHARE,
          f"{name}: {share:.4%} of rows pick another target than the plain "
          f"version (limit {NN_FLIP_SHARE:.0%})")
    gap = 0.0
    if bool(differ.any()):
        b, i = differ.nonzero(as_tuple=True)
        qd = q[b, i].double()
        dk = ((qd - t[b, idx_k[b, i].long()].double()) ** 2).sum(-1)
        dp = ((qd - t[b, idx_p[b, i].long()].double()) ** 2).sum(-1)
        gap = float(((dk - dp).abs() / scale[b, i].double()).max())
        check(gap <= 2 * NN_D2_REL,
              f"{name}: a differing index is no near-tie ({gap:.2e})")
    return dict(max_abs_err=float((d2_k - d2_p).abs().max()),
                max_rel_err=rel, index_flips=int(differ.sum()),
                flip_share=share, flip_gap_rel=gap,
                tolerance=dict(d2_rel=NN_D2_REL, flip_share=NN_FLIP_SHARE))


def nn_bound(q, t, n, payload_width=0, tn_read=False):
    """(2D+2) operations per (query, valid target); each input read once,
    each output written once."""
    bsz, nq, d = q.shape
    nt = t.shape[1]
    ops = (2 * d + 2) * nq * float(n.double().sum())
    nbytes = 4 * (bsz * nq * d + bsz * nt * d + bsz + 2 * bsz * nq
                  + payload_width * bsz * (nt + nq)
                  + (bsz * nt if tn_read else 0))
    return bound(ops, nbytes)


def nn_argmin_case(name, q, t, n, unbatched=False, with_cdist=False,
                   n_q=None):
    """K6 (the tiled search) against its plain version and, bit for bit,
    against the one-query-a-thread search (K9's entry point at S = 1 on
    the same batch); or K9 on one cloud against its plain version and
    its chosen target split against the unsplit search (S = 1), bit for
    bit."""
    from se3_icp_tpu_torch.ops import cuda_nn
    if unbatched:
        wrapper = cuda_nn.nn_argmin_unbatched
        fn = lambda split=None: [x[None] for x in wrapper(
            q[0], t[0], n[0], split=split)]
        plain = lambda: cuda_nn.nn_argmin_unbatched_plain(q[0], t[0], n[0])
        out_k, out_p = fn(), [x[None] for x in plain()]
        torch.cuda.synchronize()
        split = cuda_nn.split_size(q.shape[0], q.shape[1], q.device)
        check(same_bits(tuple(out_k), tuple(fn(split=1))),
              f"{name}: S = {split} gives other bits than the unsplit "
              "search")
        route = dict(split=split, same_bits_as_split_1=True)
        tag = "nn_kernel"
    else:
        fn = lambda: cuda_nn.nn_argmin_batched(q, t, n)
        plain = lambda: cuda_nn.nn_argmin_batched_plain(q, t, n)
        out_k, out_p = fn(), plain()
        torch.cuda.synchronize()
        check(same_bits(tuple(out_k),
                        cuda_nn.untiled_argmin(q, t, n, split=1)),
              f"{name}: the tiled search gives other bits than the "
              "untiled one")
        route = dict(same_bits_as_untiled=True)
        tag = "nn_tiled_kernel"
    case = dict(name=name, **nn_check(name, q, t, n, *out_k, *out_p, n_q),
                **route, ms=time_ms(fn), kernel_alone_ms=alone_ms(fn, tag),
                plain_ms=time_ms(plain, reps=3),
                **nn_bound(q, t, n), library_ms=None,
                shape=dict(B=q.shape[0], Nq=q.shape[1], Nt=t.shape[1],
                           D=q.shape[2]),
                n_targets=[int(n.min()), int(n.max())])
    if unbatched:
        # one cloud: torch.cdist + min over its valid targets computes
        # the same function
        tv = t[0, :int(n[0])]
        case["library_ms"] = time_ms(
            lambda: torch.cdist(q[0], tv).min(-1), reps=3)
        case["library"] = "torch.cdist + min over the valid targets"
    if with_cdist:
        # context, not a yardstick: torch.cdist + min over all targets
        # (no valid-count mask), the nearest library call
        case["cdist_min_ms"] = time_ms(
            lambda: torch.cdist(q, t).amin(-1), reps=3)
    return case


def cdist_min_gather_ms(q, t, payload):
    """torch.cdist + min + gather of the payload rows over all target
    rows (no valid-count mask): the library calls nearest to K7/K8."""
    def run():
        _, idx = torch.cdist(q, t).min(-1)
        return torch.gather(payload, 1, idx[..., None].expand(
            -1, -1, payload.shape[2]))
    return time_ms(run, reps=3)


def nn_match_case(name, q, t, payload, n):
    """K7 (the tiled search) against its plain version and, bit for bit,
    against the one-query-a-thread search (K9's entry point at S = 1):
    the matched rows are copies of the indexed payload rows."""
    from se3_icp_tpu_torch.ops import cuda_nn
    args = (q, t, payload, n)
    fn = lambda: cuda_nn.nn_match_batched(*args)
    idx, d2, m = fn()
    torch.cuda.synchronize()
    idx_p, d2_p, _ = cuda_nn.nn_match_batched_plain(*args)
    case = nn_check(name, q, t, n, idx, d2, idx_p, d2_p)
    check(same_bits((idx, d2), cuda_nn.untiled_argmin(q, t, n, split=1)),
          f"{name}: the tiled search gives other bits than the untiled one")
    want = torch.gather(payload, 1, idx.long()[..., None].expand(
        -1, -1, payload.shape[2]))
    check(bool((m == want).all()), f"{name}: matched rows are not the "
          "payload rows of the returned indices")
    return dict(name=name, **case, payload_bit_equal=True,
                same_bits_as_untiled=True, ms=time_ms(fn),
                kernel_alone_ms=alone_ms(fn, "nn_tiled_kernel"),
                plain_ms=time_ms(lambda: cuda_nn.nn_match_batched_plain(
                    *args), reps=3),
                **nn_bound(q, t, n, payload.shape[2]),
                library_ms=cdist_min_gather_ms(q, t, payload),
                library="torch.cdist + min + gather over all target rows",
                shape=dict(B=q.shape[0], Nq=q.shape[1], Nt=t.shape[1],
                           D=q.shape[2], P=payload.shape[2]),
                n_targets=[int(n.min()), int(n.max())])


def nn_packed_case(name, q, targets, phase):
    """K8 (the tiled search on packed targets) against its plain version
    on the engine's own packed targets and, bit for bit, against the
    one-query-a-thread search on them at S = 1."""
    from se3_icp_tpu_torch.ops import cuda_nn
    fn = lambda: cuda_nn.nn_match_packed(q, targets, phase)
    idx, d2, m = fn()
    torch.cuda.synchronize()
    idx_p, d2_p, _ = cuda_nn.nn_match_packed_plain(q, targets, phase)
    ar = torch.arange(q.shape[0], device=q.device)
    t_sel = targets.emb[ar, (phase != 0).long()]
    case = nn_check(name, q, t_sel, targets.n, idx, d2, idx_p, d2_p)
    check(same_bits((idx, d2, m), cuda_nn.untiled_match_packed(
        q, targets, phase, split=1)),
          f"{name}: the tiled search gives other bits than the untiled one")
    want = torch.gather(targets.payload, 1, idx.long()[..., None].expand(
        -1, -1, targets.payload.shape[2]))
    check(bool((m == want).all()), f"{name}: matched rows are not the "
          "payload rows of the returned indices")
    return dict(name=name, **case, payload_bit_equal=True,
                same_bits_as_untiled=True, ms=time_ms(fn),
                kernel_alone_ms=alone_ms(fn, "nn_tiled_kernel"),
                plain_ms=time_ms(lambda: cuda_nn.nn_match_packed_plain(
                    q, targets, phase), reps=3),
                **nn_bound(q, t_sel, targets.n, targets.payload.shape[2],
                           tn_read=True),
                library_ms=cdist_min_gather_ms(q, t_sel, targets.payload),
                library="torch.cdist + min + gather over the phase's "
                        "target rows",
                shape=dict(B=q.shape[0], Nq=q.shape[1], Nt=t_sel.shape[1],
                           D=q.shape[2], P=targets.payload.shape[2]),
                phases=phase.tolist())


def moved_sources(problems, dev, tilt=(0.02, -0.015, 0.01)):
    """The packed sources under a pose a little off the ground truth (as
    multistart scores its candidates), and the packed targets."""
    from se3_icp_tpu_torch.datasets import fixtures
    from se3_icp_tpu_torch.parallel import pairs
    src, n_src, tgt, n_tgt = pairs.pack_pairs(
        [(p.source, p.target) for p in problems])
    q = np.zeros_like(src)
    for b, p in enumerate(problems):
        R = p.T_gt[:3, :3] @ fixtures.rot_3d(*tilt)
        q[b, :n_src[b]] = src[b, :n_src[b]] @ R.T + p.T_gt[:3, 3]
    t = lambda a: torch.as_tensor(a, device=dev)
    return t(q), t(tgt), t(n_tgt)


def embedding12(points, seed):
    """An engine-like 12-D embedding [B,N,12] = [3 R (column-major) |
    p] with a random frame R a point."""
    rng = np.random.default_rng(seed)
    bsz, n, _ = points.shape
    r, _ = np.linalg.qr(rng.normal(size=(bsz * n, 3, 3)))
    r = np.swapaxes(r, -1, -2).reshape(bsz, n, 9) * 3.0
    return torch.as_tensor(np.concatenate([r, points.cpu().numpy()], -1),
                           dtype=torch.float32, device=points.device)


def nn_kernels_phase(feats):
    """K6-K9 against their plain versions at the shapes of their paths:
    K6 at 64 x 4608 (D = 3: multistart scoring; D = 33: FGR's features
    ``feats``) and 8 x 15360; K9 at 4608 (D = 3) and 15360 (D = 12); K7
    at 64 x 4608, D = 12, P = 9 on padded targets; K8 on the engine's
    own packed targets with mixed phases at 64 x 4608 and 8 x 15360."""
    from se3_icp_tpu_torch.utils.config import GOLDEN
    dev = torch.device("cuda")
    problems = golden_pairs(N_PAIRS)
    q3, t3, n3 = moved_sources(problems, dev)
    k6 = [nn_argmin_case("nn_argmin_batched", q3, t3, n3, with_cdist=True)]
    fs, ft, n_t, n_s = feats
    k6.append(nn_argmin_case("nn_argmin_batched[D=33, FGR features]",
                             fs, ft, n_t, with_cdist=True, n_q=n_s))
    big = golden_pairs(SMALL_BATCH, n=15000)
    qb, tb, nb = moved_sources(big, dev)
    k6.append(nn_argmin_case("nn_argmin_batched[8 x 15360]", qb, tb, nb,
                             with_cdist=True))
    k9 = [nn_argmin_case("nn_argmin_unbatched", q3[:1], t3[:1], n3[:1],
                         unbatched=True)]
    k9.append(nn_argmin_case(
        "nn_argmin_unbatched[15360, D=12]", embedding12(qb[:1], 1),
        embedding12(tb[:1], 2), nb[:1], unbatched=True))
    del feats, fs, ft, qb, tb

    ms, pre = match_state(problems, GOLDEN, "se3_pt2pl")
    bsz = N_PAIRS
    false_b = torch.zeros(bsz, dtype=torch.bool, device=dev)
    near = near_gt_pose(problems, pre, dev)
    W, _, _ = loop_inputs(ms, GOLDEN, false_b, false_b, near)
    q12 = (ms.feat16 @ W)[..., :12].contiguous()
    k7 = [nn_match_case("nn_match_batched", q12,
                        ms.targets.emb[:, 0].contiguous(),
                        ms.targets.payload, ms.targets.n)]
    switched = torch.arange(bsz, device=dev) % 2 == 1
    W, phase, _ = loop_inputs(ms, GOLDEN, switched, false_b, near)
    q12 = (ms.feat16 @ W)[..., :12].contiguous()
    k8 = [nn_packed_case("nn_match_packed", q12, ms.targets,
                         phase[:, 0].contiguous())]
    del ms
    k8.append(nn_packed_case("nn_match_packed[8 x 15360]",
                             *packed_big(big, dev)))
    return k6, k7, k8, k9


def packed_big(problems, dev):
    """K8's inputs at 8 x 15360 as the engine packs them: queries near the
    answer, every other pair in the R3 phase -> (q, targets, phase)."""
    from se3_icp_tpu_torch.utils.config import GOLDEN
    ms, pre = match_state(problems, GOLDEN, "se3_pt2pl")
    bsz = len(problems)
    switched = torch.arange(bsz, device=dev) % 2 == 1
    W, phase, _ = loop_inputs(ms, GOLDEN, switched,
                              torch.zeros_like(switched),
                              near_gt_pose(problems, pre, dev))
    q12 = (ms.feat16 @ W)[..., :12].contiguous()
    return q12, ms.targets, phase[:, 0].contiguous()


def only_launched(what, launches, want):
    """The path launched exactly ``want`` = {wrapper: count} of the 1-NN
    kernels (the others: none)."""
    for name in ("nn_argmin_batched", "nn_argmin_unbatched",
                 "nn_match_batched", "nn_match_packed"):
        n = want.get(name, 0)
        check(launches[name] == n,
              f"{what} launched {name} {launches[name]} times, not {n}")


def multistart_phase(with_profile: bool = False):
    """The restart fleet through ``register_pairs_multistart``: 8 pairs
    of the golden shape under FLIPPED_POSE (out of a single start's
    reach), 8 starts each, one chunk of 64 flat registrations on the
    threshold route; every pair's kept start gated.  Then one pair on
    the card and on the CPU plain route at 600 points."""
    from se3_icp_tpu_torch.datasets.fixtures import FLIPPED_POSE
    from se3_icp_tpu_torch.models import multistart
    from se3_icp_tpu_torch.utils import metrics_host as mh
    from se3_icp_tpu_torch.utils.config import GOLDEN
    problems = golden_pairs(MS_PAIRS, **FLIPPED_POSE)
    pair_list = [(p.source, p.target) for p in problems]
    zero_launches()
    stats = {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = multistart.register_pairs_multistart(
        pair_list, "se3_pt2pl", GOLDEN, n_starts=MS_STARTS,
        pair_chunk=MS_PAIRS, stats=stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    rot, tra = gate(problems, [r.best for r in res], "multistart kept start")

    def eager_fleet(st):
        got = multistart.register_pairs_multistart(
            pair_list, "se3_pt2pl", GOLDEN, n_starts=MS_STARTS,
            pair_chunk=MS_PAIRS, stats=st)
        same = all(a.start_index == b.start_index
                   and np.array_equal(a.scores, b.scores)
                   for a, b in zip(got, res))
        check(same, "multistart: the captured program's kept starts or "
              "scores differ from the eager loop's")
        return [r.best for r in got]
    hold_against_eager("multistart", eager_fleet, [r.best for r in res],
                       stats)
    if with_profile:
        profile_line(lambda: multistart.register_pairs_multistart(
            pair_list, "se3_pt2pl", GOLDEN, n_starts=MS_STARTS,
            pair_chunk=MS_PAIRS), phase="profile_multistart")
    # setup K1-K3 once per cloud of the one engine call; K4, K5 per step;
    # one K6 launch scores the chunk's 64 candidates
    check_launches("multistart", launches, stats["loop_steps"], (2, 2, 2))
    only_launched("multistart", launches, {"nn_argmin_batched": 1})
    gaps = [float(np.sort(r.scores)[1] - np.sort(r.scores)[0]) for r in res]
    # the card and the CPU plain route keep the same start
    small = golden_pairs(1, n=600, **FLIPPED_POSE)
    sl = [(p.source, p.target) for p in small]
    on_card = multistart.register_pairs_multistart(sl, "se3_pt2pl", GOLDEN,
                                                   n_starts=MS_STARTS)[0]
    on_cpu = multistart.register_pairs_multistart(sl, "se3_pt2pl", GOLDEN,
                                                  n_starts=MS_STARTS,
                                                  device="cpu")[0]
    # several starts may share the right basin: compare the kept
    # transforms and scores, not the index
    check(mh.success(small[0].T_gt, on_card.best.transformation)
          and mh.angular_error_so3(on_card.best.transformation[:3, :3],
                                   on_cpu.best.transformation[:3, :3]) < 1e-3
          # a score at the right pose is float32 noise of the shifted
          # distances (~1e-3, tests/test_torch_multistart.py)
          and abs(on_card.scores[on_card.start_index]
                  - on_cpu.scores[on_cpu.start_index]) < 1e-3,
          "multistart: card and CPU plain route disagree")
    emit("multistart", algorithm="se3_pt2pl", config="GOLDEN",
         pose="FLIPPED_POSE", pairs=MS_PAIRS, starts=MS_STARTS,
         flat_registrations=MS_PAIRS * MS_STARTS, points=4167, bucket=4608,
         seconds=wall, pairs_per_s=MS_PAIRS / wall,
         registrations_per_s=MS_PAIRS * MS_STARTS / wall,
         kept_starts=[r.start_index for r in res],
         kept_scores=[float(r.scores[r.start_index]) for r in res],
         scores=[np.round(r.scores, 6).tolist() for r in res],
         score_gap_to_second=gaps,
         kept_iterations=[r.best.num_iterations for r in res],
         loop_steps=stats["loop_steps"], host_syncs=stats["host_syncs"],
         launches=launches, worst_rot_deg=rot, worst_trans=tra,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         card_vs_cpu=dict(points=600, start=on_card.start_index,
                          start_cpu=on_cpu.start_index, agree=True))
    return launches


def fgr_hold(cfg, packed, moved):
    """FGR's captured program against the eager function on the same
    card tensors: the same transform bits and per-pair counts, on the
    main path's clouds and again on other clouds (the inputs reloaded);
    ms a call of both (CUDA events, median of 3), each call's peak of
    allocated memory (a replay's intermediates live in the shared pools,
    which that peak does not count) and the entry's growth of the
    shared pools at its capture."""
    from se3_icp_tpu_torch.models import fgr, program
    out = {}
    for tag, arrs in (("golden", packed), ("moved", moved)):
        se, sg = {}, {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ref = fgr.fgr_register_arrays(*arrs, cfg, stats=se)
        torch.cuda.synchronize()
        peak_eager = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        got = fgr.dispatch_arrays(*arrs, cfg, stats=sg).settle()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        same = (all(torch.equal(a, b) for a, b in zip(got, ref))
                and se == sg)
        check(same, f"fgr ({tag}): the captured program's results or "
              "counts differ from the eager function's")
        out[tag] = dict(same_bits=True, peak_mem_gb=peak / 1e9,
                        eager_peak_mem_gb=peak_eager / 1e9)
    out["ms_program"] = time_ms(
        lambda: fgr.dispatch_arrays(*packed, cfg).settle(), reps=3)
    out["ms_eager"] = time_ms(
        lambda: fgr.fgr_register_arrays(*packed, cfg), reps=3)
    entries = [e for e in program.info()["cached"] if e["kind"] == "FGR"
               and e["pairs"] == N_PAIRS]
    check(len(entries) == 1, f"fgr: {len(entries)} cached 64-pair entries")
    out["pool_bytes_added"] = entries[0]["pool_bytes_added"]
    PROGRAM_HOLDS.append(dict(
        path="fgr", route="graph", same_bits=True, host_syncs=0,
        eager_host_syncs=None, loop_steps=None, eager_loop_steps=None,
        ms_program=out["ms_program"], ms_eager=out["ms_eager"]))
    return out


def fgr_phase():
    """FGR + FPFH through ``register_pairs(pairs, "fgr", FGRConfig())``
    on the main path's 64 golden-shape pairs, every pair gated: a replay
    of its captured program, held against the eager function
    (``fgr_hold``).  Returns (launches, the features of the first call's
    clouds for the kernel case)."""
    from se3_icp_tpu_torch.datasets.fixtures import SMALL_POSE
    from se3_icp_tpu_torch.models import fgr
    from se3_icp_tpu_torch.parallel import pairs
    cfg = fgr.FGRConfig()
    problems = golden_pairs(N_PAIRS)
    pair_list = [(p.source, p.target) for p in problems]
    pairs.register_pairs(pair_list, "fgr", cfg)     # warm-up: the capture
    torch.cuda.synchronize()
    zero_launches()
    stats = {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = pairs.register_pairs(pair_list, "fgr", cfg, stats=stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 1e9
    rot, tra = gate(problems, res, "fgr")
    # the reciprocal match: K6 forward and backward, at D = 33
    only_launched("fgr", launches, {"nn_argmin_batched": 2})
    for name in ("neighborhood_thresholds_batched", "moments_batched",
                 "axis_sums_batched", "nn_match_affine",
                 "loop_epilogue_batched"):
        check(launches[name] == 0, f"fgr launched {name}")
    from se3_icp_tpu_torch.utils import metrics_host as mh
    errs = [mh.angular_error_so3(p.T_gt[:3, :3], r.transformation[:3, :3])
            for p, r in zip(problems, res)]
    packed = [torch.as_tensor(a, device="cuda")
              for a in pairs.pack_pairs(pair_list)]
    moved = [torch.as_tensor(a, device="cuda") for a in pairs.pack_pairs(
        [(p.source, p.target) for p in golden_pairs(N_PAIRS, **SMALL_POSE)])]
    hold = fgr_hold(cfg, packed, moved)
    emit("fgr", config="FGRConfig()", pairs=N_PAIRS, points=4167,
         bucket=4608, route="graph", seconds=wall,
         pairs_per_s=N_PAIRS / wall,
         worst_rot_deg=rot, median_rot_deg=float(np.median(errs)),
         worst_trans=tra, reciprocal=stats["reciprocal"],
         kept_correspondences=stats["kept_correspondences"],
         launches=launches, peak_mem_gb=peak, program=hold)
    # where the call's time goes: its stages on the same packed clouds,
    # each ended by a synchronize; their features are the D = 33 kernel
    # case's inputs
    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    packed, pack_s = timed(lambda: [torch.as_tensor(a, device="cuda")
                                    for a in pairs.pack_pairs(pair_list)])
    src, n_src, tgt, n_tgt = packed
    with torch.no_grad():
        (fs, ft), feat_s = timed(lambda: (fgr.features(src, n_src, cfg),
                                          fgr.features(tgt, n_tgt, cfg)))
        (fwd, bwd), match_s = timed(lambda: fgr.reciprocal_matches(
            fs, n_src, ft, n_tgt))
        _, rest_s = timed(lambda: fgr.register_from_matches(
            src, n_src, tgt, n_tgt, fwd, bwd, cfg))
    emit("fgr_split", pack_upload_seconds=pack_s, features_seconds=feat_s,
         match_seconds=match_s, tuples_gnc_seconds=rest_s)
    return launches, (fs, ft, n_tgt, n_src)


def metrics_phase(results):
    """The metrics on the main path's registered pairs: the squared
    chamfer distance of each registered source to its target and the GT
    correspondences of each pair (K9), the rotation errors against the
    host's float64 ones, and the LRF errors of both setup routes on one
    noisy pair."""
    from se3_icp_tpu_torch.datasets.fixtures import NOISY
    from se3_icp_tpu_torch.utils import lrf_eval, metrics
    from se3_icp_tpu_torch.utils import metrics_host as mh
    problems = golden_pairs(N_PAIRS)
    zero_launches()
    t0 = time.perf_counter()
    chamfer, corr_ok, near_ties = [], 0, 0
    for p, r in zip(problems, results):
        moved = p.source @ r.transformation[:3, :3].T + r.transformation[:3, 3]
        chamfer.append(float(metrics.chamfer_distance_sq(moved, p.target)))
        corr = metrics.compute_corrs_with_gt(p.source, p.target,
                                             p.T_gt).cpu().numpy()
        # the target is the source under T_gt, point for point, except
        # where another target lies within float32 rounding of the
        # shifted distances (points a few 1e-3 apart): checked in float64
        wrong = np.nonzero(corr[:, 1] != corr[:, 0])[0]
        corr_ok += len(corr) - len(wrong)
        if len(wrong):
            m64 = p.source[wrong] @ p.T_gt[:3, :3].T + p.T_gt[:3, 3]
            d_got = ((m64 - p.target[corr[wrong, 1]]) ** 2).sum(-1)
            d_gt = ((m64 - p.target[wrong]) ** 2).sum(-1)
            scale = (m64 ** 2).sum(-1) + (p.target ** 2).sum(-1).max() + 1.0
            check(bool((d_got - d_gt <= 2 * NN_D2_REL * scale).all()),
                  "a GT correspondence is no near-tie")
            near_ties += len(wrong)
    rot = metrics.angular_error_so3(
        np.stack([r.transformation[:3, :3] for r in results]),
        np.stack([p.T_gt[:3, :3] for p in problems]))
    host = np.asarray([mh.angular_error_so3(r.transformation[:3, :3],
                                            p.T_gt[:3, :3])
                       for p, r in zip(problems, results)])
    noisy = golden_pairs(1, **NOISY)[0]
    lrf_err = lrf_eval.cross_cloud_lrf_errors(noisy.source, noisy.target,
                                              noisy.T_gt, inlier=0.05)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    n_all = N_PAIRS * 4167
    # K9: two per chamfer, one per GT correspondence set (the LRF
    # evaluation's included)
    only_launched("metrics", launches,
                  {"nn_argmin_unbatched": 3 * N_PAIRS + 1})
    # the registered source lies on its target: what is left is float32
    # rounding of the shifted distances (|p|^2 ~ 50 here); a 2-degree
    # miss gives ~1e-2
    check(max(abs(c) for c in chamfer) < 1e-4,
          f"chamfer of a registered pair {max(chamfer)}")
    from scipy.spatial import cKDTree
    p0, r0 = problems[0], results[0]
    moved0 = p0.source @ r0.transformation[:3, :3].T + r0.transformation[:3, 3]
    host_chamfer = float(np.mean(cKDTree(p0.target).query(moved0)[0] ** 2)
                         + np.mean(cKDTree(moved0).query(p0.target)[0] ** 2))
    check(abs(chamfer[0] - host_chamfer) < 1e-4,
          "chamfer disagrees with the host's float64 one")
    check(near_ties <= 1e-3 * n_all,
          f"GT correspondences: {near_ties} near-ties of {n_all}")
    check(bool(np.abs(rot.cpu().numpy() - host).max() < 1e-3),
          "angular_error_so3 disagrees with the host's")
    for name, e in lrf_err.items():
        check(np.isfinite(e).all() and len(e) > 500,
              f"LRF errors of the {name} route")
    emit("metrics", pairs=N_PAIRS, seconds=wall,
         chamfer_sq_max=max(chamfer), chamfer_sq_pair0=chamfer[0],
         chamfer_sq_pair0_host=host_chamfer, corrs_with_gt_exact=corr_ok,
         corrs_with_gt_near_ties=near_ties,
         corrs_total=n_all,
         rot_err_vs_host_max_deg=float(np.abs(rot.cpu().numpy() - host).max()),
         lrf_err_median_deg={k: float(np.median(v))
                             for k, v in lrf_err.items()},
         lrf_err_kept={k: len(v) for k, v in lrf_err.items()},
         launches=launches)
    return launches


def ops_phase():
    """The public 1-NN ops as a user calls them (``knn.nn_match`` and
    ``knn.nn_match_packed`` have no caller in the engine, as in the JAX
    package): one call each on the main path's packed targets."""
    from se3_icp_tpu_torch.ops import knn
    from se3_icp_tpu_torch.utils.config import GOLDEN
    problems = golden_pairs(N_PAIRS)
    ms, _ = match_state(problems, GOLDEN, "se3_pt2pl")
    dev = torch.device("cuda")
    false_b = torch.zeros(N_PAIRS, dtype=torch.bool, device=dev)
    W, _, _ = loop_inputs(ms, GOLDEN, false_b, false_b,
                          torch.eye(4, device=dev).repeat(N_PAIRS, 1, 1))
    q12 = (ms.feat16 @ W)[..., :12]
    phase = (torch.arange(N_PAIRS, device=dev) % 2).to(torch.int32)
    zero_launches()
    idx, _, m = knn.nn_match(q12, ms.targets.emb[:, 0], ms.targets.payload,
                             ms.targets.n)
    idx2, _, m2 = knn.nn_match_packed(q12, ms.targets, phase)
    torch.cuda.synchronize()
    launches = read_launches()
    only_launched("public ops", launches, {"nn_match_batched": 1,
                                           "nn_match_packed": 1})
    # phase-0 pairs searched the same block through both ops (|t|^2
    # rounded in the kernel there, in torch here: near-ties may part)
    even = phase == 0
    same = idx[even] == idx2[even]
    check(float(same.float().mean()) >= 1 - NN_FLIP_SHARE
          and bool((m[even][same] == m2[even][same]).all()),
          "nn_match and nn_match_packed disagree on the same block")
    emit("ops", nn_match=dict(shape=list(q12.shape)),
         nn_match_packed=dict(phases=[0, 1]),
         same_block_rows_differing=int((~same).sum()), launches=launches)
    return launches


def cli_slice3_phase():
    """``run fgr`` and ``run se3_pt2pl --multi-start 8`` of the CLI, in
    this process, each gated."""
    import contextlib
    import io
    from se3_icp_tpu_torch import cli
    from se3_icp_tpu_torch.datasets.fixtures import FLIPPED_POSE
    from se3_icp_tpu_torch.utils import ply
    out = {}
    for tag, args, kw in (("fgr", ["fgr"], {}),
                          ("multi_start", ["se3_pt2pl", "--multi-start",
                                           str(MS_STARTS)], FLIPPED_POSE)):
        prob = golden_pairs(1, **kw)[0]
        with tempfile.TemporaryDirectory() as tmp:
            src, tgt = (os.path.join(tmp, f) for f in ("s.ply", "t.ply"))
            ply.write_ply(src, prob.source)
            ply.write_ply(tgt, prob.target)
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                cli.main(["run", args[0], src, tgt, *args[1:]])
            wall = time.perf_counter() - t0
        lines = buf.getvalue().strip().splitlines()
        at = lines.index("Estimated transformation = ")
        T = np.asarray([[float(v) for v in ln.split()]
                        for ln in lines[at + 1:at + 5]])
        rot, tra = gate([prob], [types.SimpleNamespace(transformation=T)],
                        f"CLI run {' '.join(args)}")
        if tag == "multi_start":
            check(any(ln.startswith("multi-start: kept start")
                      for ln in lines), "no kept-start line")
        out[tag] = dict(seconds=wall, worst_rot_deg=rot, worst_trans=tra)
    emit("cli_slice3", **out)


# --------------------------------------------------------------------
# The lounge and KITTI bench protocols on seed-made fixtures.

# the fixtures' sizes: the reference lounge protocol's 79 pairs of
# ~4.1k-point frames (the main path's 4608 bucket); the KITTI protocol's
# 40 pairs of 15.2k-15.4k-point scans (the reference bundle has ~15k)
# on the resampled road, where the JAX package passes every pair; and
# the same 40 pairs of the hard ring-scan fixture, 12.3k-16.1k points,
# where it misses most (ROADMAP section 3)
LOUNGE_FIXTURE = dict(n_frames=396, n_points=4900)
KITTI_FIXTURE = dict(max_index=80, n_points=18000)
KITTI_HARD_FIXTURE = dict(max_index=80, n_points=6000, hard=True)
LOUNGE_PAIRS, KITTI_PAIRS = 79, 40
# the JAX tests' own KITTI fixtures (tests/test_bench_protocols.py),
# where the JAX package holds the protocol's gate
KITTI_JAX_TEST_HARD = dict(max_index=6, n_points=1200, hard=True)
KITTI_JAX_TEST_FRIENDLY = dict(max_index=6, n_points=900)
KITTI_CUT = ("max_index 80 (40 pairs) of the reference protocol's 1100 "
             "(550 pairs): the hard fixture's world ends at x = 140 m and "
             "the sensor moves 1.5 m a raw frame, so past raw frame ~90 a "
             "scan holds little but the ground plane and outlier blobs; "
             "the resampled road is cut to the same 40 pairs")


class ProgramKeys:
    """Within the block: the captured-program keys the calls asked for
    (``program._key``'s results, recorded) and the captures made."""

    def __enter__(self):
        from se3_icp_tpu_torch.models import program
        self.program, self.orig = program, program._key
        self.keys = set()

        def recorded(*a, **kw):
            key = self.orig(*a, **kw)
            self.keys.add(key)
            return key

        program._key = recorded
        self.start = program.totals["captures"]
        return self

    def __exit__(self, *exc):
        self.program._key = self.orig

    def line(self) -> dict:
        """captures, distinct keys, and each key's (pairs, source width,
        target width, warm start)."""
        return dict(captures=self.program.totals["captures"] - self.start,
                    distinct_keys=len(self.keys),
                    keys=sorted((k[4], k[5], k[6], k[8])
                                for k in self.keys))


def quiet(fn, *a, **kw):
    """``fn(*a, **kw)`` with its report printing kept out of this
    script's output: (result, what it printed)."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*a, **kw)
    return out, buf.getvalue()


def protocol_run(tag, fn, *a, **kw):
    """One protocol run through its entry point, with the program keys
    it asked for, its captures, the card's reserved memory after it and
    its launches (counts set to 0 just before, read just after):
    (report, line fields, launches)."""
    zero_launches()
    t0 = time.perf_counter()
    with ProgramKeys() as keys:
        (rep, printed) = quiet(fn, *a, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    return rep, dict(run=tag, seconds=wall, **keys.line(),
                     memory_reserved_gb=torch.cuda.memory_reserved() / 1e9,
                     launches=launches), launches, printed


def check_registration_launches(what, launches):
    """A registration run went through its setup and loop kernels: K1
    and K2 at least once, K4 and K5 once each a loop step (and no 1-NN
    kernel of the other paths)."""
    check(launches["neighborhood_thresholds_batched"] > 0
          and launches["moments_batched"] > 0,
          f"{what}: setup kernels {launches}")
    check(launches["nn_match_affine"]
          == launches["loop_epilogue_batched"] > 0,
          f"{what}: loop kernels {launches}")
    check_glue_launches(what, launches, launches["nn_match_affine"])
    only_launched(what, launches, {})


def pair_misses(outcomes, gts):
    """Pairs outside the 2 deg / 0.25 gate, by index."""
    from se3_icp_tpu_torch.utils import metrics_host as mh
    return [i for i, T_gt in enumerate(gts)
            if not mh.success(T_gt, outcomes[i].T_est)]


def sum_launches(total, launches):
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v


def lounge_protocols(d, d_hard, total):
    """The lounge protocol (79 pairs at the 4608 bucket) with
    ``se3_gicp_with_cf`` and, through ``bench-lounge`` of the CLI,
    ``se3_pt2pl``, and ``se3_gicp_with_cf`` on the hard fixture; the
    analyses; a two-alpha sweep; ``test-se3-pure`` of the CLI with a
    one-alpha grid."""
    from se3_icp_tpu_torch import cli
    from se3_icp_tpu_torch.bench import common, lounge_bench
    pairs_, gts = lounge_bench.load_lounge_pairs(d)
    sizes = sorted({len(c) for p in pairs_ for c in p})
    for folder, alg, name in ((d, "se3_gicp_with_cf", "lounge"),
                              (d, "se3_pt2pl", "lounge"),
                              (d_hard, "se3_gicp_with_cf", "lounge_hard")):
        ck = os.path.join(folder, f"{alg}.jsonl")
        if alg == "se3_pt2pl":      # this one through the CLI
            _, line, launches, printed = protocol_run(
                f"{name} {alg}", cli.main,
                ["bench-lounge", alg, folder, "--json", "--checkpoint", ck])
            rep = json.loads(printed.strip().splitlines()[-1])
        else:
            rep, line, launches, _ = protocol_run(
                f"{name} {alg}", lounge_bench.benchmark_lounge, alg,
                folder, checkpoint=ck)
        check_registration_launches(f"{name} {alg}", launches)
        sum_launches(total, launches)
        outcomes = common.Checkpoint(ck).done
        gts_run = gts if folder == d else lounge_bench.load_lounge_pairs(
            folder)[1]
        misses = pair_misses(outcomes, gts_run)
        walls = [o.wall_ms for o in outcomes.values()]
        check(rep["num_pairs"] == LOUNGE_PAIRS,
              f"{name}: {rep['num_pairs']} pairs")
        check(rep["avg_angular_SO3_error"] < 2.0
              and rep["avg_tra_error"] < 0.25,
              f"{name} {alg}: average errors {rep}")
        emit("protocol", protocol=name, algorithm=alg, config="LOUNGE",
             points=[sizes[0], sizes[-1]], **{k: v for k, v in rep.items()
                                               if k != "algorithm"},
             median_time_ms=statistics.median(walls),
             pairs_missing_gate=len(misses), missing=misses,
             mean_iterations=float(np.mean(
                 [o.num_iterations for o in outcomes.values()])), **line)
    rep, line, launches, _ = protocol_run(
        "lounge analyze", lounge_bench.analyze_lounge, d)
    only_launched("lounge analyze", launches,
                  {"nn_argmin_unbatched": 3 * len(pairs_)})
    sum_launches(total, launches)
    check(rep["avg_point_cloud_distance_top70"]
          < rep["avg_point_cloud_distance"] and all(
              np.isfinite(v) for v in rep.values()),
          f"lounge analyze: {rep}")
    emit("protocol", protocol="lounge", analysis=rep, **line)
    sweep = alpha_sweep(lounge_bench, "benchmark_lounge",
                        lounge_bench.lounge_alpha_sweep, "se3_pt2pl", d)
    emit("protocol", protocol="lounge", alpha_sweep=sweep)
    grid = common.hybrid_alpha_grid
    common.hybrid_alpha_grid = lambda: [3.0]
    try:
        _, line, launches, printed = protocol_run(
            "test-se3-pure", cli.main,
            ["test-se3-pure", "se3_pure_pt2pl", d])
    finally:
        common.hybrid_alpha_grid = grid
    check_registration_launches("test-se3-pure", launches)
    sum_launches(total, launches)
    eul = float(printed.strip().splitlines()[-1].rsplit("= ", 1)[1])
    check(np.isfinite(eul), "test-se3-pure: euler error not finite")
    emit("protocol", protocol="lounge", cli="test-se3-pure se3_pure_pt2pl",
         alphas=[3.0], avg_eul_angle_error=eul, **line)


def alpha_sweep(module, name, sweep, alg, folder, **kw):
    """``sweep`` over the grid [3.0, 100.0]: the captures each alpha's
    protocol run made; the second alpha must make none (alpha is an
    input of the captured program)."""
    from se3_icp_tpu_torch.bench import common
    per_alpha = []
    bench, grid = getattr(module, name), common.hybrid_alpha_grid

    def counted(*a, **k):
        from se3_icp_tpu_torch.models import program
        c0 = program.totals["captures"]
        rep = bench(*a, **k)
        per_alpha.append(dict(alpha=k["rot_alpha"],
                              captures=program.totals["captures"] - c0))
        return rep

    setattr(module, name, counted)
    common.hybrid_alpha_grid = lambda: [3.0, 100.0]
    try:
        reps, line, launches, _ = protocol_run(
            f"{name} alpha sweep", sweep, alg, folder, **kw)
    finally:
        setattr(module, name, bench)
        common.hybrid_alpha_grid = grid
    check_registration_launches(f"{name} alpha sweep", launches)
    check(len(reps) == 2 and per_alpha[1]["captures"] == 0,
          f"{name}: the second alpha captured a program: {per_alpha}")
    return dict(algorithm=alg, per_alpha=per_alpha,
                reports=[{k: r[k] for k in r if "error" in k or "rel" in k
                          or "success" in k} for r in reps], **line)


def kitti_pairs(d, max_index):
    """(scan sizes, pairs, GT transforms) of a KITTI-layout folder."""
    from se3_icp_tpu_torch.bench import kitti_bench
    clouds, poses = kitti_bench.load_kitti(d, max_index=max_index)
    n_pairs = len(clouds) - 1
    return ([len(c) for c in clouds], poses,
            [(clouds[i + 1], clouds[i]) for i in range(n_pairs)],
            [np.linalg.inv(poses[i]) @ poses[i + 1] for i in range(n_pairs)])


def pair_rows(outcomes, gts):
    """[pair, iterations, rotation error (deg), translation error]."""
    from se3_icp_tpu_torch.utils import metrics_host as mh
    return [[i, outcomes[i].num_iterations,
             mh.angular_error_so3(outcomes[i].T_est[:3, :3], T[:3, :3]),
             mh.translation_error(outcomes[i].T_est[:3, 3], T[:3, 3])]
            for i, T in enumerate(gts)]


def jax_survey_misses(fixture) -> dict:
    """Context, not a hold: the pairs of ``fixture`` that the JAX
    package's own KITTI protocol misses, by route, from the committed
    CPU surveys (``tests/data/kitti_survey.json``)."""
    with open(os.path.join(ROOT, "tests", "data", "kitti_survey.json")) as f:
        surveys = json.load(f)["surveys"]
    return {s["route"]: sorted(int(i) for i, p in s["pairs"].items()
                               if not p["gate"])
            for s in surveys if all(s[k] == v for k, v in dict(
                fixture, hard=fixture.get("hard", False)).items())}


def kitti_protocols(d, total):
    """The KITTI protocol at full width on the resampled road, 40 pairs
    of 15.2k-15.4k points: ``bench-kitti se3_pt2pl`` of the CLI
    (batched, with a checkpoint and the trajectory read back through
    ``eval-traj``), every pair within 2 deg / 0.25, as the JAX package
    registers every pair of this fixture; batched and online ``pt2pl``,
    the online run inside the gate in no more iterations than the
    batched one; the analyses; a two-alpha sweep."""
    from se3_icp_tpu_torch import cli
    from se3_icp_tpu_torch.bench import common, kitti_bench
    from se3_icp_tpu_torch.utils import ply
    max_index = str(KITTI_FIXTURE["max_index"])
    sizes, poses, pairs_, gts = kitti_pairs(d, int(max_index))
    n_pairs = len(pairs_)
    ck, est = (os.path.join(d, f) for f in ("se3_pt2pl.jsonl", "est.txt"))
    _, line, launches, printed = protocol_run(
        "kitti se3_pt2pl", cli.main,
        ["bench-kitti", "se3_pt2pl", d, "--max-index", max_index, "--json",
         "--checkpoint", ck, "--save-traj", est])
    rep = json.loads(printed.strip().splitlines()[-1])
    check_registration_launches("kitti se3_pt2pl", launches)
    sum_launches(total, launches)
    outcomes = common.Checkpoint(ck).done
    misses = pair_misses(outcomes, gts)
    check(rep["num_pairs"] == n_pairs == KITTI_PAIRS,
          f"kitti: {rep['num_pairs']} pairs")
    check(not misses and rep["success_rate"] == 1.0
          and rep["mean_rel_rot"] < 2.0 and rep["mean_rel_tra"] < 0.25,
          f"kitti se3_pt2pl: pairs {misses} miss the gate: {rep}")
    emit("protocol", protocol="kitti", algorithm="se3_pt2pl",
         config="KITTI_SE3", fixture=KITTI_FIXTURE,
         points=[min(sizes), max(sizes)], cut=KITTI_CUT,
         **{k: v for k, v in rep.items() if k != "algorithm"},
         pairs_missing_gate=len(misses),
         jax_package_missing=jax_survey_misses(KITTI_FIXTURE), **line)
    # the saved trajectory against the kept frames' poses; frame 0 is the
    # identity in both, so the sums over the 41 frames are the report's
    # over the 40 others, each frame's rotation error to 1e-3 deg (the
    # host's error projects the accumulated rotation onto SO(3) first,
    # the card's log map takes it as it is)
    gt_file = os.path.join(d, "gt_kept.txt")
    ply.write_trajectory_12col(gt_file, poses)
    _, line, launches, printed = protocol_run(
        "eval-traj", cli.main, ["eval-traj", gt_file, est, "--json"])
    traj = json.loads(printed.strip().splitlines()[-1])
    check(abs(traj["avg_rotation_error"] * len(poses)
              - rep["mean_abs_rot"] * n_pairs) < 1e-3 * n_pairs
          and abs(traj["avg_translation_error"] * len(poses)
                  - rep["mean_abs_tra"] * n_pairs) < 1e-3 * n_pairs,
          f"eval-traj {traj} disagrees with the report {rep}")
    emit("protocol", protocol="kitti", cli="eval-traj", **traj,
         frames=len(poses))
    runs = {}
    for online in (False, True):
        tag = f"kitti pt2pl{' online' if online else ''}"
        runs[online], line, launches, _ = protocol_run(
            tag, kitti_bench.benchmark_kitti, "pt2pl", d,
            max_index=int(max_index), online=online)
        check_registration_launches(tag, launches)
        sum_launches(total, launches)
        r = runs[online]
        check(r["success_rate"] == 1.0 and r["mean_rel_rot"] < 2.0
              and r["mean_rel_tra"] < 0.25, f"{tag}: {r}")
        emit("protocol", protocol="kitti", algorithm="pt2pl",
             config="KITTI_VANILLA", **{k: v for k, v in r.items()
                                        if k != "algorithm"}, **line)
    check(runs[True]["mean_iterations"] <= runs[False]["mean_iterations"],
          f"kitti: online {runs[True]['mean_iterations']} iterations a "
          f"pair, batched {runs[False]['mean_iterations']}")
    rep, line, launches, _ = protocol_run(
        "kitti analyze", kitti_bench.analyze_kitti, d,
        max_index=int(max_index))
    only_launched("kitti analyze", launches,
                  {"nn_argmin_unbatched": 3 * n_pairs})
    sum_launches(total, launches)
    check(all(np.isfinite(v) for v in rep.values())
          and rep["avg_point_cloud_distance_top70"]
          < rep["avg_point_cloud_distance"]
          < 0.5 * rep["avg_starting_distance"], f"kitti analyze: {rep}")
    emit("protocol", protocol="kitti", analysis=rep, **line)
    sweep = alpha_sweep(kitti_bench, "benchmark_kitti",
                        kitti_bench.kitti_alpha_sweep, "se3_pt2pl", d,
                        max_index=int(max_index))
    emit("protocol", protocol="kitti", alpha_sweep=sweep)


def kitti_hard_runs(d, total):
    """The hard ring-scan fixture's 40 pairs, 12.3k-16.1k points in seven
    512-buckets: batched ``se3_pt2pl`` and online ``pt2pl``, for the
    program keys, captures and times that scans of changing width give,
    with the online run held bit for bit, or to the ulp, against the
    eager loop on the same frames (the warm start is an input of the
    captured program).  Their errors are printed pair by pair and not
    gated: at this density the JAX package itself misses most of these
    pairs, and the misses' errors differ between routes (ROADMAP
    section 3); the gate is held on the resampled road."""
    from se3_icp_tpu_torch.bench import common, kitti_bench
    from se3_icp_tpu_torch.utils.config import KITTI_VANILLA
    max_index = KITTI_HARD_FIXTURE["max_index"]
    sizes, _, pairs_, gts = kitti_pairs(d, max_index)
    n_pairs = len(pairs_)
    ck = os.path.join(d, "se3_pt2pl.jsonl")
    rep, line, launches, _ = protocol_run(
        "kitti_hard se3_pt2pl", kitti_bench.benchmark_kitti, "se3_pt2pl",
        d, max_index=max_index, checkpoint=ck)
    check_registration_launches("kitti_hard se3_pt2pl", launches)
    sum_launches(total, launches)
    outcomes = common.Checkpoint(ck).done
    check(rep["num_pairs"] == n_pairs == KITTI_PAIRS
          and all(np.isfinite(o.T_est).all() for o in outcomes.values()),
          f"kitti_hard: {rep}")
    misses = pair_misses(outcomes, gts)
    emit("protocol", protocol="kitti_hard", algorithm="se3_pt2pl",
         config="KITTI_SE3", fixture=KITTI_HARD_FIXTURE,
         points=[min(sizes), max(sizes)], cut=KITTI_CUT,
         **{k: v for k, v in rep.items() if k != "algorithm"},
         pairs_missing_gate=len(misses), missing=misses,
         jax_package_missing=jax_survey_misses(KITTI_HARD_FIXTURE),
         per_pair=pair_rows(outcomes, gts), **line)
    seen = {}
    online_fn = kitti_bench._run_pairs_online

    def kept(*a, **kw):
        seen["outcomes"] = online_fn(*a, **kw)
        return seen["outcomes"]

    kitti_bench._run_pairs_online = kept
    try:
        online, line, launches, _ = protocol_run(
            "kitti_hard pt2pl online", kitti_bench.benchmark_kitti,
            "pt2pl", d, max_index=max_index, online=True)
    finally:
        kitti_bench._run_pairs_online = online_fn
    check_registration_launches("kitti_hard pt2pl online", launches)
    sum_launches(total, launches)
    # the warm start is an input of the captured program: the eager loop
    # on the same frames, each warm-started from its own previous pair
    with EagerLoop():
        eager = online_fn(pairs_, "pt2pl",
                          KITTI_VANILLA.replace(alpha_rot=3.0),
                          verbose=False)
    got = seen["outcomes"]
    same_iters = all(got[i].num_iterations == eager[i].num_iterations
                     for i in got)
    a32 = np.stack([got[i].T_est for i in got]).astype(np.float32)
    b32 = np.stack([eager[i].T_est for i in got]).astype(np.float32)
    ulps = int(np.abs(a32.view(np.int32).astype(np.int64)
                      - b32.view(np.int32).astype(np.int64)).max())
    check(same_iters and ulps <= 1,
          f"online: the captured program's warm-started results differ "
          f"from the eager loop's ({ulps} ulps, iterations equal: "
          f"{same_iters})")
    emit("protocol", protocol="kitti_hard", algorithm="pt2pl",
         config="KITTI_VANILLA", **{k: v for k, v in online.items()
                                    if k != "algorithm"},
         vs_eager=dict(same_bits=ulps == 0, max_ulps=ulps,
                       same_iterations=same_iters),
         upload_split=online_upload_split(*pairs_[-1], got[n_pairs - 2]),
         per_pair=pair_rows(got, gts), **line)


def online_upload_split(src, tgt, outcome):
    """One warm online call of ``register_pair`` (its program captured)
    beside its pageable host-to-device copies alone -- the padded source
    and target, the two counts and the warm start, each copied as
    ``register_pair`` copies it -- host clock around a synchronised
    call, medians of 7."""
    from se3_icp_tpu_torch.models import registration as reg
    from se3_icp_tpu_torch.utils.config import KITTI_VANILLA
    dev = reg.resolve_device("cuda")
    T0 = outcome.T_est

    def uploads():
        for pts in (src, tgt):
            padded = np.zeros((1, reg._bucket(len(pts)), 3))
            padded[0, :len(pts)] = pts
            torch.as_tensor(padded, dtype=torch.float32, device=dev)
            torch.tensor([len(pts)], dtype=torch.int32, device=dev)
        torch.as_tensor(T0[None], dtype=torch.float32, device=dev)

    def call():
        reg.register_pair(src, tgt, "pt2pl", KITTI_VANILLA, initial_T=T0)

    out = {}
    for name, fn in (("pageable_uploads_ms", uploads),
                     ("register_pair_ms", call)):
        fn()
        times = []
        for _ in range(7):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out[name] = statistics.median(times)
    return out


def kitti_jax_tests(tmp, total):
    """The KITTI protocol where the JAX package holds it, on its tests'
    fixtures (``tests/test_bench_protocols.py``): ``se3_pt2pl`` on the
    hard fixture of 3 pairs passes every pair within 2 deg / 0.25, and
    online ``pt2pl`` on the friendly one is inside the gate on average,
    in no more iterations than the batched run."""
    from se3_icp_tpu_torch.bench import kitti_bench
    from se3_icp_tpu_torch.datasets import fixtures
    hard, friendly = (os.path.join(tmp, f) for f in ("kh", "kf"))
    fixtures.make_kitti_fixture(hard, **KITTI_JAX_TEST_HARD)
    fixtures.make_kitti_fixture(friendly, **KITTI_JAX_TEST_FRIENDLY)
    idx = KITTI_JAX_TEST_HARD["max_index"]
    rep, line, launches, _ = protocol_run(
        "kitti jax-test hard", kitti_bench.benchmark_kitti, "se3_pt2pl",
        hard, max_index=idx)
    check_registration_launches("kitti jax-test hard", launches)
    sum_launches(total, launches)
    check(rep["num_pairs"] == 3 and rep["success_rate"] == 1.0
          and rep["mean_rel_rot"] < 2.0 and rep["mean_rel_tra"] < 0.25,
          f"kitti, the JAX test's hard fixture: {rep}")
    emit("protocol", protocol="kitti_jax_test_hard", algorithm="se3_pt2pl",
         fixture=KITTI_JAX_TEST_HARD, **{k: v for k, v in rep.items()
                                         if k != "algorithm"}, **line)
    runs = {}
    for online in (True, False):
        runs[online], line, launches, _ = protocol_run(
            f"kitti jax-test online={online}", kitti_bench.benchmark_kitti,
            "pt2pl", friendly, max_index=idx, online=online)
        check_registration_launches(f"kitti jax-test online={online}",
                                    launches)
        sum_launches(total, launches)
        emit("protocol", protocol="kitti_jax_test_friendly",
             algorithm="pt2pl", fixture=KITTI_JAX_TEST_FRIENDLY,
             **{k: v for k, v in runs[online].items() if k != "algorithm"},
             **line)
    on, off = runs[True], runs[False]
    check(on["mean_rel_rot"] < 2.0 and on["mean_rel_tra"] < 0.25
          and on["mean_iterations"] <= off["mean_iterations"],
          f"kitti, the JAX test's online run {on} against batched {off}")


def lrf_quality_run(d, total):
    """``lrf-quality`` of the CLI on the first lounge pair (frames 1 and
    6 under their GT): TOLDI frames and GT correspondences (K9)."""
    from se3_icp_tpu_torch import cli
    from se3_icp_tpu_torch.bench import lounge_bench
    from se3_icp_tpu_torch.utils import ply
    _, gts = lounge_bench.load_lounge_pairs(d, stop=2)
    gt = os.path.join(d, "gt_1_6.txt")
    np.savetxt(gt, gts[0])
    src, tgt = (lounge_bench._cloud_name(d, i) for i in (1, 6))
    _, line, launches, printed = protocol_run(
        "lrf-quality", cli.main, ["lrf-quality", src, tgt, gt, "--json"])
    rep = json.loads(printed.strip().splitlines()[-1])
    only_launched("lrf-quality", launches, {"nn_argmin_unbatched": 1})
    sum_launches(total, launches)
    n_src = len(ply.read_ply(src).points)
    check(rep["num_corrs"] == n_src
          and np.isfinite(rep["mean_lrf_so3_error"]), f"lrf-quality: {rep}")
    emit("protocol", protocol="lounge", cli="lrf-quality", **rep, **line)


def protocols_phase():
    """The lounge and KITTI protocols of ``bench/`` on the card through
    their entry points, on fixtures written here from their seeds, with
    K1-K5 held against their plain versions at the KITTI protocol's
    shapes first; returns the launches of all the protocol runs
    together and those kernel cases."""
    from se3_icp_tpu_torch.datasets import fixtures
    total = {}
    with tempfile.TemporaryDirectory() as tmp:
        lounge, lounge_hard, kitti, kitti_hard = (
            os.path.join(tmp, f) for f in ("lounge", "lounge_hard", "kitti",
                                           "kitti_hard"))
        t0 = time.perf_counter()
        fixtures.make_lounge_fixture(lounge, **LOUNGE_FIXTURE)
        fixtures.make_lounge_fixture(lounge_hard, hard=True,
                                     **LOUNGE_FIXTURE)
        fixtures.make_kitti_fixture(kitti, **KITTI_FIXTURE)
        fixtures.make_kitti_fixture(kitti_hard, **KITTI_HARD_FIXTURE)
        emit("protocol_fixtures", seconds=time.perf_counter() - t0,
             lounge=LOUNGE_FIXTURE, kitti=KITTI_FIXTURE,
             kitti_hard=KITTI_HARD_FIXTURE)
        cases = protocol_kernel_cases(kitti_hard,
                                      KITTI_HARD_FIXTURE["max_index"])
        lounge_protocols(lounge, lounge_hard, total)
        lrf_quality_run(lounge, total)
        kitti_protocols(kitti, total)
        kitti_hard_runs(kitti_hard, total)
        kitti_jax_tests(tmp, total)
    emit("protocols", launches=total)
    return total, cases


# --------------------------------------------------------------------
# The bunny protocols on the seed-made bunny stand-in; SHOT frames and
# Anderson acceleration on the captured program.

BUNNY_SURVEY = os.path.join(ROOT, "tests", "data", "bunny_survey.json")
SYNTH_SETS = ("easy", "moderate")       # 30 cases each, as the survey's


def survey_pairs() -> dict:
    """{(protocol, route): {case: row}} of the JAX package's surveys on
    the stand-in (``tests/data/bunny_survey.json``)."""
    with open(BUNNY_SURVEY) as f:
        return {(s["protocol"], s["route"]): s["pairs"]
                for s in json.load(f)["surveys"]}


def survey_gate(what, passed: dict, protocol: str) -> dict:
    """The card against the JAX package's survey, case by case: every
    case the JAX package passes on its exact route passes on the card,
    but for a miss its threshold route (the card's route) shows too.
    ``passed``: {case index: bool}."""
    surveys = survey_pairs()
    exact = surveys[(protocol, "exact")]
    thr = surveys.get((protocol, "thr"))
    must = [i for i in passed if exact[str(i)]["gate"]]
    missed = [i for i in must if not passed[i]]
    shared = [i for i in missed
              if thr is not None and not thr[str(i)]["gate"]]
    check(missed == shared,
          f"{what}: cases {sorted(set(missed) - set(shared))} miss the "
          "gate on the card where the JAX package passes them")
    return dict(card_passes=sum(passed.values()), cases=len(passed),
                jax_exact_passes=len(must),
                jax_thr_passes=(None if thr is None else sum(
                    r["gate"] for r in thr.values())),
                missed_as_jax_thr=shared,
                card_passes_jax_exact_misses=[
                    i for i in passed if passed[i] and i not in must])


def walls_line(outcomes) -> dict:
    walls = [o.wall_ms for o in outcomes.values()]
    return dict(median_time_ms=statistics.median(walls),
                mean_time_ms=float(np.mean(walls)),
                mean_iterations=float(np.mean(
                    [o.num_iterations for o in outcomes.values()])))


def bunny_cli_run(tmp):
    """``create-problem``, ``example`` and ``example-fgr`` of the CLI in
    one subprocess (the bunny read through ``SE3_ICP_TPU_BUNNY``), the
    problem written held against ``synthetic.golden_like_problem`` and
    each example gated where the JAX package passes it in every survey
    run (its float32 FGR on the demo lands on either side of 2 deg,
    with JAX's 64-bit mode on or off: ROADMAP section 3)."""
    from se3_icp_tpu_torch.datasets import synthetic
    from se3_icp_tpu_torch.utils import ply
    out_dir, aligned = (os.path.join(tmp, d) for d in ("problem", "aligned"))
    calls = [["create-problem", "--out", out_dir],
             ["example", "--json"],
             ["example-fgr", "--json", "--save-aligned", aligned]]
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", "import json, sys\n"
         "from se3_icp_tpu_torch import cli\n"
         "for argv in json.loads(sys.argv[1]):\n"
         "    cli.main(argv)\n", json.dumps(calls)],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env=dict(os.environ))
    wall = time.perf_counter() - t0
    check(proc.returncode == 0,
          f"bunny CLI exited {proc.returncode}: {proc.stderr[-2000:]}")
    ref = synthetic.golden_like_problem(seed=1)
    got = ply.read_ply(os.path.join(out_dir, "source.ply")).points
    check(np.array_equal(got, ref.source)
          and np.allclose(np.loadtxt(os.path.join(
              out_dir, "transformation_gt.txt")), ref.T_gt, atol=1e-6),
          "create-problem: the written problem is not golden_like_problem")
    reps = [json.loads(ln) for ln in proc.stdout.splitlines()
            if ln.startswith("{")]
    check(len(reps) == 2, f"bunny CLI: {len(reps)} JSON lines")
    surveys = survey_pairs()
    out = dict(seconds=wall)
    for name, rep in zip(("example", "example-fgr"), reps):
        ok = rep["so3_error_deg"] < 2.0 and rep["translation_error"] < 0.25
        jax = {r: surveys[(name, r)]["0"] for r in ("exact", "exact-x64")
               if (name, r) in surveys}
        if all(v["gate"] for v in jax.values()):
            check(ok, f"{name}: {rep['so3_error_deg']:.4f} deg, "
                  f"{rep['translation_error']:.4f} off the demo's GT")
        out[name] = dict(rot_deg=rep["so3_error_deg"],
                         trans=rep["translation_error"], gate=ok,
                         iterations=rep["num_iterations"], jax_package=jax)
    check(sorted(os.listdir(aligned)) == ["source.ply", "source_aligned.ply",
                                          "target.ply"],
          "example-fgr --save-aligned: files")
    emit("bunny_cli", cli="create-problem, example, example-fgr", **out)


def synthetic_runs(tmp, total):
    """``bench-synthetic --generate`` and the benchmark through the CLI,
    30 cases each of easy and moderate at the 4608 bucket, every case
    gated against the JAX package's survey; one ``--multi-start 8``
    run on the moderate set; a two-alpha sweep."""
    from se3_icp_tpu_torch import cli
    from se3_icp_tpu_torch.bench import common, synthetic_bench
    from se3_icp_tpu_torch.datasets import synthetic
    from se3_icp_tpu_torch.utils import metrics_host as mh
    folders = {}
    for diff in SYNTH_SETS:
        folder = folders[diff] = os.path.join(tmp, diff)
        quiet(cli.main, ["bench-synthetic", "se3_pt2pl", folder,
                         "--generate", "--difficulty", diff])
        probs = synthetic.load_problem_folder(folder)
        ck = os.path.join(tmp, f"{diff}.jsonl")
        _, line, launches, printed = protocol_run(
            f"synthetic {diff}", cli.main,
            ["bench-synthetic", "se3_pt2pl", folder, "--json",
             "--checkpoint", ck])
        rep = json.loads(printed.strip().splitlines()[-1])
        check_registration_launches(f"synthetic {diff}", launches)
        sum_launches(total, launches)
        outcomes = common.Checkpoint(ck).done
        check(rep["num_problems"] == len(probs) == 30
              and all(np.isfinite(o.T_est).all() for o in outcomes.values()),
              f"synthetic {diff}: {rep}")
        passed = {i: mh.success(p.T_gt, outcomes[i].T_est)
                  for i, p in enumerate(probs)}
        emit("protocol", protocol="synthetic", difficulty=diff,
             algorithm="se3_pt2pl", config="GOLDEN", cases=30,
             points=sorted({len(p.source) for p in probs}),
             success_rate=rep["success_rate"], **walls_line(outcomes),
             survey=survey_gate(f"synthetic {diff}", passed,
                                f"synthetic_{diff}"), **line)
    rep, line, launches, _ = protocol_run(
        "synthetic moderate multi-start", synthetic_bench
        .benchmark_on_saved_data, "se3_pt2pl", folders["moderate"],
        multi_start=MS_STARTS)
    check(launches["nn_argmin_batched"] > 0
          and launches["nn_match_affine"] == launches[
              "loop_epilogue_batched"] > 0,
          f"synthetic multi-start: launches {launches}")
    sum_launches(total, launches)
    emit("protocol", protocol="synthetic", difficulty="moderate",
         algorithm="se3_pt2pl", multi_start=MS_STARTS,
         success_rate=rep["success_rate"], num_fails=rep["num_fails"],
         avg_time_ms=rep["avg_time_ms"], **line)
    sweep = alpha_sweep(synthetic_bench, "benchmark_on_saved_data",
                        synthetic_bench.alpha_sweep, "se3_pt2pl",
                        folders["easy"])
    emit("protocol", protocol="synthetic", difficulty="easy",
         alpha_sweep=sweep)


def extreme_noise_runs(tmp, total):
    """``bench-extreme-noise --generate`` and the benchmark through the
    CLI, all 11 levels of 30 runs: level 0.0 gated run by run where the
    JAX package passes, every level's error beside the survey's."""
    from se3_icp_tpu_torch import cli
    from se3_icp_tpu_torch.bench import extreme_noise_bench as en
    from se3_icp_tpu_torch.utils import metrics_host as mh
    folder = os.path.join(tmp, "noise")
    quiet(cli.main, ["bench-extreme-noise", "se3_pt2pl", folder,
                     "--generate"])
    seen = {}
    run_pairs = en.common.run_pairs

    def kept(pairs_, *a, **kw):
        seen[len(seen)] = (pairs_, run_pairs(pairs_, *a, **kw))
        return seen[len(seen) - 1][1]

    en.common.run_pairs = kept
    try:
        _, line, launches, printed = protocol_run(
            "extreme noise", cli.main,
            ["bench-extreme-noise", "se3_pt2pl", folder, "--json"])
    finally:
        en.common.run_pairs = run_pairs
    errors = json.loads(printed.strip().splitlines()[-1])["errors"]
    check_registration_launches("extreme noise", launches)
    sum_launches(total, launches)
    check(len(errors) == len(en.LEVELS) == len(seen) == 11
          and np.isfinite(errors).all(), f"extreme noise: {errors}")
    surveys = survey_pairs()
    levels = []
    for k, (sub, level, err) in enumerate(zip(en.LEVEL_FOLDERS, en.LEVELS,
                                              errors)):
        pairs_, outcomes = seen[k]
        T_gt = en.read_gt(os.path.join(folder, sub))
        passed = {i: mh.success(T_gt, outcomes[i].T_est)
                  for i in range(en.RUNS)}
        row = dict(level=level, error_x1000=err,
                   card_passes=sum(passed.values()), **walls_line(outcomes))
        jax = surveys.get((f"extreme_noise_{sub}", "exact"))
        if jax is not None:
            row["jax_error_x1000"] = float(np.mean(
                [r["error_x1000"] for r in jax.values()]))
            row["jax_passes"] = sum(r["gate"] for r in jax.values())
        if level == 0.0:
            row["survey"] = survey_gate("extreme noise 0.0", passed,
                                        f"extreme_noise_{sub}")
        levels.append(row)
    emit("protocol", protocol="extreme_noise", algorithm="se3_pt2pl",
         config="EXTREME_NOISE", runs=en.RUNS, levels=levels, **line)


SCALING = {}     # bench-scaling's ladder, for the scaleout line


def scaling_run(total):
    """``bench-scaling --per-device 64`` through the CLI: 64 golden-like
    pairs a repetition, one batch in flight, fresh arrays each."""
    from se3_icp_tpu_torch import cli
    _, line, launches, printed = protocol_run(
        "bench-scaling", cli.main,
        ["bench-scaling", "--per-device", str(N_PAIRS), "--json"])
    rep = json.loads(printed.strip().splitlines()[-1])
    check_registration_launches("bench-scaling", launches)
    sum_launches(total, launches)
    from se3_icp_tpu_torch.bench import scaling_bench
    present = torch.cuda.device_count()
    check(rep["device_counts"] == scaling_bench.device_ladder(present)
          and rep["devices_present"] == present
          and rep["pairs_per_s"][0] > 0 and rep["platform"] == "gpu",
          f"bench-scaling: {rep}")
    SCALING.update(device_counts=rep["device_counts"],
                   devices_present=present,
                   pairs_per_s=rep["pairs_per_s"])
    emit("protocol", protocol="scaling", **rep, **line)


def engine_option_run(what, pair_list, problems, cfg, survey_name, total,
                      setup_route, exact_knn=False):
    """One option of the engine on the captured program: a call that
    captures, then a counted call, held bit for bit against the eager
    loop with no host sync, every pair gated (against the JAX package's
    survey ``survey_name``, or each within 2 deg / 0.25 where it is
    None); its setup timed eagerly on the card, one replay profiled.
    ``exact_knn``: the exact sorted-kNN setup (``setup_route`` "exact").
    Returns (results, the line's fields)."""
    from se3_icp_tpu_torch.models import registration as reg
    from se3_icp_tpu_torch.parallel import pairs
    from se3_icp_tpu_torch.utils import metrics_host as mh
    from se3_icp_tpu_torch.utils.config import parse_algorithm
    check(reg.loop_route("cuda", *parse_algorithm("se3_pt2pl")) == "graph",
          f"{what}: not on the captured program")
    with ProgramKeys() as keys:
        t0 = time.perf_counter()
        pairs.register_pairs(pair_list, "se3_pt2pl", cfg,
                             exact_knn=exact_knn)
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        zero_launches()
        torch.cuda.reset_peak_memory_stats()
        st = {}
        t0 = time.perf_counter()
        res = pairs.register_pairs(pair_list, "se3_pt2pl", cfg, stats=st,
                                   exact_knn=exact_knn)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 1e9
    hold_against_eager(what, lambda s: pairs.register_pairs(
        pair_list, "se3_pt2pl", cfg, stats=s, exact_knn=exact_knn), res, st)
    vs_eager = {k: PROGRAM_HOLDS[-1][k] for k in (
        "same_bits", "eager_loop_steps", "eager_host_syncs")}
    prof = profile_line(lambda: pairs.register_pairs(
        pair_list, "se3_pt2pl", cfg, exact_knn=exact_knn), emit_line=False)
    prof = {k: prof[k] for k in ("device_ms_total", "idle_share",
                                 "device_kernel_launches", "top")}
    prof["top"] = prof["top"][:6]
    check(launches["nn_match_affine"] == launches["loop_epilogue_batched"]
          == st["loop_steps"] > 0, f"{what}: loop launches {launches}")
    check_glue_launches(what, launches,
                        0 if cfg.anderson_m else st["loop_steps"])
    if setup_route == "exact":
        check(all(launches[k] == 0 for k in (
            "neighborhood_thresholds_batched", "moments_batched",
            "axis_sums_batched")), f"{what}: threshold setup ran {launches}")
    else:
        check(launches["neighborhood_thresholds_batched"] > 0,
              f"{what}: setup launches {launches}")
    sum_launches(total, launches)
    if survey_name is None:
        rot, tra = gate(problems, res, what)
        verdict = dict(card_passes=len(res), worst_rot_deg=rot,
                       worst_trans=tra)
    else:
        verdict = survey_gate(what, {
            i: mh.success(p.T_gt, r.transformation)
            for i, (p, r) in enumerate(zip(problems, res))}, survey_name)
    # the setup alone, eagerly on the card (CUDA events, median of 3)
    src, n_src, tgt, n_tgt = (torch.as_tensor(a, device="cuda") for a in
                              pairs.pack_pairs(pair_list))
    with torch.no_grad():
        floats, scfg = reg.split_cfg(cfg, torch.float32, "cuda")
        h = reg.hyper(floats)
        torch.cuda.reset_peak_memory_stats()
        setup_ms = time_ms(lambda: reg.setup(src, n_src, tgt, n_tgt, scfg,
                                             "se3", "pt2pl", h, exact_knn),
                           reps=3)
        setup_peak = torch.cuda.max_memory_allocated() / 1e9
    return res, dict(
        pairs=len(pair_list), bucket=4608, first_call_seconds=first,
        seconds=wall, ms_a_pair=wall * 1e3 / len(pair_list),
        iterations=[r.num_iterations for r in res],
        mean_iterations=float(np.mean([r.num_iterations for r in res])),
        pairs_at_cap=sum(r.num_iterations >= cfg.max_num_iterations
                         for r in res),
        loop_steps=st["loop_steps"], host_syncs=st["host_syncs"],
        eager_setup_ms=setup_ms, eager_setup_peak_gb=setup_peak,
        peak_mem_gb=peak, memory_reserved_gb=torch.cuda.memory_reserved()
        / 1e9, launches=launches, survey=verdict, vs_eager=vs_eager,
        profile=prof, **keys.line())


def shot_runs(total):
    """SHOT frames through ``register_pairs`` on the captured program:
    the main path's 64 pairs at 4608 with exact radius neighbourhoods,
    and 8 pairs with the capped route (``shot_exact=False``)."""
    from se3_icp_tpu_torch.utils.config import GOLDEN
    problems = golden_pairs(N_PAIRS)
    for exact, n in ((True, N_PAIRS), (False, SMALL_BATCH)):
        cfg = GOLDEN.replace(lrf_method="shot", shot_exact=exact)
        probs = problems[:n]
        _, line = engine_option_run(
            f"shot (shot_exact={exact})",
            [(p.source, p.target) for p in probs], probs, cfg,
            "golden_shot", total, "exact")
        emit("shot", algorithm="se3_pt2pl", config="GOLDEN",
             lrf_radius=cfg.lrf_radius, shot_exact=exact,
             shot_max_k=None if exact else cfg.shot_max_k, **line)


def anderson_runs(total):
    """Anderson acceleration through ``register_pairs`` on the captured
    program, ``anderson_m`` 3 and 5 beside the same call without it, at
    64 x 4608: the main path's pairs (GOLDEN, whose R3 phase is a step
    or two) and their noisy resampled versions with ``mse`` 1e-9 (a
    long R3 phase, where the accelerated step is taken)."""
    from se3_icp_tpu_torch.datasets.fixtures import NOISY
    from se3_icp_tpu_torch.utils.config import GOLDEN
    for tag, kw, base_cfg, name in (
            ("golden", {}, GOLDEN, "GOLDEN"),
            ("noisy", NOISY, GOLDEN.replace(mse=1e-9),
             "GOLDEN, mse 1e-9, NOISY problems")):
        problems = golden_pairs(N_PAIRS, **kw)
        pair_list = [(p.source, p.target) for p in problems]
        base = None
        for m in (0, 3, 5):
            survey = (f"{tag}_anderson_{m}"
                      if m or tag == "noisy" else None)
            _, line = engine_option_run(
                f"anderson {tag} m={m}", pair_list, problems,
                base_cfg.replace(anderson_m=m), survey, total, "threshold")
            if m == 0:
                base = line["iterations"]
            exact = {}
            if tag == "noisy":
                # the exact sorted-kNN setup on the same batch, beside
                # the threshold route and the JAX package's survey (its
                # exact route)
                _, ex = engine_option_run(
                    f"anderson {tag} m={m} exact", pair_list, problems,
                    base_cfg.replace(anderson_m=m), survey, total, "exact",
                    exact_knn=True)
                its = [r["iterations"] for r in
                       survey_pairs()[(survey, "exact")].values()]
                exact = dict(
                    exact_route=dict(
                        mean_iterations=ex["mean_iterations"],
                        pairs_at_cap=ex["pairs_at_cap"],
                        iterations=ex["iterations"], seconds=ex["seconds"],
                        vs_eager=ex["vs_eager"], survey=ex["survey"]),
                    jax_survey=dict(
                        mean_iterations=float(np.mean(its)),
                        pairs_at_cap=sum(
                            i >= base_cfg.max_num_iterations for i in its),
                        iterations=its))
            emit("anderson", problems=tag, algorithm="se3_pt2pl",
                 config=name, anderson_m=m,
                 pairs_with_other_iterations_than_m0=sum(
                     a != b for a, b in zip(line["iterations"], base)),
                 mean_iterations_m0=float(np.mean(base)), **line, **exact)


def bunny_phase():
    """The bunny protocols through their entry points and the CLI on
    the stand-in written here, then SHOT and Anderson on the captured
    program; returns their launches by path."""
    from se3_icp_tpu_torch.datasets import fixtures, synthetic
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        bunny = os.path.join(tmp, "bunny.ply")
        t0 = time.perf_counter()
        fixtures.write_bunny_standin(bunny)
        saved = os.environ.get(synthetic.BUNNY_ENV)
        os.environ[synthetic.BUNNY_ENV] = bunny
        try:
            emit("bunny_fixture", seconds=time.perf_counter() - t0,
                 points=fixtures.BUNNY_POINTS)
            total = out["bunny_protocols"] = {}
            bunny_cli_run(tmp)
            synthetic_runs(tmp, total)
            extreme_noise_runs(tmp, total)
            scaling_run(total)
        finally:
            if saved is None:
                os.environ.pop(synthetic.BUNNY_ENV)
            else:
                os.environ[synthetic.BUNNY_ENV] = saved
    shot_runs(out.setdefault("shot", {}))
    anderson_runs(out.setdefault("anderson", {}))
    emit("bunny", launches=out)
    return out


# --------------------------------------------------------------------
# Scale-out: the pairs mesh, the points route over a process group, the
# 2-D layout and the multi-process route, on the one card.

def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def slice_bounds(n, n_slices):
    return [(i * n // n_slices, (i + 1) * n // n_slices)
            for i in range(n_slices)]


def setup_slice_cases(tag, points, nv, counts, n_slices):
    """K1-K3's row-slice instances on ``n_slices`` slices of a cloud
    batch (the points route's rows): concatenated, the whole call's bits;
    each slice K1's plain bits, K2's plain counts and sums within
    K2_REL_TOL, K3 within K3_REL_TOL.  Returns the cases of the first
    slice (its time, its plain version's, its bound)."""
    from se3_icp_tpu_torch.ops import cuda_moments as cm, lrf
    cloud = cm.setup_cloud(points, nv)
    bsz, n, _ = points.shape
    cc = torch.tensor(counts, dtype=torch.int32,
                      device=points.device).expand(bsz, -1)
    thr = cm.neighborhood_thresholds_batched(points, nv, cc, cloud=cloud)
    mom = cm.moments_batched(points, nv, thr[:, 2], thr[:, 1], thr[:, 0],
                             cloud=cloud)
    normal_t, ndotq, radius = lrf.toldi_axis_inputs(mom, thr[:, 0],
                                                    counts[2])
    ax = cm.axis_sums_batched(points, nv, normal_t, ndotq, radius,
                              thr[:, 0], cloud=cloud)
    parts, first = [], None
    for rows in slice_bounds(n, n_slices):
        sl = slice(*rows)
        k1 = lambda: cm.neighborhood_thresholds_batched(
            points, nv, cc, cloud=cloud, rows=rows)
        t = k1()
        t_p = cm.neighborhood_thresholds_plain(points, nv, cc, cloud=cloud,
                                               rows=rows)
        check(torch.equal(t, t_p), f"{tag}: K1 slice {rows} differs from "
              "its plain version's bits")
        thr3 = (t[:, 2], t[:, 1], t[:, 0])
        k2 = lambda: cm.moments_batched(points, nv, *thr3, cloud=cloud,
                                        rows=rows)
        m = k2()
        m_p = cm.moments_plain(points, nv, *thr3, cloud=cloud, rows=rows)
        nv_rows = (nv - rows[0]).clamp(0, rows[1] - rows[0])
        for key in ("cen_cnt", "cov_cnt", "all_cnt"):
            check(torch.equal(m[key], m_p[key]),
                  f"{tag}: K2 slice {rows} {key} differs from plain")
        rel2 = max(row_rel_err(m[k], m_p[k], nv_rows)
                   for k in ("cen_sum", "cen_p9", "cov_sum", "cov_p9",
                             "all_sum"))
        check(rel2 <= K2_REL_TOL, f"{tag}: K2 slice {rows} sums differ by "
              f"{rel2:.2e}")
        ax_args = (normal_t[..., sl], ndotq[..., sl], radius[..., sl],
                   t[:, 0])
        k3 = lambda: cm.axis_sums_batched(points, nv, *ax_args, cloud=cloud,
                                          rows=rows)
        a = k3()
        a_p = cm.axis_sums_plain(points, nv, *ax_args, cloud=cloud,
                                 rows=rows)
        rel3 = max(row_rel_err(a[0], a_p[0], nv_rows),
                   row_rel_err(a[1], a_p[1], nv_rows))
        check(rel3 <= K3_REL_TOL, f"{tag}: K3 slice {rows} sums differ by "
              f"{rel3:.2e}")
        parts.append((t, m, a))
        if first is None:
            nq = rows[1] - rows[0]
            vq = nv_rows.double()
            nvd = nv.double()
            members = [float(((m[k] + 1.0)
                              * (torch.arange(nq, device=nv.device)[None]
                                 < nv_rows[:, None])).sum())
                       for k in ("cen_cnt", "cov_cnt", "all_cnt")]
            pairs_ops = 8 * float((vq * nvd).sum())
            shape = dict(B=bsz, N=n, rows=list(rows), slices=n_slices)
            first = [
                dict(name=f"neighborhood_thresholds_batched[{tag}, slice "
                     f"1 of {n_slices}]", max_abs_err=0.0, bit_equal=True,
                     concat_bits_equal_whole=True, ms=time_ms(k1, reps=5),
                     plain_ms=time_ms(lambda: cm.neighborhood_thresholds_plain(
                         points, nv, cc, cloud=cloud, rows=rows), reps=2),
                     **bound(pairs_ops + 2 * cm.CAND * sum(cm.plan(3))
                             * float(vq.sum()),
                             4 * bsz * (4 * n + 3 * nq),
                             op_rate=PEAK_F32_OPS_NO_FMA),
                     library_ms=None, shape=shape),
                dict(name=f"moments_batched[{tag}, slice 1 of {n_slices}]",
                     max_abs_err=rel2, counts_equal=True,
                     concat_bits_equal_whole=True, ms=time_ms(k2, reps=5),
                     plain_ms=time_ms(lambda: cm.moments_plain(
                         points, nv, *thr3, cloud=cloud, rows=rows), reps=2),
                     **bound(pairs_ops + 9 * max(members) + 10 * sum(members),
                             4 * bsz * (4 * n + nq * (1 + 3 + 30)),
                             op_rate=PEAK_F32_OPS_NO_FMA),
                     library_ms=None, shape=shape),
                dict(name=f"axis_sums_batched[{tag}, slice 1 of {n_slices}]",
                     max_abs_err=rel3, concat_bits_equal_whole=True,
                     ms=time_ms(k3, reps=5),
                     plain_ms=time_ms(lambda: cm.axis_sums_plain(
                         points, nv, *ax_args, cloud=cloud, rows=rows),
                         reps=2),
                     **bound(pairs_ops + 20 * members[2],
                             4 * bsz * (4 * n + nq * (1 + 6 + 4)),
                             op_rate=PEAK_F32_OPS_NO_FMA),
                     library_ms=None, shape=shape)]
    check(torch.equal(torch.cat([x[0] for x in parts], -1), thr),
          f"{tag}: K1 slices concatenated differ from the whole call")
    for key in mom:
        check(torch.equal(torch.cat([x[1][key] for x in parts], -1),
                          mom[key]),
              f"{tag}: K2 slices concatenated differ ({key})")
    for j in (0, 1):
        check(torch.equal(torch.cat([x[2][j] for x in parts], -1), ax[j]),
              f"{tag}: K3 slices concatenated differ from the whole call")
    return first


def match_slice_case(tag, ms, W, phase, n_slices):
    """K4 on ``n_slices`` row slices of ``feat16`` (the points route's):
    concatenated, the whole call's bits; the first slice against its
    plain version (``k4_case``)."""
    from se3_icp_tpu_torch.ops import cuda_knn
    d2, mt = cuda_knn.nn_match_affine(ms.feat16, W, ms.targets, phase)
    d2s, mts, first = [], [], None
    for rows in slice_bounds(ms.feat16.shape[1], n_slices):
        part = copy.copy(ms)
        part.feat16 = ms.feat16[:, rows[0]:rows[1]].contiguous()
        a, b = cuda_knn.nn_match_affine(part.feat16, W, ms.targets, phase)
        d2s.append(a)
        mts.append(b)
        if first is None:
            first = k4_case(f"nn_match_affine[{tag}, slice 1 of "
                            f"{n_slices}]", part, W, phase)
            first["concat_bits_equal_whole"] = True
    live = phase[:, 1] == 0
    check(torch.equal(torch.cat(d2s, 1)[live], d2[live])
          and torch.equal(torch.cat(mts, 2)[live], mt[live]),
          f"{tag}: K4 slices concatenated differ from the whole call")
    return first


def slice_phase_cases():
    """K1-K4's slice instances at R = 2, 4 on the main path's 64 x 4608
    sources and on one KITTI road pair (1 x 15872)."""
    from se3_icp_tpu_torch.utils.config import GOLDEN, KITTI_SE3
    out = {k: [] for k in ("k1", "k2", "k3", "k4")}
    dev = torch.device("cuda")
    road = kitti_road_pairs(1)
    for tag, problems, cfg in (("64 x 4608", golden_pairs(N_PAIRS), GOLDEN),
                               ("kitti road, 1 x 15872", road, KITTI_SE3)):
        (src, n_src), _ = setup_clouds(problems, cfg)
        ms, _ = match_state(problems, cfg, "se3_pt2pl")
        bsz = len(problems)
        false_b = torch.zeros(bsz, dtype=torch.bool, device=dev)
        W, phase, _ = loop_inputs(ms, cfg, false_b, false_b,
                                  torch.eye(4, device=dev).repeat(bsz, 1, 1))
        for n_slices in (2, 4):
            for key, case in zip(("k1", "k2", "k3"), setup_slice_cases(
                    tag, src, n_src, (90, 31, 30), n_slices)):
                out[key].append(case)
            out["k4"].append(match_slice_case(tag, ms, W, phase, n_slices))
        del ms, src
        torch.cuda.empty_cache()
    return out


_ROAD = {}


def kitti_road_pairs(n_pairs):
    """The first ``n_pairs`` pairs of the resampled KITTI road
    (``KITTI_FIXTURE``), as problems with their GT transforms; the
    fixture is written once."""
    from se3_icp_tpu_torch.bench import kitti_bench
    from se3_icp_tpu_torch.datasets import fixtures
    if "probs" not in _ROAD:
        with tempfile.TemporaryDirectory() as tmp:
            fixtures.make_kitti_fixture(tmp, **KITTI_FIXTURE)
            clouds, poses = kitti_bench.load_kitti(
                tmp, max_index=KITTI_FIXTURE["max_index"])
        _ROAD["probs"] = [types.SimpleNamespace(
            source=clouds[i + 1], target=clouds[i],
            T_gt=np.linalg.inv(poses[i]) @ poses[i + 1])
            for i in range(len(clouds) - 1)]
    return _ROAD["probs"][:n_pairs]


def pairs_mesh_runs(total):
    """The main path over meshes of the one card named 2 and 4 times,
    and 62 pairs over 4 (padded to 64): every pair's bits equal the
    unsharded call's; the setup checksum sharded equals unsharded."""
    from se3_icp_tpu_torch.parallel import pairs
    from se3_icp_tpu_torch.utils.config import GOLDEN
    problems = golden_pairs(N_PAIRS)
    pl = [(p.source, p.target) for p in problems]
    out = []
    for n_pairs in (N_PAIRS, 62):
        ref = pairs.register_pairs(pl[:n_pairs], "se3_pt2pl", GOLDEN,
                                   mesh=False)
        gate(problems[:n_pairs], ref, f"pairs mesh reference ({n_pairs})")
        for n_dev in ((2, 4) if n_pairs == N_PAIRS else (4,)):
            mesh = pairs.default_mesh(["cuda:0"] * n_dev)
            call = lambda st=None: pairs.register_pairs(
                pl[:n_pairs], "se3_pt2pl", GOLDEN, mesh=mesh, stats=st)
            call()                                   # captures the shards
            zero_launches()
            stats = {}
            t0 = time.perf_counter()
            got = call(stats)
            wall = time.perf_counter() - t0
            launches = read_launches()
            check(same_results(got, ref), f"pairs mesh x{n_dev}, {n_pairs} "
                  "pairs: other bits than the unsharded call")
            check_launches(f"pairs mesh x{n_dev}", launches,
                           stats["loop_steps"],
                           (2 * n_dev, 2 * n_dev, 2 * n_dev), prep=n_dev)
            sum_launches(total, launches)
            out.append(dict(pairs=n_pairs, mesh=n_dev, same_bits=True,
                            seconds=wall, loop_steps=stats["loop_steps"],
                            launches=launches))
    batch = [torch.as_tensor(a, device="cuda")
             for a in pairs.pack_pairs(pl)]
    whole = pairs.setup_checksum_batch(*batch, GOLDEN, "se3_pt2pl")
    for n_dev in (2, 4):
        got = pairs.setup_checksum_batch(
            *batch, GOLDEN, "se3_pt2pl",
            mesh=pairs.default_mesh(["cuda:0"] * n_dev))
        check(torch.equal(got, whole), f"setup checksum over x{n_dev} "
              "differs from the unsharded one")
    check(bool(torch.isfinite(whole).all()), "setup checksum not finite")
    return out, dict(checksum_bits_equal=True,
                     checksum_pair0=float(whole[0]),
                     batch_sizes=batch_size_holds())


def batch_size_runs(pair_list, run, sizes, first=8):
    """Per-pair results of the first ``first`` pairs of ``pair_list``,
    {name: list}: ``"B={first}"`` the pairs in one batch, ``"B={k}"`` in
    batches of each size k in ``sizes``, and ``"first {first} of {n}"``
    as the head of the whole list in one batch.  ``run(pairs, k)``
    registers ``pairs`` in batches of k and returns one result a pair.
    The batch-size holds of this script, of
    ``tests/test_torch_gpu_batch_bits.py`` and of ``tools/path_digest.py
    --batch-bits`` share it."""
    head = pair_list[:first]
    out = {f"B={k}": run(head, k) for k in (first, *sizes)}
    out[f"first {first} of {len(pair_list)}"] = run(
        pair_list, len(pair_list))[:first]
    return out


def one_call_a_batch(per_batch):
    """A ``run`` for ``batch_size_runs``: ``per_batch(pairs)`` (one result
    a pair) on each batch in turn."""
    return lambda pl, k: [r for b0 in range(0, len(pl), k)
                          for r in per_batch(pl[b0:b0 + k])]


def pairs_differing(runs, same, first=8):
    """{name: [pair]} of the pairs whose result in each run of
    ``batch_size_runs`` is not ``same`` as in one batch of ``first``."""
    ref = runs[f"B={first}"]
    return {name: [i for i, (a, b) in enumerate(zip(got, ref))
                   if not same(a, b)]
            for name, got in runs.items() if name != f"B={first}"}


def batch_size_holds():
    """A hold: for ``se3_pt2pl`` (the main path), ``se3_gicp``,
    ``se3_pt2pt`` and ``pt2pl``, 8 golden-shape pairs registered whole,
    in shards of 4, 2 and 1 (meshes naming the card 2, 4 and 8 times,
    each shard packed at its own width) and as the first 8 of a 64-pair
    batch give every pair the same transform bits and counts (G4's fixed
    order and the component-wise maps in and out of the preprocessed
    frame; with torch's reductions there, 2-3 iterations moved), and so
    do the eager loop's 8 pairs alone and in batches of 3; FGR the same
    (``fgr_batch_size_hold``)."""
    from se3_icp_tpu_torch.datasets.fixtures import SMALL_POSE
    from se3_icp_tpu_torch.parallel import pairs
    from se3_icp_tpu_torch.utils.config import GOLDEN
    out = {}
    for alg in ("se3_pt2pl", "se3_gicp", "se3_pt2pt", "pt2pl"):
        probs = golden_pairs(N_PAIRS, **(SMALL_POSE if alg == "pt2pl"
                                         else {}))

        def sharded(pl, k, alg=alg):
            mesh = (pairs.default_mesh(["cuda:0"] * (len(pl) // k))
                    if k < len(pl) else False)
            return pairs.register_pairs(pl, alg, GOLDEN, mesh=mesh)
        runs = batch_size_runs([(p.source, p.target) for p in probs],
                               sharded, sizes=(4, 2, 1))
        gate(probs[:8], runs["B=8"], f"{alg}, 8 pairs")
        line = {}
        for name, other in pairs_differing(
                runs, lambda a, b: same_results([a], [b])).items():
            line[name] = dict(pairs_with_other_bits=other)
            check(not other, f"{alg}: 8 pairs at {name} give pairs {other} "
                  "other bits or counts than the 8 whole")
        # the eager polled loop alone and in batches of 3 (the captured
        # program's reference)
        with EagerLoop():
            eager = batch_size_runs(
                [(p.source, p.target) for p in probs], one_call_a_batch(
                    lambda b, alg=alg: pairs.register_pairs(
                        b, alg, GOLDEN, mesh=False)), sizes=(1, 3))
        check(same_results(eager["B=8"], runs["B=8"]),
              f"{alg}: the eager loop's 8 pairs differ from the program's")
        for name, other in pairs_differing(
                eager, lambda a, b: same_results([a], [b])).items():
            line[f"eager {name}"] = dict(pairs_with_other_bits=other)
            check(not other, f"{alg}: the eager loop's 8 pairs at {name} "
                  f"give pairs {other} other bits than the 8 whole")
        out[alg] = dict(iterations=[r.num_iterations for r in runs["B=8"]],
                        **line)
    out["fgr"] = fgr_batch_size_hold()
    return out


def fgr_batch_size_hold():
    """FGR's 8 golden-shape pairs whole, in shards of 4, 2 and 1 and as
    the first 8 of 64 on its captured program, and eagerly
    (``fgr_register_arrays`` on the card) alone and in batches of 3:
    every pair the same transform bits and counts."""
    from se3_icp_tpu_torch.models import fgr
    from se3_icp_tpu_torch.parallel import pairs
    cfg = fgr.FGRConfig()
    probs = golden_pairs(N_PAIRS)
    pl = [(p.source, p.target) for p in probs]

    def per_pair(T, stats):
        return [(T[b].tolist(), stats["reciprocal"][b],
                 stats["kept_correspondences"][b]) for b in range(len(T))]

    def sharded(batch, k):
        mesh = (pairs.default_mesh(["cuda:0"] * (len(batch) // k))
                if k < len(batch) else False)
        st = {}
        res = pairs.register_pairs(batch, "fgr", cfg, mesh=mesh, stats=st)
        return per_pair([r.transformation for r in res], st)

    def eager(batch):
        st = {}
        T, _, _ = fgr.fgr_register_arrays(
            *(torch.as_tensor(a, device="cuda")
              for a in pairs.pack_pairs(batch)), cfg, stats=st)
        return per_pair(T.double().cpu().numpy(), st)
    runs = batch_size_runs(pl, sharded, sizes=(4, 2, 1))
    eager_runs = batch_size_runs(pl, one_call_a_batch(eager), sizes=(1, 3))
    line = {}
    for what, r in (("", runs), ("eager ", eager_runs)):
        for name, other in pairs_differing(r, lambda a, b: a == b).items():
            line[f"{what}{name}"] = dict(pairs_with_other_bits=other)
            check(not other, f"fgr: {what}8 pairs at {name} give pairs "
                  f"{other} other bits or counts than the 8 whole")
    check(runs["B=8"] == eager_runs["B=8"],
          "fgr: the eager function's 8 pairs differ from the program's")
    return dict(kept_correspondences=[r[2] for r in runs["B=8"]], **line)


def points_run(tag, src, n_src, tgt, n_tgt, cfg, algorithm, total,
               setup_launches, problems):
    """The points route on the world-1 NCCL group, a replay of its
    captured program with the all_gathers inside, against the eager
    loop on the same tensors (bits, loop steps, no host sync; every pair
    within 2 deg / 0.25), and for time against the points route's eager
    loop and ``register_arrays`` (the one-device program); ms a call
    and launches."""
    import torch.distributed as dist
    from se3_icp_tpu_torch.models import program, registration as reg
    from se3_icp_tpu_torch.parallel import points
    from se3_icp_tpu_torch.utils.config import parse_algorithm
    mode, variant = parse_algorithm(algorithm)
    args = (src, n_src, tgt, n_tgt, cfg)
    se, sg = {}, {}
    ref = reg.register_arrays_eager(*args, mode, variant, stats=se)
    got = points.register_arrays_points_sharded(*args, algorithm, stats=sg)
    check(all(torch.equal(a, b) for a, b in zip(got, ref)),
          f"points route ({tag}): other bits than the eager loop")
    check(sg["host_syncs"] == 0 and sg["loop_steps"] == se["loop_steps"],
          f"points route ({tag}): {sg} captured, {se} eager")
    PROGRAM_HOLDS.append(dict(
        path=f"points route ({tag})", route="graph", same_bits=True,
        loop_steps=sg["loop_steps"], host_syncs=sg["host_syncs"],
        eager_loop_steps=se["loop_steps"],
        eager_host_syncs=se["host_syncs"]))
    T = got[0].double().cpu().numpy()
    check(np.isfinite(T).all(), f"points route ({tag}): not finite")
    gate(problems, [types.SimpleNamespace(transformation=Ti) for Ti in T],
         f"points route ({tag})")
    graph = lambda: reg.register_arrays(*args, mode, variant)
    graph()
    zero_launches()
    stats = {}
    points.register_arrays_points_sharded(*args, algorithm, stats=stats)
    launches = read_launches()
    check_launches(f"points route ({tag})", launches, stats["loop_steps"],
                   setup_launches, prep=int(algorithm.startswith("se3")))
    sum_launches(total, launches)
    sharded = lambda: points.register_arrays_points_sharded(*args,
                                                            algorithm)
    entry = [e for e in program.info()["cached"]
             if e.get("points_group") == 1 and e["pairs"] == src.shape[0]
             and e["source_width"] == src.shape[1]]
    return dict(case=tag, algorithm=algorithm, shape=list(src.shape),
                route="graph",
                pool_bytes_added=[e["pool_bytes_added"] for e in entry],
                same_bits_as_eager=True, iterations=got[1].tolist()[:4],
                loop_steps=stats["loop_steps"],
                host_syncs=stats["host_syncs"], launches=launches,
                ms_points_route=time_ms(sharded, reps=3),
                ms_points_route_eager=time_ms(
                    lambda: reg.register_arrays_eager(
                        *args, mode, variant, group=dist.group.WORLD),
                    reps=3),
                ms_eager_loop=time_ms(
                    lambda: reg.register_arrays_eager(*args, mode, variant),
                    reps=3),
                ms_register_arrays=time_ms(graph, reps=3))


def scaleout_phase():
    """Scale-out on one card: the pairs mesh (the card named 2 and 4
    times), the setup checksum, K1-K4's slice instances against the
    whole call and their plain versions, the points route, the 2-D layout and the multi-process
    route on a world-1 NCCL group, each against the eager loop or the
    one-process call.  Returns (launches, kernel cases)."""
    import torch.distributed as dist
    from se3_icp_tpu_torch.parallel import multihost, pairs, points
    from se3_icp_tpu_torch.utils.config import GOLDEN, KITTI_SE3, \
        KITTI_VANILLA
    t_start = time.perf_counter()
    total = {}
    mesh_runs, checksum = pairs_mesh_runs(total)
    cases = slice_phase_cases()
    multihost.initialize(f"127.0.0.1:{free_port()}", 1, 0)
    pairs_group = points_group = None
    try:
        check(dist.get_backend() == "nccl", "the world group is not NCCL")
        from se3_icp_tpu_torch.models import registration as reg
        # one step's collective alone: the matched rows of one 4608-point
        # pair (P = 9) gathered, against a copy of them
        rows = torch.rand((1, 9, 4608), device="cuda")
        gather = dict(shape=[1, 9, 4608], ms_all_gather=time_ms(
            lambda: reg.gather_rows(rows, dist.group.WORLD, 2), reps=20),
            ms_clone=time_ms(lambda: rows.clone(), reps=20))
        runs = []
        golden = golden_pairs(1)
        road = kitti_road_pairs(32)
        # the KITTI pair from the identity: the online protocol's first
        # pair, under its configuration
        for tag, probs, cfg, alg, setup in (
                ("golden pair", golden, GOLDEN, "se3_pt2pl", (2, 2, 2)),
                ("kitti road pair", road[:1], KITTI_VANILLA, "pt2pl",
                 ALGORITHM_SETUP_LAUNCHES["pt2pl"])):
            batch = [torch.as_tensor(a, device="cuda") for a in
                     pairs.pack_pairs([(p.source, p.target) for p in probs])]
            runs.append(points_run(tag, *batch, cfg, alg, total, setup,
                                   probs))
        # the 2-D layout on 1 x 1 ranks, 32 road pairs, the batched
        # KITTI protocol's configuration
        pairs_group, points_group = points.mesh_2d(1, 1)
        batch = [torch.as_tensor(a, device="cuda") for a in
                 pairs.pack_pairs([(p.source, p.target) for p in road])]
        ref = reg.register_arrays_eager(*batch, KITTI_SE3, "se3", "pt2pl")
        points.register_batch_2d(*batch, KITTI_SE3, "se3_pt2pl",
                                 pairs_group, points_group)   # the capture
        stats = {}
        zero_launches()
        got = points.register_batch_2d(*batch, KITTI_SE3, "se3_pt2pl",
                                       pairs_group, points_group,
                                       stats=stats)
        launches = read_launches()
        check(all(torch.equal(a, b) for a, b in zip(got, ref)),
              "register_batch_2d (1 x 1): other bits than the eager loop")
        check_launches("register_batch_2d", launches, stats["loop_steps"],
                       (2, 2, 2))
        sum_launches(total, launches)
        gate(road, [types.SimpleNamespace(transformation=T)
                    for T in got[0].double().cpu().numpy()],
             "register_batch_2d on the road")
        grid = dict(layout="1 x 1", pairs=len(road),
                    shape=list(batch[0].shape), same_bits_as_eager=True,
                    loop_steps=stats["loop_steps"],
                    host_syncs=stats["host_syncs"], launches=launches)
        # the multi-process route, one process
        pl = [(p.source, p.target) for p in golden_pairs(N_PAIRS)]
        want = pairs.register_pairs(pl, "se3_pt2pl", GOLDEN, mesh=False)
        zero_launches()
        got = multihost.register_pairs_multihost(pl, "se3_pt2pl", GOLDEN)
        sum_launches(total, read_launches())
        check(same_results(got, want),
              "register_pairs_multihost (world 1): other bits than "
              "register_pairs")
    finally:
        from se3_icp_tpu_torch.models import program
        for g in (pairs_group, points_group, dist.group.WORLD):
            program.release_group(g)
        dist.destroy_process_group()
    emit("scaleout", seconds=time.perf_counter() - t_start,
         pairs_mesh=mesh_runs, **checksum,
         scaling=dict(SCALING, run="bench-scaling of the bunny phase"),
         slice_instances={k: [dict(name=c["name"], ms=c["ms"],
                                   plain_ms=c["plain_ms"],
                                   bound_ms=c["bound_ms"])
                              for c in v] for k, v in cases.items()},
         points_route=runs, world1_gather=gather, batch_2d=grid,
         multihost=dict(world=1, pairs=len(pl), same_bits=True),
         launches=total,
         note="collectives across several ranks are verified on the CPU "
              "over gloo; on cards, one card: world 1")
    return total, cases


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    from se3_icp_tpu_torch.ops import knn
    # the plain versions' matrix products in full float32, as the
    # port's entry points run theirs
    with knn.full_precision():
        return smoke()


PHASE_SECONDS = {}


def timed_phase(fn, *a, **kw):
    """``fn(*a, **kw)``, its wall time kept under its name for the
    ``total`` line."""
    t0 = time.perf_counter()
    out = fn(*a, **kw)
    PHASE_SECONDS[fn.__name__] = time.perf_counter() - t0
    return out


def smoke() -> int:
    t_start = time.perf_counter()
    device = timed_phase(device_phase)
    timed_phase(build_phase)
    k1_cases, k2_cases, k3_cases = timed_phase(setup_kernels_phase)
    k4_cases, k5_cases = timed_phase(kernels_phase)
    g1_cases, g2_cases, g3_cases, g4_cases = timed_phase(glue_kernels_phase)
    launches, results = timed_phase(main_path_phase)
    timed_phase(serving_phase)
    timed_phase(cli_phase)
    # the paths of the 1-NN kernels, each with its own launch counts
    ms_launches = timed_phase(multistart_phase,
                              with_profile="--profile" in sys.argv[1:])
    fgr_launches, feats = timed_phase(fgr_phase)
    metrics_launches = timed_phase(metrics_phase, results)
    ops_launches = timed_phase(ops_phase)
    timed_phase(cli_slice3_phase)
    proto_launches, proto_cases = timed_phase(protocols_phase)
    bunny_launches = timed_phase(bunny_phase)
    scaleout_launches, slice_cases = timed_phase(scaleout_phase)
    timed_phase(program_phase)
    for cases, key in ((k1_cases, "k1"), (k2_cases, "k2"), (k3_cases, "k3"),
                       (k4_cases, "k4"), (k5_cases, "k5")):
        cases.extend(proto_cases[key])
        cases.extend(slice_cases.get(key, []))
    k6_cases, k7_cases, k8_cases, k9_cases = timed_phase(nn_kernels_phase,
                                                         feats)
    del feats

    def entry(cases, key, source, replaces, counts=None):
        """``counts``: {path: launch counts} of the paths that run this
        kernel (default: the main path and the bench protocols)."""
        counts = counts or {"main_path": launches,
                            "protocols": proto_launches, **bunny_launches,
                            "scaleout": scaleout_launches}
        head = dict(cases[0])
        head.update(route="cuda", source=source, replaces=replaces,
                    launches=sum(c[key] for c in counts.values()),
                    launches_by_path={k: c[key] for k, c in counts.items()},
                    cases=cases[1:])
        return head

    kernels = [
        entry(k1_cases, "neighborhood_thresholds_batched",
              "se3_icp_tpu_torch/csrc/thresholds.cu",
              "se3_icp_tpu/ops/pallas_moments.py:457"),
        entry(k2_cases, "moments_batched",
              "se3_icp_tpu_torch/csrc/moments.cu",
              "se3_icp_tpu/ops/pallas_moments.py:45"),
        entry(k3_cases, "axis_sums_batched",
              "se3_icp_tpu_torch/csrc/moments.cu",
              "se3_icp_tpu/ops/pallas_moments.py:79"),
        entry(k4_cases, "nn_match_affine",
              "se3_icp_tpu_torch/csrc/match_affine.cu",
              "se3_icp_tpu/ops/pallas_knn.py:596"),
        entry(k5_cases, "loop_epilogue_batched",
              "se3_icp_tpu_torch/csrc/loop_epilogue.cu",
              "se3_icp_tpu/ops/pallas_loop.py:72"),
        entry(k6_cases, "nn_argmin_batched",
              "se3_icp_tpu_torch/csrc/nn_argmin.cu",
              "se3_icp_tpu/ops/pallas_knn.py:152",
              {"multistart": ms_launches, "fgr": fgr_launches,
               "bunny_protocols": bunny_launches["bunny_protocols"]}),
        entry(k7_cases, "nn_match_batched",
              "se3_icp_tpu_torch/csrc/nn_argmin.cu",
              "se3_icp_tpu/ops/pallas_knn.py:349", {"ops": ops_launches}),
        entry(k8_cases, "nn_match_packed",
              "se3_icp_tpu_torch/csrc/nn_argmin.cu",
              "se3_icp_tpu/ops/pallas_knn.py:489", {"ops": ops_launches}),
        entry(k9_cases, "nn_argmin_unbatched",
              "se3_icp_tpu_torch/csrc/nn_argmin.cu",
              "se3_icp_tpu/ops/pallas_knn.py:49",
              {"metrics": metrics_launches, "protocols": proto_launches}),
        # the glue kernels: no TPU kernel, the JAX package's XLA glue
        entry(g1_cases, "frame_inputs", "se3_icp_tpu_torch/csrc/frames.cu",
              "se3_icp_tpu/ops/lrf.py:579"),
        entry(g2_cases, "frame_assembly", "se3_icp_tpu_torch/csrc/frames.cu",
              "se3_icp_tpu/ops/lrf.py:599"),
        entry(g3_cases, "step_update", "se3_icp_tpu_torch/csrc/step_update.cu",
              "se3_icp_tpu/models/registration.py:651"),
        entry(g4_cases, "center_scale", "se3_icp_tpu_torch/csrc/prep.cu",
              "se3_icp_tpu/models/registration.py:209"),
    ]
    emit("total", seconds=time.perf_counter() - t_start,
         phase_seconds=PHASE_SECONDS)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
