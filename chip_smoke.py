#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``se3_icp_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU (written
for an H100, sm_90a) and the CUDA toolkit:

    python3 chip_smoke.py

It builds the CUDA kernels from ``se3_icp_tpu_torch/csrc``, holds each
kernel against its plain PyTorch version on the card at the main path's
shapes (64 pairs, 4608-point bucket), drives the main path through the
public entry points (``register_pairs`` with ``se3_pt2pl`` / ``GOLDEN``
on 64 seed-made golden-shape pairs, then smaller batches of the other
algorithms, then the CLI as a subprocess), gates every result at
2 deg / 0.25, and shows from the wrappers' launch counts that the main
path went through the kernels.  Every phase prints one JSON line; any
failed phase raises, so the exit code is non-zero and the final
``{"ok": true, ...}`` line is not printed.  Without a CUDA device it
exits with code 2 and prints no result.  ``--profile`` adds one line
with the main path's device time by kernel name.
"""

from __future__ import annotations

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
# outside the tensor cores, and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

N_PAIRS = 64                 # the main path's batch
SMALL_BATCH = 8              # the other algorithms' batch
K4_D2_TOL = 1e-4             # abs; d2 sums ~40-magnitude float32 terms
K4_FLIP_SHARE = 0.01         # rows whose two nearest targets tie in rounding
K5_REL_TOL = {"pt2pt": 1e-5, "pt2pl": 1e-5, "gicp": 1e-4}


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


def build_phase() -> None:
    from se3_icp_tpu_torch.ops import _build
    t0 = time.perf_counter()
    # forced: a library left by an earlier run must not hide a source
    # that no longer builds
    lib_path = _build.build(force=True, verbose=True)
    _build.load()
    emit("build", seconds=round(time.perf_counter() - t0, 3),
         sources=[os.path.relpath(s, ROOT) for s in _build.sources()],
         library=os.path.relpath(lib_path, ROOT))


def golden_pairs(n_pairs, **kw):
    from se3_icp_tpu_torch.datasets import fixtures
    return [fixtures.golden_shape_problem(seed=s, **kw)
            for s in range(1, n_pairs + 1)]


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
                            variant)
    return ms, pre


def loop_inputs(ms, cfg, switched, done, T):
    """W, phase and pf of one iteration at pose T, as the loop makes
    them."""
    from se3_icp_tpu_torch.models import registration as reg
    W, phase, pf = reg.iteration_inputs(ms, cfg, T, switched, done)
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
    err = float((d2_k[live] - d2_p[live]).abs().max())
    flips = (mt_k[live] != mt_p[live]).any(1)            # [Blive,Nq]
    share = float(flips.float().mean())
    same = ~flips
    pay_err = float(((mt_k[live] - mt_p[live]).abs().amax(1) * same).max())
    check(err <= K4_D2_TOL, f"{name}: d2 differs by {err} > {K4_D2_TOL}")
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
                tolerance=K4_D2_TOL, ms=ms_k, plain_ms=ms_p,
                bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                library_ms=None, shape=dict(B=bsz, Nq=nq, Nt=nt, P=p),
                active_pairs=n_live)


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
    # two runs give the same bits (fixed-order sums, no atomics)
    again = cuda_loop.loop_epilogue_batched(*args, **kw)
    check(all(bool((a == b).all()) for a, b in zip(out_k, again)),
          f"{name}: two runs of the kernel differ")
    ms_k = time_ms(lambda: cuda_loop.loop_epilogue_batched(*args, **kw))
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
                bitwise_repeatable=True, ms=ms_k, plain_ms=ms_p,
                bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                library_ms=None, shape=dict(B=bsz, N=n, P=p_rows),
                trim=cfg.estimated_overlap)


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
            k4_cases.append(k4_case("nn_match_affine[R3 phase, 1/3 done]",
                                    ms, W, phase))
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
    return k4_cases, k5_cases


def phases_line(problems):
    """Where one main-path call spends its time: the same batch through
    setup and loop separately, each ended by a synchronize."""
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
    packed, pack_s = timed(lambda: pairs.pack_pairs(pair_list))
    dev, upload_s = timed(lambda: [torch.as_tensor(a, device="cuda")
                                   for a in packed])
    src, n_src, tgt, n_tgt = dev
    with torch.no_grad():
        (ms, pre), setup_s = timed(lambda: reg.setup(
            src, n_src, tgt, n_tgt, GOLDEN, "se3", "pt2pl"))
        src_c, tgt_c, _ = reg.preprocess(src, n_src, tgt, n_tgt, GOLDEN,
                                         True)
        _, knn_s = timed(lambda: (knn.knn_self(src_c, 91, n_src),
                                  knn.knn_self(tgt_c, 91, n_tgt)))
        stats = {}
        _, loop_s = timed(lambda: reg.run_loop(ms, pre.scaling, GOLDEN,
                                               "se3", stats=stats))
    emit("phases", pairs=len(problems), host_pack_seconds=pack_s,
         upload_seconds=upload_s, setup_seconds=setup_s,
         setup_knn_seconds=knn_s, loop_seconds=loop_s,
         loop_steps=stats["loop_steps"],
         loop_ms_per_step=1e3 * loop_s / stats["loop_steps"])


def profile_line(pair_list):
    """``--profile``: device time of one main-path call by kernel name
    (torch.profiler), the ten largest."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from se3_icp_tpu_torch.parallel import pairs
    from se3_icp_tpu_torch.utils.config import GOLDEN
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pairs.register_pairs(pair_list, "se3_pt2pl", GOLDEN)
        torch.cuda.synchronize()
    # device kernels only: an operator's row repeats its kernels' time
    rows = sorted(((e.device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)
    total = sum(r[0] for r in rows)
    own = {tag: dict(ms=sum(r[0] for r in rows if tag in r[2]) / 1e3,
                     calls=sum(r[1] for r in rows if tag in r[2]))
           for tag in ("match_affine_kernel", "epilogue_kernel")}
    emit("profile", device_ms_total=total / 1e3,
         device_kernel_launches=sum(r[1] for r in rows),
         hand_written=own,
         top=[dict(ms=r[0] / 1e3, calls=r[1], name=r[2][:80])
              for r in rows[:10]])


def main_path_phase(with_profile: bool = False):
    """The port's main path through its public entry points."""
    from se3_icp_tpu_torch.datasets.fixtures import NOISY, SMALL_POSE
    from se3_icp_tpu_torch.ops import cuda_knn, cuda_loop
    from se3_icp_tpu_torch.parallel import pairs
    from se3_icp_tpu_torch.utils.config import GOLDEN, LOUNGE

    problems = golden_pairs(N_PAIRS)
    pair_list = [(p.source, p.target) for p in problems]
    check(all(len(p.source) == 4167 for p in problems), "cloud size")
    # warm-up call (allocator, cuBLAS/cuSOLVER handles), not counted
    t0 = time.perf_counter()
    pairs.register_pairs(pair_list[:SMALL_BATCH], "se3_pt2pl", GOLDEN)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    cuda_knn.nn_match_affine.launches = 0
    cuda_loop.loop_epilogue_batched.launches = 0
    stats = {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    results = pairs.register_pairs(pair_list, "se3_pt2pl", GOLDEN,
                                   stats=stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(
        nn_match_affine=cuda_knn.nn_match_affine.launches,
        loop_epilogue_batched=cuda_loop.loop_epilogue_batched.launches)
    rot, tra = gate(problems, results, "main path se3_pt2pl")
    iters = [r.num_iterations for r in results]
    for name, n in launches.items():
        check(n >= max(iters) > 0,
              f"main path launched {name} {n} times for {max(iters)} "
              "iterations")
    check(launches["nn_match_affine"] == stats["loop_steps"],
          "launch count and loop steps disagree")
    emit("main_path", algorithm="se3_pt2pl", config="GOLDEN",
         pairs=N_PAIRS, points=4167, bucket=4608, seconds=wall,
         pairs_per_s=N_PAIRS / wall, warmup_seconds=warm_s,
         mean_iterations=float(np.mean(iters)), max_iterations=max(iters),
         loop_steps=stats["loop_steps"], host_syncs=stats["host_syncs"],
         launches=launches, worst_rot_deg=rot, worst_trans=tra,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)

    phases_line(problems)
    if with_profile:
        profile_line(pair_list)

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
    emit("card_vs_cpu", pairs=2, points=600,
         iterations=[r.num_iterations for r in on_card], agree=True)

    # the other algorithms, smaller batches, same entry point and gate
    for alg, cfg, cfg_name, kw in (
            ("se3_gicp", GOLDEN, "GOLDEN", {}),
            ("se3_gicp_with_cf", LOUNGE, "LOUNGE", NOISY),
            ("se3_pt2pt", GOLDEN, "GOLDEN", {}),
            ("pt2pl", GOLDEN, "GOLDEN", SMALL_POSE)):
        probs = golden_pairs(SMALL_BATCH, **kw)
        walls = []
        for _ in range(2):      # the first call pays one-off library set-up
            st = {}
            cuda_knn.nn_match_affine.launches = 0
            cuda_loop.loop_epilogue_batched.launches = 0
            t0 = time.perf_counter()
            res = pairs.register_pairs(
                [(p.source, p.target) for p in probs], alg, cfg, stats=st)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        alg_launches = dict(
            nn_match_affine=cuda_knn.nn_match_affine.launches,
            loop_epilogue_batched=cuda_loop.loop_epilogue_batched.launches)
        rot, tra = gate(probs, res, alg)
        iters = [r.num_iterations for r in res]
        for name, n in alg_launches.items():
            check(n == st["loop_steps"] and n >= max(iters) > 0,
                  f"{alg} launched {name} {n} times for {max(iters)} "
                  f"iterations in {st['loop_steps']} loop steps")
        emit("algorithm_run", algorithm=alg, config=cfg_name, pairs=SMALL_BATCH,
             first_call_seconds=walls[0], seconds=walls[1],
             mean_iterations=float(np.mean(iters)), max_iterations=max(iters),
             loop_steps=st["loop_steps"], host_syncs=st["host_syncs"],
             launches=alg_launches, worst_rot_deg=rot, worst_trans=tra)
    return launches


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    from se3_icp_tpu_torch.ops import knn
    knn.require_full_precision()

    device = device_phase()
    build_phase()
    k4_cases, k5_cases = kernels_phase()
    launches = main_path_phase(with_profile="--profile" in sys.argv[1:])
    cli_phase()

    def entry(cases, key, source, replaces):
        head = dict(cases[0])
        head.update(route="cuda", source=source, replaces=replaces,
                    launches=launches[key], cases=cases[1:])
        return head

    kernels = [
        entry(k4_cases, "nn_match_affine",
              "se3_icp_tpu_torch/csrc/match_affine.cu",
              "se3_icp_tpu/ops/pallas_knn.py:596"),
        entry(k5_cases, "loop_epilogue_batched",
              "se3_icp_tpu_torch/csrc/loop_epilogue.cu",
              "se3_icp_tpu/ops/pallas_loop.py:72"),
    ]
    emit("total", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
