#!/usr/bin/env python3
"""Tiling factors of K4 (``csrc/match_affine.cu``), K1
(``csrc/thresholds.cu``), K2, K3 (``csrc/moments.cu``) and the tiled 1-NN
search of K6/K7/K8 (``csrc/nn_argmin.cu``), and the cluster and split
sizes of K5 (``csrc/loop_epilogue.cu``) and of the one-query-a-thread
search of K9, measured side by side on one card; and the glue kernels G2
(``csrc/frames.cu``) and G3 (``csrc/step_update.cu``) against other
sources of theirs.

    python3 tools/kernel_tiling_sweep.py [--only k4 k1 moments k5 nn glue]
                                         [--k4 THREADS,R,MINBLOCKS,U,U3 ...]
                                         [--k1 Q,WARPS ...]
                                         [--moments T2,R2,T3,R3 ...]
                                         [--k5 LEVELS ...]
                                         [--nn-tile R,C,COLS,THREADS,NARROW,WIDE,MINBLOCKS ...]
                                         [--reps N]
                                         [--extra-k4 LABEL=FILE.cu ...]
                                         [--extra-k1 LABEL=FILE.cu ...]
                                         [--extra-moments LABEL=FILE.cu ...]
                                         [--extra-k5 LABEL=FILE.cu ...]
                                         [--extra-nn LABEL=FILE.cu ...]
                                         [--extra-glue LABEL=DIR ...]

Each variant is the committed source with its ``constexpr`` tiling
factors replaced in a temporary copy (K4: ``kThreads``, ``kR``,
``kMinBlocks``, ``kU``, ``kU3``; K1: ``kQ``, ``kWarps``; K2/K3:
``kMomThreads``, ``kMomR``, ``kAxisThreads``, ``kAxisR``; K5: ``kLevels``,
the trim's bisection levels a counting pass; the tiled 1-NN search:
``kTR``, ``kTC`` (queries and targets a thread), ``kTCols`` (threads
that share a query), ``kTThreads``, ``kTTileNarrow``, ``kTTileWide``
(targets a staged tile at D <= 12 and above), ``kTMinBlocks``), compiled by nvcc with the package's flags and ``-Xptxas -v`` (registers,
spills, shared memory) into a library of its own, and called through the
same C entry point on the main path's inputs as ``chip_smoke.py`` makes
them (64 golden-shape pairs in the 4608 bucket; K4, K2 and K3 also at 8
x 15360): K4 in the SE(3) phase from the identity and in the R3 phase
near the answer, K1 on the sources with the main path's counts (90, 31,
30), K2 (also its one-ball instance, on the 31-ball) and K3 on the
sources and the targets with those counts' balls. The variants are timed
in turns (CUDA events, the median of ``--reps`` rounds), and each must
return the bits of the first variant, the committed factors.
K5's and the 1-NN kernels' variants are timed by their device time
(torch.profiler, ``per`` launches of each variant in turn a round; K5
also by events around one call, which is mostly the launch), and are
K5's cluster sizes C = 1, 2, 4, 8 (blocks a pair; the
wrapper's choice first), on the main path's pt2pl epilogue near the
answer with mixed phases at 64 x 4608 (whole and trimmed to 0.75) and at
8 x 15360 (each phase, whole and trimmed), gicp whole and gicp with
confidences trimmed.  The 1-NN kernels' are the tiled search's
tilings on K6 (64 x 4608 at D = 3, FGR's features at D = 33, and 8 x
15360 at D = 3), K7 (the main path's targets, D = 12, P = 9) and K8
(the engine's packed targets with mixed phases at 64 x 4608 and 8 x
15360), with the one-query-a-thread search at S = 1 beside K6 and K8
(the tiled search must return its bits); its target splits S = 1, 2, 4,
8 on one cloud (K9: 4608 points at D = 3, 15360 at D = 12).
``--extra-k4`` / ``--extra-k1`` / ``--extra-moments`` / ``--extra-k5`` /
``--extra-nn`` add other sources with the same C entry points (an
earlier version of the kernel, say) to the same turns; for them the bits
are compared and reported, not required. A ``moments.cu`` whose entry
points take no query order (the one before the order was added) is called
with its own arguments: it runs the queries in index order; so are a
``loop_epilogue.cu`` without the cluster argument and an ``nn_argmin.cu``
without the split argument (one block a pair, the unsplit search), and
an ``nn_argmin.cu`` without the tiled entry points runs K6 and K7 through
``se3icp_nn_argmin`` / ``se3icp_nn_match``, and one without the tiled K8
(``se3icp_nn_match_packed_batched``) runs K8 through
``se3icp_nn_match_packed``, at the S that K9's rule (``split_size``)
picks.
The committed sources are not changed.
``--only glue`` times the committed G2, G3 and G4 beside the
``frames.cu``, ``step_update.cu`` and ``prep.cu`` of each
``--extra-glue`` directory (e.g. another checkout's
``se3_icp_tpu_torch/csrc``) with the same C entry points (a
``prep.cu`` without the cluster argument is called with its own), by
device time in turns, and reports whether each gives the committed
kernel's bits (G4: its plain version's): G2
on the main path's sources (64 x 4608), its targets with the fused
normal and the KITTI road's bucket (1 x 15872); G3 two steps into the
loop of the main path's 64 pairs for pt2pl, GICP trimmed and pt2pt, a
fifth of the pairs done; G4 at 64 x 4608, 1 x 15872 and 1 x 4608, the
committed kernel at each cluster size C = 1, 2, 4, 8 (blocks a cloud;
``wrapper_cluster``: the C the wrapper picks).
``--sass DIR`` also writes each variant's machine code (``cuobjdump
-sass``) into DIR.  Needs a CUDA device and nvcc; prints one JSON line
per kernel.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

K4_FACTORS = ("kThreads", "kR", "kMinBlocks", "kU", "kU3")
K1_FACTORS = ("kQ", "kWarps")
MOMENTS_FACTORS = ("kMomThreads", "kMomR", "kAxisThreads", "kAxisR")
K5_FACTORS = ("kLevels",)
NN_TILE_FACTORS = ("kTR", "kTC", "kTCols", "kTThreads", "kTTileNarrow",
                   "kTTileWide", "kTMinBlocks")


def committed(text: str, names) -> tuple:
    return tuple(int(re.search(rf"constexpr int {n} = (\d+);", text)
                     .group(1)) for n in names)


def variant_source(text: str, names, values) -> str:
    for n, v in zip(names, values):
        text, k = re.subn(rf"constexpr int {n} = \d+;",
                          f"constexpr int {n} = {v};", text)
        if k != 1:
            raise RuntimeError(f"{n}: {k} definitions")
    return text


def build_all(jobs, tmp, sass_dir=None):
    """jobs: [(tag, source text)] -> {tag: (CDLL, ptxas log)}; one nvcc a
    variant, all started together."""
    from se3_icp_tpu_torch.ops import _build
    nvcc = _build.find_nvcc()
    procs = []
    for tag, text in jobs:
        src = os.path.join(tmp, f"{tag}.cu")
        with open(src, "w") as f:
            f.write(text)
        lib = os.path.join(tmp, f"lib{tag}.so")
        procs.append((tag, lib, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I",
             str(_build.CSRC), "-shared", src, "-o", lib],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    out = {}
    for tag, lib, p in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {tag}:\n{log}")
        out[tag] = (ctypes.CDLL(lib), log)
        if sass_dir:
            cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
            with open(os.path.join(sass_dir, f"{tag}.sass"), "w") as f:
                subprocess.run([cuobjdump, "-sass", lib], stdout=f,
                               stderr=subprocess.STDOUT, timeout=120)
    return out


def resources(log: str, entry: str) -> dict:
    import chip_smoke
    return {k: v for k, v in chip_smoke.ptxas_resources(log).items()
            if entry in k}


def time_turns(fns: dict, reps: int) -> dict:
    """{tag: fn} -> {tag: median ms}; one call of each in turn a round."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    times = {tag: [] for tag in fns}
    for _ in range(reps):
        for tag, fn in fns.items():
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            times[tag].append(a.elapsed_time(b))
    return {tag: statistics.median(t) for tag, t in times.items()}


def time_turns_device(fns: dict, reps: int, kernel: str,
                      per: int = 5) -> dict:
    """{tag: fn} -> {tag: median device ms of one launch}: a round
    profiles ``per`` calls of each fn in turn (torch.profiler) and takes
    the CUDA time of the kernels whose name holds ``kernel``.  For
    kernels of a few microseconds, where events around one call measure
    the launch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    times = {tag: [] for tag in fns}
    for _ in range(reps):
        for tag, fn in fns.items():
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(per):
                    fn()
                torch.cuda.synchronize()
            # the profiler may drop a launch's record now and then: the
            # mean over those it kept
            rows = [e for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA and kernel in e.key]
            calls = sum(e.count for e in rows)
            if calls:
                times[tag].append(sum(e.device_time_total for e in rows)
                                  / calls / 1e3)
    for tag, t in times.items():
        if len(t) < (reps + 1) // 2:
            raise RuntimeError(f"{tag}: {kernel} profiled in {len(t)} of "
                               f"{reps} rounds")
    return {tag: statistics.median(t) for tag, t in times.items()}


def k4_cases():
    import chip_smoke as cs
    from se3_icp_tpu_torch.utils.config import GOLDEN
    dev = torch.device("cuda")
    cases = []
    for n_pairs, kw in ((cs.N_PAIRS, {}), (cs.SMALL_BATCH, {"n": 15000})):
        problems = cs.golden_pairs(n_pairs, **kw)
        ms, pre = cs.match_state(problems, GOLDEN, "se3_pt2pl")
        off = torch.zeros(n_pairs, dtype=torch.bool, device=dev)
        eye = torch.eye(4, device=dev).repeat(n_pairs, 1, 1)
        shape = f"{n_pairs} x {ms.feat16.shape[1]}"
        W, phase, _ = cs.loop_inputs(ms, GOLDEN, off, off, eye)
        cases.append((f"{shape}, SE(3)", ms, W, phase))
        W, phase, _ = cs.loop_inputs(ms, GOLDEN, ~off, off,
                                     cs.near_gt_pose(problems, pre, dev))
        cases.append((f"{shape}, R3", ms, W, phase))
    return cases


def extra_sources(specs, prefix):
    """``LABEL=FILE`` specs -> [(tag, label, source text)]."""
    out = []
    for spec in specs:
        label, path = spec.split("=", 1)
        with open(path) as f:
            out.append((f"{prefix}_{label}", label, f.read()))
    return out


def sweep_k4(variants, reps, sass_dir, extras=()):
    from se3_icp_tpu_torch.ops import _build
    text = (_build.CSRC / "match_affine.cu").read_text()
    variants = [committed(text, K4_FACTORS)] + [
        v for v in variants if v != committed(text, K4_FACTORS)]
    tags = ["k4_" + "_".join(map(str, v)) for v in variants]
    extras = extra_sources(extras, "k4")
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_all([(t, variant_source(text, K4_FACTORS, v))
                          for t, v in zip(tags, variants)]
                         + [(t, src) for t, _, src in extras], tmp, sass_dir)
        rows = {t: dict(zip(K4_FACTORS, v), ptxas=resources(
            libs[t][1], "match_affine_kernel"), ms={})
            for t, v in zip(tags, variants)}
        for t, label, _ in extras:
            rows[t] = dict(source=label, ptxas=resources(
                libs[t][1], "match_affine_kernel"), ms={}, same_bits={})
        tags = tags + [t for t, _, _ in extras]
        for name, ms, W, phase in k4_cases():
            bsz, nq, _ = ms.feat16.shape
            nt, p = ms.targets.payload.shape[1:]
            t = ms.targets
            outs = {}

            def call(lib, tag):
                d2 = torch.empty((bsz, nq), device="cuda")
                mt = torch.empty((bsz, p, nq), device="cuda")
                outs[tag] = (d2, mt)

                def run():
                    _build.check(lib.se3icp_match_affine(
                        ms.feat16.data_ptr(), W.data_ptr(),
                        t.emb.data_ptr(), t.tn.data_ptr(),
                        t.payload.data_ptr(), t.n.data_ptr(),
                        phase.data_ptr(), d2.data_ptr(), mt.data_ptr(),
                        bsz, nq, nt, p,
                        torch.cuda.current_stream().cuda_stream), tag)
                return run

            fns = {}
            for tag in tags:
                lib = libs[tag][0]
                lib.se3icp_match_affine.argtypes = \
                    _build.SIGNATURES["se3icp_match_affine"]
                fns[tag] = call(lib, tag)
            med = time_turns(fns, reps)
            ref = outs[tags[0]]
            for tag in tags:
                same = all(torch.equal(a, b) for a, b in zip(outs[tag], ref))
                if "same_bits" in rows[tag]:
                    rows[tag]["same_bits"][name] = same
                elif not same:
                    raise RuntimeError(f"{tag}: other bits than the "
                                       f"committed factors on {name}")
                rows[tag]["ms"][name] = med[tag]
        return list(rows.values())


def sweep_k1(variants, reps, sass_dir, extras=()):
    import chip_smoke as cs
    from se3_icp_tpu_torch.ops import _build
    from se3_icp_tpu_torch.ops import cuda_moments as cm
    text = (_build.CSRC / "thresholds.cu").read_text()
    variants = [committed(text, K1_FACTORS)] + [
        v for v in variants if v != committed(text, K1_FACTORS)]
    tags = ["k1_" + "_".join(map(str, v)) for v in variants]
    extras = extra_sources(extras, "k1")
    (pts, nv), _ = cs.setup_clouds(cs.golden_pairs(cs.N_PAIRS))
    cc = torch.tensor([90, 31, 30], dtype=torch.int32,
                      device=pts.device).expand(pts.shape[0], -1)
    cloud, ccs, hib, _ = cm._threshold_inputs(pts, nv, cc, None)
    bsz, _, n = cloud.pts_t.shape
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_all([(t, variant_source(text, K1_FACTORS, v))
                          for t, v in zip(tags, variants)]
                         + [(t, src) for t, _, src in extras], tmp, sass_dir)
        outs, fns = {}, {}
        for tag in tags + [t for t, _, _ in extras]:
            lib = libs[tag][0]
            lib.se3icp_thresholds.argtypes = \
                _build.SIGNATURES["se3icp_thresholds"]
            out = outs[tag] = torch.empty((bsz, 3, n), device="cuda")

            def run(lib=lib, out=out, tag=tag):
                _build.check(lib.se3icp_thresholds(
                    cloud.pts_t.data_ptr(), cloud.tn.data_ptr(),
                    cloud.n.data_ptr(), ccs.data_ptr(), hib.data_ptr(),
                    out.data_ptr(), bsz, n, 3,
                    torch.cuda.current_stream().cuda_stream), tag)
            fns[tag] = run
        med = time_turns(fns, reps)
        rows = []
        for tag, v in zip(tags, variants):
            if not torch.equal(outs[tag], outs[tags[0]]):
                raise RuntimeError(f"{tag}: other bits than the committed "
                                   "factors")
            rows.append(dict(zip(K1_FACTORS, v), ptxas=resources(
                libs[tag][1], "thresholds_kernelILi3E"),
                ms={f"{bsz} x {n}, T=3": med[tag]}))
        for tag, label, _ in extras:
            rows.append(dict(source=label, ptxas=resources(
                libs[tag][1], "thresholds_kernelILi3E"),
                ms={f"{bsz} x {n}, T=3": med[tag]},
                same_bits=torch.equal(outs[tag], outs[tags[0]])))
        return rows


def moments_cases():
    """[(name, cloud, K2's shifted thresholds, K3's normals, K3's aux)] on
    the main path's clouds and on 8 sources in the KITTI bucket."""
    import chip_smoke as cs
    from se3_icp_tpu_torch.ops import cuda_moments as cm, lrf
    cases = []
    clouds = cs.setup_clouds(cs.golden_pairs(cs.N_PAIRS))
    big, _ = cs.setup_clouds(cs.golden_pairs(cs.SMALL_BATCH, n=15000))
    for side, (pts, nv) in (("sources", clouds[0]), ("targets", clouds[1]),
                            ("sources", big)):
        cc = torch.tensor([90, 31, 30], dtype=torch.int32,
                          device=pts.device).expand(pts.shape[0], -1)
        cloud = cm.setup_cloud(pts, nv)
        thr = cm.neighborhood_thresholds_batched(pts, nv, cc, cloud=cloud)
        thr3 = (thr[:, 2], thr[:, 1], thr[:, 0])
        _, thr_s = cm._moments_inputs(pts, nv, thr3, cloud)
        mom = cm.moments_batched(pts, nv, *thr3, cloud=cloud)
        normal_t, ndotq, radius = lrf.toldi_axis_inputs(mom, thr[:, 0], 30)
        _, nrm, aux = cm._axis_inputs(pts, nv, normal_t, ndotq, radius,
                                      thr[:, 0], cloud)
        cases.append((f"{pts.shape[0]} x {pts.shape[1]} {side}", cloud,
                      thr_s, nrm, aux))
    return cases


def moments_calls(lib, tag, indexed, cloud, thr_s, nrm, aux, outs):
    """{kernel: call} of one library on one case: K2, K3 and, where the
    library has it, K2's one-ball instance on the second ball; each call
    leaves its result in ``outs[(kernel, tag)]``.  ``indexed``: the entry
    points take no query order (and no ball count)."""
    from se3_icp_tpu_torch.ops import _build
    P, I = ctypes.c_void_p, ctypes.c_int
    bsz, balls, n = thr_s.shape
    if indexed:
        lib.se3icp_moments.argtypes = [P] * 5 + [I] * 2 + [P]
        lib.se3icp_axis.argtypes = [P] * 6 + [I] * 2 + [P]
    else:
        for name in ("se3icp_moments", "se3icp_axis"):
            getattr(lib, name).argtypes = _build.SIGNATURES[name]
    head = (cloud.pts_t.data_ptr(), cloud.tn.data_ptr(), cloud.n.data_ptr())
    if not indexed:
        head += (cloud.order.data_ptr(),)
    stream = lambda: torch.cuda.current_stream().cuda_stream

    def k2(key="K2", thr=thr_s):
        m = thr.shape[1]
        raw = torch.empty((bsz, 10 * m, n), device="cuda")
        extra = () if indexed else (m,)
        _build.check(lib.se3icp_moments(
            *head, thr.data_ptr(), raw.data_ptr(), bsz, n, *extra,
            stream()), tag)
        outs[(key, tag)] = raw

    def k3():
        out = torch.empty((bsz, 4, n), device="cuda")
        _build.check(lib.se3icp_axis(
            *head, nrm.data_ptr(), aux.data_ptr(), out.data_ptr(), bsz, n,
            stream()), tag)
        outs[("K3", tag)] = out
    calls = {"K2": k2, "K3": k3}
    if not indexed:
        one = thr_s[:, 1:2].contiguous()
        calls["K2 one ball"] = lambda: k2("K2 one ball", one)
    return calls


def sweep_moments(variants, reps, sass_dir, extras=()):
    from se3_icp_tpu_torch.ops import _build
    text = (_build.CSRC / "moments.cu").read_text()
    variants = [committed(text, MOMENTS_FACTORS)] + [
        v for v in variants if v != committed(text, MOMENTS_FACTORS)]
    tags = ["mom_" + "_".join(map(str, v)) for v in variants]
    extras = extra_sources(extras, "mom")
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_all([(t, variant_source(text, MOMENTS_FACTORS, v))
                          for t, v in zip(tags, variants)]
                         + [(t, src) for t, _, src in extras], tmp, sass_dir)
        rows, how = {}, {}
        for t, v in zip(tags, variants):
            rows[t] = dict(zip(MOMENTS_FACTORS, v), ms={})
            how[t] = False
        for t, label, src in extras:
            rows[t] = dict(source=label, ms={}, same_bits={})
            how[t] = "const void* order" not in src
        for t in rows:
            rows[t]["ptxas"] = {
                k: v for k, v in resources(libs[t][1], "").items()
                if "moments_kernel" in k or "axis_kernel" in k}
        tags = list(rows)
        for name, cloud, thr_s, nrm, aux in moments_cases():
            outs = {}
            calls = {t: moments_calls(libs[t][0], t, how[t], cloud, thr_s,
                                      nrm, aux, outs) for t in tags}
            for kernel in calls[tags[0]]:
                has = [t for t in tags if kernel in calls[t]]
                med = time_turns({t: calls[t][kernel] for t in has}, reps)
                ref = outs[(kernel, tags[0])]
                for t in has:
                    case = f"{kernel} {name}"
                    same = torch.equal(outs[(kernel, t)], ref)
                    if "same_bits" in rows[t]:
                        rows[t]["same_bits"][case] = same
                    elif not same:
                        raise RuntimeError(f"{t}: other bits than the "
                                           f"committed factors on {case}")
                    rows[t]["ms"][case] = med[t]
        return list(rows.values())


def stream():
    return torch.cuda.current_stream().cuda_stream


def k5_cases():
    """[(name, args, kw)] of K5 as the loop calls it: the pt2pl state of
    the main path (and at 8 x 15360) near the answer, and the gicp state
    with confidences."""
    import chip_smoke as cs
    from se3_icp_tpu_torch.models import registration as reg
    from se3_icp_tpu_torch.ops import cuda_knn
    from se3_icp_tpu_torch.utils.config import GOLDEN, LOUNGE
    dev = torch.device("cuda")
    out = []
    for n_pairs, kw, alg, base, phases, overlaps in (
            (cs.N_PAIRS, {}, "se3_pt2pl", GOLDEN, ("mixed",), (1.0, 0.75)),
            (cs.SMALL_BATCH, {"n": 15000}, "se3_pt2pl", GOLDEN,
             ("SE(3)", "R3"), (1.0, 0.75)),
            (cs.N_PAIRS, {}, "se3_gicp", GOLDEN, ("mixed",), (1.0,)),
            (cs.N_PAIRS, {}, "se3_gicp_with_cf", LOUNGE, ("mixed",),
             (0.75,))):
        problems = cs.golden_pairs(n_pairs, **kw)
        ms, pre = cs.match_state(problems, base, alg)
        near = cs.near_gt_pose(problems, pre, dev)
        off = torch.zeros(n_pairs, dtype=torch.bool, device=dev)
        for ph in phases:
            switched = {"mixed": torch.arange(n_pairs, device=dev) % 2 == 1,
                        "SE(3)": off, "R3": ~off}[ph]
            for overlap in overlaps:
                cfg = base.replace(estimated_overlap=overlap)
                W, phase, pf = cs.loop_inputs(ms, cfg, switched, off, near)
                _, mt = cuda_knn.nn_match_affine(ms.feat16, W, ms.targets,
                                                 phase)
                name = (f"{n_pairs} x {ms.src_cT.shape[2]} {ms.variant}"
                        f"{'+cf' if ms.use_cf else ''}, {ph} phase"
                        f"{'s' if ph == 'mixed' else ''}, overlap {overlap}")
                out.append((name, (ms.src_cT, mt, pf, ms.cov_src6,
                                   ms.conf_src),
                            reg.epilogue_options(ms, cfg)))
    return out


def sweep_k5(variants, reps, sass_dir, extras=()):
    from se3_icp_tpu_torch.ops import _build, cuda_loop
    text = (_build.CSRC / "loop_epilogue.cu").read_text()
    mine = committed(text, K5_FACTORS)
    variants = [v for v in variants if v != mine]
    extras = extra_sources(extras, "k5")
    P, I = ctypes.c_void_p, ctypes.c_int
    with tempfile.TemporaryDirectory() as tmp:
        levels = [(f"k5_{v[0]}", variant_source(text, K5_FACTORS, v))
                  for v in variants]
        libs = build_all([("k5", text)] + levels
                         + [(t, src) for t, _, src in extras], tmp, sass_dir)
        rows = {f"C={c}": dict(zip(K5_FACTORS, mine), cluster=c, ms={},
                               ptxas=resources(libs["k5"][1],
                                               "epilogue_kernel"))
                for c in (1, 2, 4, 8)}
        # other factors: at the wrapper's cluster size
        for (t, _), v in zip(levels, variants):
            rows[t] = dict(zip(K5_FACTORS, v), cluster="the wrapper's",
                           ms={}, ptxas=resources(libs[t][1],
                                                  "epilogue_kernel"))
        for t, label, _ in extras:
            rows[t] = dict(source=label, ms={}, same_bits={},
                           ptxas=resources(libs[t][1], "epilogue_kernel"))
        lib = libs["k5"][0]
        for t in ["k5"] + [t for t, _ in levels]:
            libs[t][0].se3icp_loop_epilogue.argtypes = \
                _build.SIGNATURES["se3icp_loop_epilogue"]
        for t, _, src in extras:
            # an entry point without the cluster argument: one block a pair
            own = "int cluster" not in src
            libs[t][0].se3icp_loop_epilogue.argtypes = (
                [P] * 8 + [I] * 12 + [P] if own
                else _build.SIGNATURES["se3icp_loop_epilogue"])
            rows[t]["own_signature"] = own
        for name, args, kw in k5_cases():
            srcT, mt, pf, cov6, conf = args
            bsz, _, n = srcT.shape
            head = (srcT.data_ptr(), mt.data_ptr(), pf.data_ptr(),
                    None if kw["variant"] != "gicp" else cov6.data_ptr(),
                    conf.data_ptr() if kw["use_cf"] else None)
            tail = (bsz, n, mt.shape[1], cuda_loop._VARIANT_CODE[kw["variant"]],
                    int(kw["is_se3"]), int(kw["use_cf"]), int(kw["do_trim"]),
                    kw["off_tr"], kw["off_nrm"], kw["off_cov"],
                    kw["off_conf"], cuda_loop.index_steps(n))
            outs, fns = {}, {}

            def call(fn, tag, extra):
                out = outs[tag] = torch.empty(bsz * 52, device="cuda")
                ptrs = (out.data_ptr(), out.data_ptr() + 4 * bsz * 36,
                        out.data_ptr() + 4 * bsz * 44)

                def run():
                    _build.check(fn(*head, *ptrs, *tail, *extra, stream()),
                                 tag)
                return run
            chosen = cuda_loop.cluster_size(bsz, srcT.device, kw["do_trim"])
            order = [f"C={chosen}"] + [t for t in rows if t != f"C={chosen}"]
            for tag in order:
                if tag.startswith("C="):
                    fns[tag] = call(lib.se3icp_loop_epilogue, tag,
                                    (rows[tag]["cluster"],))
                elif "source" not in rows[tag]:
                    fns[tag] = call(libs[tag][0].se3icp_loop_epilogue, tag,
                                    (chosen,))
                else:
                    fn = libs[tag][0].se3icp_loop_epilogue
                    fns[tag] = call(fn, tag, () if rows[tag]["own_signature"]
                                    else (chosen,))
            med = time_turns_device(fns, reps, "epilogue_kernel")
            events = time_turns(fns, reps)
            ref = outs[f"C={chosen}"]
            for tag in order:
                same = torch.equal(outs[tag], ref)
                if "same_bits" in rows[tag]:
                    rows[tag]["same_bits"][name] = same
                elif not same:
                    raise RuntimeError(f"K5 {tag}: other bits than C = "
                                       f"{chosen} on {name}")
                rows[tag]["ms"][name] = med[tag]
                rows[tag].setdefault("ms_events", {})[name] = events[tag]
            rows[f"C={chosen}"].setdefault("chosen_for", []).append(name)
        return list(rows.values())


def nn_cases():
    """[(kernel, name, q, t, n, payload, packed phase)] of the 1-NN
    kernels at their paths' shapes."""
    import chip_smoke as cs
    from se3_icp_tpu_torch.models import fgr
    from se3_icp_tpu_torch.parallel import pairs
    from se3_icp_tpu_torch.utils.config import GOLDEN
    dev = torch.device("cuda")
    problems = cs.golden_pairs(cs.N_PAIRS)
    q3, t3, n3 = cs.moved_sources(problems, dev)
    big = cs.golden_pairs(cs.SMALL_BATCH, n=15000)
    qb, tb, nb = cs.moved_sources(big, dev)
    out = [("K9", "K9 4608, D=3", q3[:1].contiguous(), t3[:1].contiguous(),
            n3[:1].contiguous(), None, None),
           ("K9", "K9 15360, D=12", cs.embedding12(qb[:1], 1),
            cs.embedding12(tb[:1], 2), nb[:1].contiguous(), None, None),
           ("K6", "K6 64 x 4608, D=3", q3, t3, n3, None, None),
           ("K6", "K6 8 x 15360, D=3", qb, tb, nb, None, None)]
    src, n_src, tgt, n_tgt = (torch.as_tensor(a, device=dev) for a in
                              pairs.pack_pairs([(p.source, p.target)
                                                for p in problems]))
    cfg = fgr.FGRConfig()
    fs, ft = fgr.features(src, n_src, cfg), fgr.features(tgt, n_tgt, cfg)
    out.append(("K6", "K6 64 x 4608, D=33 (FGR features)", fs, ft, n_tgt,
                None, None))
    ms, pre = cs.match_state(problems, GOLDEN, "se3_pt2pl")
    off = torch.zeros(cs.N_PAIRS, dtype=torch.bool, device=dev)
    near = cs.near_gt_pose(problems, pre, dev)
    W, _, _ = cs.loop_inputs(ms, GOLDEN, off, off, near)
    q12 = (ms.feat16 @ W)[..., :12].contiguous()
    out.append(("K7", "K7 64 x 4608, D=12, P=9", q12,
                ms.targets.emb[:, 0].contiguous(), ms.targets.n,
                ms.targets.payload, None))
    switched = torch.arange(cs.N_PAIRS, device=dev) % 2 == 1
    W, phase, _ = cs.loop_inputs(ms, GOLDEN, switched, off, near)
    q12 = (ms.feat16 @ W)[..., :12].contiguous()
    out.append(("K8", "K8 64 x 4608, mixed phases", q12, ms.targets,
                ms.targets.n, ms.targets.payload, phase[:, 0].contiguous()))
    q12, targets, phase = cs.packed_big(big, dev)
    out.append(("K8", "K8 8 x 15360, mixed phases", q12, targets, targets.n,
                targets.payload, phase))
    return out


def nn_call(lib, route, q, t, n, payload, phase, split):
    """One launch of the case's entry point in ``lib`` -> (run, outputs).
    ``route``: "tiled" (the tiled search's entry points
    ``se3icp_nn_argmin_batched`` / ``se3icp_nn_match_batched`` /
    ``se3icp_nn_match_packed_batched``), "split" (``se3icp_nn_argmin`` /
    ``se3icp_nn_match`` / ``se3icp_nn_match_packed`` with ``split``) or
    "own" (the same without the split argument: an older source)."""
    from se3_icp_tpu_torch.ops import _build
    P, I = ctypes.c_void_p, ctypes.c_int
    bsz, nq, d = q.shape
    extra = (split,) if route == "split" else ()
    idx = torch.empty((bsz, nq), dtype=torch.int32, device="cuda")
    d2 = torch.empty((bsz, nq), device="cuda")
    if payload is None:
        if route == "tiled":
            fn = lib.se3icp_nn_argmin_batched
        else:
            fn = lib.se3icp_nn_argmin
        fn.argtypes = [P] * 5 + [I] * (4 + len(extra)) + [P]
        args = (q.data_ptr(), t.data_ptr(), n.data_ptr(), idx.data_ptr(),
                d2.data_ptr(), bsz, nq, t.shape[1], d)
        return (lambda: _build.check(fn(*args, *extra, stream()), "nn")), \
            (idx, d2)
    m = torch.empty((bsz, nq, payload.shape[2]), device="cuda")
    if phase is None:
        if route == "tiled":
            fn = lib.se3icp_nn_match_batched
        else:
            fn = lib.se3icp_nn_match
        fn.argtypes = [P] * 7 + [I] * (5 + len(extra)) + [P]
        args = (q.data_ptr(), t.data_ptr(), payload.data_ptr(), n.data_ptr(),
                idx.data_ptr(), d2.data_ptr(), m.data_ptr(), bsz, nq,
                t.shape[1], d, payload.shape[2])
    else:
        if route == "tiled":
            fn = lib.se3icp_nn_match_packed_batched
        else:
            fn = lib.se3icp_nn_match_packed
        fn.argtypes = [P] * 9 + [I] * (4 + len(extra)) + [P]
        args = (q.data_ptr(), t.emb.data_ptr(), t.tn.data_ptr(),
                payload.data_ptr(), n.data_ptr(), phase.data_ptr(),
                idx.data_ptr(), d2.data_ptr(), m.data_ptr(), bsz, nq,
                t.emb.shape[2], payload.shape[2])
    return (lambda: _build.check(fn(*args, *extra, stream()), "nn")), \
        (idx, d2, m)


def nn_instances(log: str) -> dict:
    """ptxas resources of the 1-NN kernels by readable instance name."""
    import chip_smoke
    out = {}
    for k, v in chip_smoke.ptxas_resources(log).items():
        m = re.search(r"(nn_tiled_kernel|nn_kernel)ILi(\d+)ELb(\d)ELb(\d)E",
                      k)
        if m:
            out[f"{m.group(1)}<{m.group(2)}, {m.group(3)}, {m.group(4)}>"] = v
    return out


def sweep_nn(tiles, reps, sass_dir, extras=()):
    """K6/K7/K8 (the tiled kernel) at the committed tiling and the
    ``tiles`` variants, with the one-query-a-thread search at S = 1
    beside K6 and K8; K9 at S = 1, 2, 4, 8; every extra source through
    its own entry points (an older K8 at ``split_size``'s S).  The
    committed tiled kernel's bits are the reference of K6/K7/K8, the
    wrapper's S that of K9.  ``ptxas`` by instance:
    ``nn_tiled_kernel<D, payload, packed>``, ``nn_kernel<D, payload,
    packed>``."""
    from se3_icp_tpu_torch.ops import _build, cuda_nn
    text = (_build.CSRC / "nn_argmin.cu").read_text()
    base = committed(text, NN_TILE_FACTORS)
    tiles = [v for v in dict.fromkeys(tiles) if v != base]
    extras = extra_sources(extras, "nn")
    with tempfile.TemporaryDirectory() as tmp:
        jobs = [("nn", text)] + [
            (f"nn_tile{i}", variant_source(text, NN_TILE_FACTORS, v))
            for i, v in enumerate(tiles)] + [(t, src) for t, _, src in extras]
        libs = build_all(jobs, tmp, sass_dir)
        rows = {"committed": dict(tile=dict(zip(NN_TILE_FACTORS, base)),
                                  ms={}, split_by={},
                                  ptxas=nn_instances(libs["nn"][1]))}
        for i, v in enumerate(tiles):
            rows[f"nn_tile{i}"] = dict(
                tile=dict(zip(NN_TILE_FACTORS, v)), ms={},
                ptxas=nn_instances(libs[f"nn_tile{i}"][1]))
        for s in (1, 2, 4, 8):
            rows[f"S={s}"] = dict(split=s, ms={})
        route, has_tiled = {}, {}
        for t, label, src in extras:
            route[t] = "split" if "int split" in src else "own"
            has_tiled[t] = {
                "K6": "se3icp_nn_argmin_batched" in src,
                "K7": "se3icp_nn_match_batched" in src,
                "K8": "se3icp_nn_match_packed_batched" in src}
            rows[t] = dict(source=label, ms={}, same_bits={},
                           own_signature=route[t] == "own",
                           ptxas=nn_instances(libs[t][1]))
        for kernel, name, q, t, n, payload, phase in nn_cases():
            chosen = cuda_nn.split_size(q.shape[0], q.shape[1], q.device)
            tiled = kernel in ("K6", "K7", "K8")
            fns, outs = {}, {}

            def call(lib, r, s):
                return nn_call(lib, r, q, t, n, payload, phase, s)
            if tiled:
                fns["committed"], outs["committed"] = call(
                    libs["nn"][0], "tiled", 1)
                for i in range(len(tiles)):
                    tag = f"nn_tile{i}"
                    fns[tag], outs[tag] = call(libs[tag][0], "tiled", 1)
                if payload is None or phase is not None:
                    fns["S=1"], outs["S=1"] = call(libs["nn"][0], "split",
                                                   1)
            else:
                fns["committed"], outs["committed"] = call(
                    libs["nn"][0], "split", chosen)
                rows["committed"]["split_by"][name] = chosen
                if kernel == "K9":
                    for s in (1, 2, 4, 8):
                        if s != chosen:
                            fns[f"S={s}"], outs[f"S={s}"] = call(
                                libs["nn"][0], "split", s)
            for tag, _, _ in extras:
                r = "tiled" if tiled and has_tiled[tag][kernel] else \
                    route[tag]
                fns[tag], outs[tag] = call(libs[tag][0], r, chosen)
            # "nn_" names both kernels; a window holds one fn's launches
            med = time_turns_device(fns, reps, "nn_")
            ref = outs["committed"]
            for tag in fns:
                same = all(torch.equal(a, b) for a, b in zip(outs[tag], ref))
                if "same_bits" in rows[tag]:
                    rows[tag]["same_bits"][name] = same
                elif not same:
                    raise RuntimeError(f"1-NN {tag}: other bits than the "
                                       f"committed kernel on {name}")
                rows[tag]["ms"][name] = med[tag]
        return [r for r in rows.values() if r["ms"]]


def glue_cases():
    """[(kernel, name, inputs)] of G2 and G3 as the main path calls them,
    from the functions that make ``chip_smoke.py``'s glue cases."""
    import chip_smoke as cs
    out = []
    problems = cs.golden_pairs(cs.N_PAIRS)
    clouds = cs.setup_clouds(problems)
    for tag, (pts, nv), fuse in (
            ("64 x 4608 src", clouds[0], False),
            ("64 x 4608 tgt, fused normal", clouds[1], True),
            ("1 x 15872", cs.setup_clouds(cs.golden_pairs(1, n=15500))[0],
             False)):
        out.append(("G2", tag, cs.frame_glue_inputs(pts, nv, fuse)[3]))
    for alg, cfg in cs.step_glue_configs():
        _, _, c, A, b, st, state, kw = cs.step_glue_inputs(problems, alg,
                                                           cfg)
        ints = (int(kw["variant"] == "pt2pt"), int(kw["is_se3"]),
                int(kw["hybrid"]), int(kw["do_trim"]), kw["max_iters"],
                kw["max_se3_iters"])
        out.append(("G3", f"64 pairs {alg}", dict(
            A=A, b=b, st=st, state=state, hv=c.hv, thr=c.stop_thresh,
            nsf=c.n_src_f, ints=ints)))
    for tag, probs in (("64 x 4608", problems),
                       ("1 x 15872", cs.golden_pairs(1, n=15500)),
                       ("1 x 4608", problems[:1])):
        out.append(("G4", tag, cs.prep_glue_inputs(probs)))
    return out


G4_CLUSTERS = (1, 2, 4, 8)


def _g4_variants(extras):
    """[(row tag, lib tag, cluster)] of G4: the committed kernel and each
    extra source with the cluster argument at every cluster size, an
    extra source without it once (its own signature, cluster None)."""
    out = [(f"g4_c{c}", "g4", c) for c in G4_CLUSTERS]
    for t, _, src in extras:
        if "int cluster" in src:
            out += [(f"{t}_c{c}", t, c) for c in G4_CLUSTERS]
        else:
            out.append((t, t, None))
    return out


def sweep_glue(reps, sass_dir, extra_dirs=()):
    from se3_icp_tpu_torch.ops import _build, cuda_prep
    files = {"G2": "frames.cu", "G3": "step_update.cu", "G4": "prep.cu"}
    extras = {k: extra_sources([
        f"{label}={os.path.join(d, f)}"
        for label, d in (spec.split("=", 1) for spec in extra_dirs)],
        k.lower()) for k, f in files.items()}
    entry = {"G2": "se3icp_frame_assembly", "G3": "se3icp_step_update",
             "G4": "se3icp_prep"}
    kname = {"G2": "frame_assembly_kernel", "G3": "step_update_kernel",
             "G4": "prep_kernel"}
    with tempfile.TemporaryDirectory() as tmp:
        jobs = [(k.lower(), (_build.CSRC / f).read_text())
                for k, f in files.items()]
        for k in extras:
            jobs += [(t, src) for t, _, src in extras[k]]
        libs = build_all(jobs, tmp, sass_dir)
        rows = {}
        g4 = _g4_variants(extras["G4"])
        for k in files:
            tags = [k.lower()] + [t for t, _, _ in extras[k]]
            labels = ["committed"] + [lb for _, lb, _ in extras[k]]
            for t, lb in zip(tags, labels):
                fn = getattr(libs[t][0], entry[k])
                sig = _build.SIGNATURES[entry[k]]
                if k == "G4" and (t, t, None) in g4:
                    sig = sig[:-2] + sig[-1:]      # no cluster argument
                fn.argtypes = sig
                fn.restype = ctypes.c_int
                if k == "G4":
                    for row, lib_t, c in g4:
                        if lib_t == t:
                            rows[row] = dict(
                                kernel=k, cluster=c, ms={}, same_bits={},
                                source=lb if c is None else f"{lb}, C = {c}",
                                ptxas=resources(libs[t][1], kname[k]))
                    continue
                rows[t] = dict(kernel=k, source=lb, ms={}, same_bits={},
                               ptxas=resources(libs[t][1], kname[k]))
        for k, name, a in glue_cases():
            if k == "G4":
                fns, outs = {}, {}
                src, n_src, tgt, n_tgt, scale = a
                bsz, ns, nt = src.shape[0], src.shape[1], tgt.shape[1]
                for row, lib_t, c in g4:
                    fn = getattr(libs[lib_t][0], entry[k])
                    o = (torch.empty_like(src), torch.empty_like(tgt),
                         torch.empty((bsz, 3), device="cuda"),
                         torch.empty((bsz, 3), device="cuda"),
                         torch.empty(bsz, device="cuda"))
                    args = [x.data_ptr() for x in (src, n_src, tgt, n_tgt,
                                                   scale, *o)]
                    args += [bsz, ns, nt] + ([] if c is None else [c])
                    outs[row] = o
                    fns[row] = (lambda fn=fn, args=args: _build.check(
                        fn(*args, stream()), "G4"))
                for fn in fns.values():
                    fn()
                torch.cuda.synchronize()
                ref = cuda_prep.center_scale_plain(*a)
                med = time_turns_device(fns, reps, kname[k])
                for row in fns:
                    rows[row]["ms"][name] = med[row]
                    rows[row]["same_bits"][name] = all(
                        torch.equal(x, y) for x, y in zip(outs[row], ref))
                rows["g4_c1"].setdefault("wrapper_cluster", {})[name] = \
                    cuda_prep.cluster_size(bsz, src.device)
                continue
            tags = [k.lower()] + [t for t, _, _ in extras[k]]
            fns, outs = {}, {}
            for t in tags:
                fn = getattr(libs[t][0], entry[k])
                if k == "G2":
                    raw, pts, normal, w, fused = a
                    bsz, _, nq = raw.shape
                    rows_t = 12 if fused is not None else 9
                    o = (torch.empty((bsz, rows_t, nq), device="cuda"),
                         torch.empty((bsz, nq, 9), device="cuda"))
                    args = (raw.data_ptr(), pts.data_ptr(),
                            normal.data_ptr(), w.data_ptr(),
                            None if fused is None else fused.data_ptr(),
                            o[0].data_ptr(), o[1].data_ptr(), bsz,
                            pts.shape[1], nq, 0)
                    outs[t] = o
                    fns[t] = (lambda fn=fn, args=args: _build.check(
                        fn(*args, stream()), "G2"))
                else:
                    bsz = a["A"].shape[0]

                    def state_args(st):
                        return [None if st[x] is None else st[x].data_ptr()
                                for x in ("T", "it", "pure_it", "mse_prev",
                                          "mse_cur", "switched", "done",
                                          "hist", "W", "ph2", "pf")]
                    head = (a["A"].data_ptr(), a["b"].data_ptr(),
                            a["st"].data_ptr())
                    tail = (a["hv"].data_ptr(), a["thr"].data_ptr(),
                            a["nsf"].data_ptr(), bsz,
                            a["state"]["hist"].shape[1], *a["ints"])
                    once = {x: v.clone() for x, v in a["state"].items()}
                    _build.check(fn(*head, *state_args(once), *tail,
                                    stream()), "G3")
                    outs[t] = tuple(once.values())
                    work = {x: v.clone() for x, v in a["state"].items()}
                    fns[t] = (lambda fn=fn, w=state_args(work): _build.check(
                        fn(*head, *w, *tail, stream()), "G3"))
            torch.cuda.synchronize()
            ref = outs[k.lower()]
            med = time_turns_device(fns, reps, kname[k])
            for t in tags:
                rows[t]["ms"][name] = med[t]
                rows[t]["same_bits"][name] = all(
                    torch.equal(x, y) for x, y in zip(outs[t], ref))
        return list(rows.values())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", nargs="*",
                    default=["k4", "k1", "moments", "k5", "nn"],
                    choices=["k4", "k1", "moments", "k5", "nn", "glue"])
    ap.add_argument("--k4", nargs="*", default=[])
    ap.add_argument("--k1", nargs="*", default=[])
    ap.add_argument("--moments", nargs="*", default=[])
    ap.add_argument("--k5", nargs="*", default=[])
    ap.add_argument("--nn-tile", nargs="*", default=[])
    ap.add_argument("--reps", type=int, default=9)
    ap.add_argument("--sass", metavar="DIR")
    ap.add_argument("--extra-k4", nargs="*", default=[])
    ap.add_argument("--extra-k1", nargs="*", default=[])
    ap.add_argument("--extra-moments", nargs="*", default=[])
    ap.add_argument("--extra-k5", nargs="*", default=[])
    ap.add_argument("--extra-nn", nargs="*", default=[])
    ap.add_argument("--extra-glue", nargs="*", default=[])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_tiling_sweep: no CUDA device", file=sys.stderr)
        return 2
    from se3_icp_tpu_torch.ops import knn
    with knn.full_precision():
        return sweep(args)


def sweep(args) -> int:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    parse = lambda v: tuple(int(x) for x in v.split(","))
    with torch.no_grad():
        if "k4" in args.only:
            print(json.dumps({"kernel": "K4", "card": smi,
                              "variants": sweep_k4(
                                  [parse(v) for v in args.k4], args.reps,
                                  args.sass, args.extra_k4)}), flush=True)
        if "k1" in args.only:
            print(json.dumps({"kernel": "K1", "card": smi,
                              "variants": sweep_k1(
                                  [parse(v) for v in args.k1], args.reps,
                                  args.sass, args.extra_k1)}), flush=True)
        if "moments" in args.only:
            print(json.dumps({"kernel": "K2, K3", "card": smi,
                              "variants": sweep_moments(
                                  [parse(v) for v in args.moments],
                                  args.reps, args.sass,
                                  args.extra_moments)}), flush=True)
        if "k5" in args.only:
            print(json.dumps({"kernel": "K5", "card": smi,
                              "variants": sweep_k5(
                                  [parse(v) for v in args.k5], args.reps,
                                  args.sass, args.extra_k5)}),
                  flush=True)
        if "nn" in args.only:
            print(json.dumps({"kernel": "K6-K9", "card": smi,
                              "variants": sweep_nn(
                                  [parse(v) for v in args.nn_tile],
                                  args.reps, args.sass, args.extra_nn)}),
                  flush=True)
        if "glue" in args.only:
            print(json.dumps({"kernel": "G2, G3", "card": smi,
                              "variants": sweep_glue(
                                  args.reps, args.sass, args.extra_glue)}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
