#!/usr/bin/env python3
"""Tiling factors of K4 (``csrc/match_affine.cu``) and K1
(``csrc/thresholds.cu``), measured side by side on one card.

    python3 tools/kernel_tiling_sweep.py [--k4 THREADS,R,MINBLOCKS,U,U3 ...]
                                         [--k1 Q,WARPS ...] [--reps N]
                                         [--extra-k4 LABEL=FILE.cu ...]
                                         [--extra-k1 LABEL=FILE.cu ...]

Each variant is the committed source with its ``constexpr`` tiling
factors replaced in a temporary copy (K4: ``kThreads``, ``kR``,
``kMinBlocks``, ``kU``, ``kU3``; K1: ``kQ``, ``kWarps``), compiled by nvcc with
the package's flags and ``-Xptxas -v`` (registers, spills, shared
memory) into a library of its own, and called through the same C entry
point on the main path's inputs as ``chip_smoke.py`` makes them (64
golden-shape pairs in the 4608 bucket; K4 also at 8 x 15360): K4 in the
SE(3) phase from the identity and in the R3 phase near the answer, K1
on the sources with the main path's counts (90, 31, 30).  The variants
are timed in turns (CUDA events, the median of ``--reps`` rounds), and
each must return the bits of the first variant, the committed factors.
``--extra-k4`` / ``--extra-k1`` add other sources with the same C entry
point (an earlier version of the kernel, say) to the same turns; for
them the bits are compared and reported, not required.  The committed
sources are not changed.  ``--sass DIR`` also writes each
variant's machine code (``cuobjdump -sass``) into DIR.  Needs a CUDA
device and nvcc; prints one JSON line per kernel.
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--k4", nargs="*", default=[])
    ap.add_argument("--k1", nargs="*", default=[])
    ap.add_argument("--reps", type=int, default=9)
    ap.add_argument("--sass", metavar="DIR")
    ap.add_argument("--extra-k4", nargs="*", default=[])
    ap.add_argument("--extra-k1", nargs="*", default=[])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_tiling_sweep: no CUDA device", file=sys.stderr)
        return 2
    from se3_icp_tpu_torch.ops import knn
    knn.require_full_precision()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    parse = lambda v: tuple(int(x) for x in v.split(","))
    with torch.no_grad():
        print(json.dumps({"kernel": "K4", "card": smi, "variants": sweep_k4(
            [parse(v) for v in args.k4], args.reps, args.sass,
            args.extra_k4)}), flush=True)
        print(json.dumps({"kernel": "K1", "card": smi, "variants": sweep_k1(
            [parse(v) for v in args.k1], args.reps, args.sass,
            args.extra_k1)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
