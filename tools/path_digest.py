#!/usr/bin/env python3
"""Per-pair results and wall times of the port's main path, its
multistart fleet and the other algorithms' small batches, for holding
two checkouts against each other on one card.

    python3 tools/path_digest.py [--root DIR] --out FILE.npz [--reps N]
    python3 tools/path_digest.py --compare A.npz B.npz
    python3 tools/path_digest.py [--root DIR] --batch-bits

The first form imports ``se3_icp_tpu_torch`` from ``--root`` (default:
the checkout this script lies in) and runs, as ``chip_smoke.py`` does,
the main path (``register_pairs``: 64 golden-shape pairs, ``se3_pt2pl``,
``GOLDEN``, threshold route; the same arrays every call, and again as
fresh copies, whose uploads a checkout that memoises them cannot reuse)
and the multistart fleet
(``register_pairs_multistart``: 8 pairs x 8 starts under
``FLIPPED_POSE``) and, as ``chip_smoke.py`` runs them, 8 pairs each of
``se3_gicp``, ``se3_gicp_with_cf`` (``LOUNGE``, noisy pairs),
``se3_pt2pt`` and ``pt2pl`` (a small pose), FGR + FPFH on the main
path's 64 pairs (``register_pairs(..., "fgr", FGRConfig())``, two K6
launches at D = 33), and the metrics on the main path's 64 results as
``chip_smoke.py`` evaluates them (each pair's squared chamfer distance
and GT correspondences, three K9 launches a pair): each once to warm up
and then ``--reps`` times, all paths in turns.  It saves every pair's
iteration count and transform (of the last call), the kept starts,
FGR's transforms and its reciprocal and kept correspondence counts, the
chamfer distances and correspondence indices of the metrics, a hash a
pair of the setup's products that the loop reads for the main path and
each small batch (``setup_*``), and the wall time of every timed call (host clock around work that ends in
a synchronize), and prints one JSON line with the medians.  The second form prints whether two such files hold the
same iteration counts, the same transform bits and the same setup
products.  The third form registers the same 8 golden-shape pairs
of ``se3_pt2pl``, ``se3_gicp``, ``se3_pt2pt`` and ``pt2pl`` in batches
of 1, 2 and 8 and as the first 8 of a 64-pair batch, each batch packed
at its own width (``chip_smoke.batch_size_runs``), and hashes each pair's products stage by stage -- the
preprocessing (centred clouds, centroids, scale), the setup (query
features, target embeddings, payload, source covariances), the first
three eager loop steps (K5's A, b, st and the pose after G3) and the
captured program's results -- and prints, for each stage, the pairs
whose hash differs between the batch sizes: the first stage that lists
a pair is where its bits begin to follow its batch.  Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import statistics
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run(root: str, out: str, reps: int) -> None:
    sys.path.insert(0, os.path.abspath(root))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("path_digest: no CUDA device")
    from se3_icp_tpu_torch.datasets import fixtures
    from se3_icp_tpu_torch.models import fgr, multistart
    from se3_icp_tpu_torch.parallel import pairs
    from se3_icp_tpu_torch.utils import metrics
    from se3_icp_tpu_torch.utils.config import GOLDEN, LOUNGE

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    main = [fixtures.golden_shape_problem(seed=s) for s in range(1, 65)]
    main_list = [(p.source, p.target) for p in main]
    flip = [fixtures.golden_shape_problem(seed=s, **fixtures.FLIPPED_POSE)
            for s in range(1, 9)]
    flip_list = [(p.source, p.target) for p in flip]
    main_fn = lambda: pairs.register_pairs(main_list, "se3_pt2pl", GOLDEN)
    ms_fn = lambda: multistart.register_pairs_multistart(
        flip_list, "se3_pt2pl", GOLDEN, n_starts=8, pair_chunk=8)
    small_fns = {}
    setup_npz = {"setup_main": setup_digest(main_list, "se3_pt2pl", GOLDEN)}
    for alg, cfg, kw in (("se3_gicp", GOLDEN, {}),
                         ("se3_gicp_with_cf", LOUNGE, fixtures.NOISY),
                         ("se3_pt2pt", GOLDEN, {}),
                         ("pt2pl", GOLDEN, fixtures.SMALL_POSE)):
        probs = [fixtures.golden_shape_problem(seed=s, **kw)
                 for s in range(1, 9)]
        plist = [(p.source, p.target) for p in probs]
        small_fns[alg] = functools.partial(pairs.register_pairs, plist, alg,
                                           cfg)
        setup_npz[f"setup_{alg}"] = setup_digest(plist, alg, cfg)
    fgr_cfg = fgr.FGRConfig()

    def fgr_fn():
        stats = {}
        res = pairs.register_pairs(main_list, "fgr", fgr_cfg, stats=stats)
        return res, stats
    evaluated = main_fn()

    def metrics_fn():
        chamfer, corrs = [], []
        for p, r in zip(main, evaluated):
            T = r.transformation
            moved = p.source @ T[:3, :3].T + T[:3, 3]
            chamfer.append(float(metrics.chamfer_distance_sq(moved,
                                                             p.target)))
            corrs.append(metrics.compute_corrs_with_gt(
                p.source, p.target, p.T_gt).cpu().numpy())
        return np.asarray(chamfer), np.stack(corrs)
    ms_fn()
    for fn in small_fns.values():
        fn()
    fgr_fn()
    metrics_fn()
    main_s, fresh_s, ms_s, fgr_s, metrics_s = [], [], [], [], []
    small_s = {alg: [] for alg in small_fns}
    small_res = {}
    for _ in range(reps):          # in turns: the host clock drifts
        main_res, t = timed(main_fn)
        main_s.append(t)
        # the same pairs as fresh arrays: no side's upload is memoised
        fresh = [(s.copy(), t.copy()) for s, t in main_list]
        fresh_res, t = timed(lambda: pairs.register_pairs(
            fresh, "se3_pt2pl", GOLDEN))
        fresh_s.append(t)
        if [r.num_iterations for r in fresh_res] != [
                r.num_iterations for r in main_res] or not all(
                np.array_equal(a.transformation, b.transformation)
                for a, b in zip(fresh_res, main_res)):
            raise SystemExit("path_digest: fresh arrays changed the results")
        ms_res, t = timed(ms_fn)
        ms_s.append(t)
        for alg, fn in small_fns.items():
            small_res[alg], t = timed(fn)
            small_s[alg].append(t)
        (fgr_res, fgr_stats), t = timed(fgr_fn)
        fgr_s.append(t)
        (chamfer, corrs), t = timed(metrics_fn)
        metrics_s.append(t)
    small_npz = {}
    for alg, res in small_res.items():
        small_npz[f"{alg}_iterations"] = np.asarray(
            [r.num_iterations for r in res])
        small_npz[f"{alg}_transforms"] = np.stack(
            [r.transformation for r in res])
        small_npz[f"{alg}_seconds"] = np.asarray(small_s[alg])
    np.savez(out,
             main_iterations=np.asarray([r.num_iterations for r in main_res]),
             main_transforms=np.stack([r.transformation for r in main_res]),
             ms_kept_starts=np.asarray([r.start_index for r in ms_res]),
             ms_iterations=np.asarray([r.best.num_iterations
                                       for r in ms_res]),
             ms_transforms=np.stack([r.best.transformation
                                     for r in ms_res]),
             main_seconds=np.asarray(main_s),
             main_fresh_seconds=np.asarray(fresh_s),
             ms_seconds=np.asarray(ms_s),
             fgr_transforms=np.stack([r.transformation for r in fgr_res]),
             fgr_reciprocal=np.asarray(fgr_stats["reciprocal"]),
             fgr_kept=np.asarray(fgr_stats["kept_correspondences"]),
             fgr_seconds=np.asarray(fgr_s),
             metrics_chamfer=chamfer, metrics_corrs=corrs,
             metrics_seconds=np.asarray(metrics_s), **small_npz,
             **setup_npz)
    print(json.dumps({
        "phase": "path_digest", "root": os.path.abspath(root),
        "device": torch.cuda.get_device_name(0),
        "main_path_seconds": main_s,
        "main_path_median_seconds": statistics.median(main_s),
        "main_path_pairs_per_s": 64 / statistics.median(main_s),
        "main_path_fresh_seconds": fresh_s,
        "main_path_fresh_median_seconds": statistics.median(fresh_s),
        "multistart_seconds": ms_s,
        "multistart_median_seconds": statistics.median(ms_s),
        "multistart_pairs_per_s": 8 / statistics.median(ms_s),
        "small_batch_seconds": small_s,
        "small_batch_median_seconds": {
            alg: statistics.median(t) for alg, t in small_s.items()},
        "fgr_seconds": fgr_s,
        "fgr_median_seconds": statistics.median(fgr_s),
        "metrics_seconds": metrics_s,
        "metrics_median_seconds": statistics.median(metrics_s)}),
        flush=True)


def setup_digest(pair_list, alg: str, cfg) -> np.ndarray:
    """Per pair, a SHA-1 of the setup's products that the loop reads
    (``registration.setup`` on the card, threshold route): the query
    features (the source frames), both phases' target embeddings (the
    target frames), the payload (normals or covariances) and the source
    covariances."""
    import hashlib
    import torch
    from se3_icp_tpu_torch.models import registration as reg
    from se3_icp_tpu_torch.parallel import pairs
    from se3_icp_tpu_torch.utils.config import parse_algorithm
    src, n_src, tgt, n_tgt = (torch.as_tensor(a, device="cuda")
                              for a in pairs.pack_pairs(pair_list))
    mode, variant = parse_algorithm(alg)
    floats, scfg = reg.split_cfg(cfg, torch.float32, "cuda")
    with torch.no_grad():
        ms, _ = reg.setup(src, n_src, tgt, n_tgt, scfg, mode, variant,
                          reg.hyper(floats))
    parts = [ms.feat16, ms.targets.emb, ms.targets.payload]
    if ms.cov_src6 is not None:
        parts.append(ms.cov_src6)
    out = []
    for b in range(src.shape[0]):
        h = hashlib.sha1()
        for x in parts:
            h.update(x[b].contiguous().cpu().numpy().tobytes())
        out.append(h.hexdigest())
    return np.asarray(out)


BATCH_BITS_ALGS = ("se3_pt2pl", "se3_gicp", "se3_pt2pt", "pt2pl")


def _hashes(parts) -> str:
    import hashlib
    h = hashlib.sha1()
    for x in parts:
        if x is not None:
            h.update(x.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def stage_hashes(pair_list, alg: str, cfg, steps: int = 3) -> list:
    """Per pair, {stage: SHA-1} of one batch (see the module doc)."""
    import torch
    from se3_icp_tpu_torch.models import registration as reg
    from se3_icp_tpu_torch.parallel import pairs
    from se3_icp_tpu_torch.utils.config import parse_algorithm
    src, n_src, tgt, n_tgt = (torch.as_tensor(a, device="cuda")
                              for a in pairs.pack_pairs(pair_list))
    mode, variant = parse_algorithm(alg)
    floats, scfg = reg.split_cfg(cfg, torch.float32, "cuda")
    h = reg.hyper(floats)
    out = [{} for _ in pair_list]
    with torch.no_grad():
        ms, pre = reg.setup(src, n_src, tgt, n_tgt, scfg, mode, variant, h)
        s, c = reg.init_loop(ms, pre.scaling, scfg, mode, h)
        rows = {"preprocess": lambda b: [
                    ms.src_cT[b, :, :int(n_src[b])], pre.cen_s[b],
                    pre.cen_t[b], pre.scaling[b]],
                "setup": lambda b: [
                    ms.feat16[b, :int(n_src[b])], ms.targets.payload[b],
                    ms.targets.emb[b]]
                + ([ms.cov_src6[b]] if ms.cov_src6 is not None else [])}
        for name, fn in rows.items():
            for b in range(len(pair_list)):
                out[b][name] = _hashes(fn(b))
        for k in range(steps):
            A, bv, st = reg._match_and_epilogue(s, ms, c, s.W, s.ph2, s.pf)
            for b in range(len(pair_list)):
                out[b][f"step{k}_epilogue"] = _hashes([A[b], bv[b], st[b]])
            s = reg.loop_step(s, ms, c)
            for b in range(len(pair_list)):
                out[b][f"step{k}_pose"] = _hashes([s.T[b]])
    res = pairs.register_pairs(pair_list, alg, cfg, mesh=False)
    for b, r in enumerate(res):
        out[b]["result"] = _hashes([torch.as_tensor(r.transformation),
                                    torch.tensor(r.num_iterations)])
    return out


def eager_result_hashes(pair_list, alg: str, cfg) -> list:
    """Per pair, {"eager_result": SHA-1} of one batch registered on the
    eager polled loop (``registration.register_arrays_eager``, the
    captured program's reference) on the card."""
    import torch
    from se3_icp_tpu_torch.parallel import pairs
    with _this_chip_smoke().EagerLoop():
        res = pairs.register_pairs(pair_list, alg, cfg, mesh=False)
    return [{"eager_result": _hashes([
        torch.as_tensor(r.transformation), torch.tensor(r.num_iterations)])}
        for r in res]


def fgr_stage_hashes(pair_list, cfg, device="cuda") -> list:
    """Per pair, {stage: SHA-1} of FGR on one batch: the eager body's
    features, reciprocal matches, tuple-test weights, centring and
    scale, each Gauss-Newton step's normal equations (``gnNN``) and its
    transform (``eager_result``), then the captured program's transform
    and counts (``result``)."""
    import torch
    from se3_icp_tpu_torch.models import fgr
    from se3_icp_tpu_torch.parallel import pairs
    src, n_src, tgt, n_tgt = (torch.as_tensor(a, device=device)
                              for a in pairs.pack_pairs(pair_list))
    inp = dict(src=src, n_src=n_src, tgt=tgt, n_tgt=n_tgt)
    if cfg.tuple_test:
        inp["raw"] = fgr.raw_triples(cfg, src.device)
    probe = {}
    with torch.no_grad():
        T = fgr.program_body(inp, cfg, probe)[0]
    ns, nt = n_src.tolist(), n_tgt.tolist()
    (fs, ft), (fwd, bwd) = probe["features"], probe["matches"]
    cen_s, cen_t, scale = probe["centring"]
    jtj = torch.stack([g[0] for g in probe["gn"]], 1).cpu()
    jtr = torch.stack([g[1] for g in probe["gn"]], 1).cpu()
    out = []
    for b in range(len(pair_list)):
        row = {}
        # the feature stages of both clouds, where the checkout records
        # them: the kNN (indices, distances), the normals, SPFH, FPFH
        stages = probe.get("feature_stages") or []
        for name, cols in (("knn", (0, 1)), ("normals", (2,)),
                           ("spfh", (3,)), ("fpfh", (4,))):
            if stages:
                row[name] = _hashes([stages[c][i][b, :n] for c, n in (
                    (0, ns[b]), (1, nt[b])) for i in cols])
        row.update({"features": _hashes([fs[b, :ns[b]], ft[b, :nt[b]]]),
               "matches": _hashes([fwd[b, :ns[b]], bwd[b, :nt[b]]]),
               "weights": _hashes([probe["weights"][b, :ns[b]]]),
               "centring": _hashes([cen_s[b], cen_t[b], scale[b]])})
        for k in range(jtj.shape[1]):
            row[f"gn{k:02d}"] = _hashes([jtj[b, k], jtr[b, k]])
        row["eager_result"] = _hashes([T[b]])
        out.append(row)
    stats = {}
    res = pairs.register_pairs(pair_list, "fgr", cfg, mesh=False,
                               stats=stats, device=device)
    for b, r in enumerate(res):
        out[b]["result"] = _hashes([
            torch.as_tensor(r.transformation),
            torch.tensor([stats["reciprocal"][b],
                          stats["kept_correspondences"][b]])])
    return out


def _this_chip_smoke():
    """This checkout's ``chip_smoke.py`` (its batch-size helpers), also
    when ``--root`` names another checkout."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_here", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def batch_bits(root: str) -> bool:
    """The third form: True when every stage of every pair has the same
    hash in every batch."""
    sys.path.insert(0, os.path.abspath(root))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("path_digest: no CUDA device")
    chip_smoke = _this_chip_smoke()
    from se3_icp_tpu_torch.datasets import fixtures
    from se3_icp_tpu_torch.models import fgr
    from se3_icp_tpu_torch.ops import knn
    from se3_icp_tpu_torch.utils.config import GOLDEN
    report, same = {}, True

    def differing(runs):
        """{stage: {batching: [pair]}}, only the stages that differ."""
        differ = {stage: chip_smoke.pairs_differing(
            runs, lambda a, b, st=stage: a[st] == b[st])
            for stage in runs["B=8"][0]}
        return {st: d for st, d in differ.items()
                if any(v for v in d.values())}
    with knn.full_precision():
        for alg in BATCH_BITS_ALGS:
            kw = fixtures.SMALL_POSE if alg == "pt2pl" else {}
            pl = [(p.source, p.target) for p in
                  (fixtures.golden_shape_problem(seed=s, **kw)
                   for s in range(1, 65))]
            report[alg] = differing(chip_smoke.batch_size_runs(
                pl, chip_smoke.one_call_a_batch(
                    lambda b, alg=alg: stage_hashes(b, alg, GOLDEN)),
                sizes=(1, 2)))
            # the eager route alone and in batches of 3
            report[f"{alg} eager"] = differing(chip_smoke.batch_size_runs(
                pl, chip_smoke.one_call_a_batch(
                    lambda b, alg=alg: eager_result_hashes(b, alg, GOLDEN)),
                sizes=(1, 3)))
        pl = [(p.source, p.target) for p in
              (fixtures.golden_shape_problem(seed=s) for s in range(1, 65))]
        report["fgr"] = differing(chip_smoke.batch_size_runs(
            pl, chip_smoke.one_call_a_batch(
                lambda b: fgr_stage_hashes(b, fgr.FGRConfig())),
            sizes=(1, 2, 3)))
    same = not any(report.values())
    first = {what: next(iter(d), None) for what, d in report.items()}
    print(json.dumps({"phase": "path_digest_batch_bits",
                      "root": os.path.abspath(root),
                      "device": torch.cuda.get_device_name(0),
                      "every_stage_same": same,
                      "first_stage_differing": first,
                      "pairs_differing_from_B8": report}), flush=True)
    return same


def compare(a: str, b: str) -> bool:
    with np.load(a) as x, np.load(b) as y:
        same = {k: bool(np.array_equal(x[k], y[k])) for k in x.files
                if not k.endswith("seconds")}
        worst = float(np.abs(x["main_transforms"]
                             - y["main_transforms"]).max())
    print(json.dumps({"phase": "path_digest_compare", "a": a, "b": b,
                      "equal": same,
                      "main_transform_max_abs_diff": worst}), flush=True)
    return all(same.values())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--out")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--compare", nargs=2, metavar=("A", "B"))
    ap.add_argument("--batch-bits", action="store_true")
    args = ap.parse_args()
    if args.compare:
        return 0 if compare(*args.compare) else 1
    if args.batch_bits:
        return 0 if batch_bits(args.root) else 1
    if not args.out:
        ap.error("--out is required without --compare")
    run(args.root, args.out, args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
