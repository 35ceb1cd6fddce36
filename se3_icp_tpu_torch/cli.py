"""Command-line surface of the PyTorch/CUDA port, mirroring the
reference's example binaries as sub-commands:

  run            <- run_registration_method: register two PLY files
  bench-lounge   <- benchmark_lounge (``bench/lounge_bench.py``)
  bench-kitti    <- benchmark_kitti (``bench/kitti_bench.py``)
  test-se3-pure  <- test_se3_pure: alpha sweep of se3_pure_* on lounge
  eval-traj      <- cc::evaluate_trajectory_quality on two 12-column
                    trajectory files
  lrf-quality    <- cc::evaluate_LRF_quality on two PLY files and a GT

Usage: ``python -m se3_icp_tpu_torch <sub-command> ... [--device cpu]``.
``run <algorithm> source.ply target.ply [--multi-start N]``:
``<algorithm>`` one of the ICP names or ``fgr``; ``--multi-start N``
registers from N rotation starts in one batch and keeps the best.  The
bench commands take a dataset folder in the reference's layout;
``--generate`` writes a seed-made stand-in there
(``datasets/fixtures.py``).  Every command runs on the CUDA device
unless ``--device cpu`` is given, and says so before any work when
there is none.  The bunny examples and protocols (``example``,
``example-fgr``, ``bench-synthetic``, ``bench-extreme-noise``,
``create-problem``) and ``bench-scaling`` of the JAX package's CLI are
later slices of the port.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from se3_icp_tpu_torch.utils.config import ALGORITHMS, GOLDEN, LOUNGE


def cmd_run(args):
    """run_registration_method (examples/run_registration_method.cpp)."""
    import torch

    from se3_icp_tpu_torch.models import registration as reg
    from se3_icp_tpu_torch.utils import ply
    reg.resolve_device(args.device)     # no card: say so before any work
    src = ply.read_ply(args.source)
    tgt = ply.read_ply(args.target)
    print(f"source point cloud size = {len(src)}")
    print(f"target point cloud size = {len(tgt)}")
    dtype = torch.float64 if args.dtype == "float64" else torch.float32
    multi = args.multi_start or 0
    if multi > 1 and args.algorithm == "fgr":
        sys.exit("error: --multi-start is not supported with fgr (a "
                 "global method; it does not use an initialization)")
    if multi > 1 and args.initial_transform:
        sys.exit("error: --multi-start and --initial-transform are "
                 "mutually exclusive (the restart fleet defines its own "
                 "starts)")
    if args.algorithm == "fgr":
        from se3_icp_tpu_torch.models import fgr
        res = fgr.fgr_register(src.points, tgt.points, dtype=dtype,
                               device=args.device)
    elif multi > 1:
        from se3_icp_tpu_torch.models import multistart
        ms = multistart.register_pair_multistart(
            src.points, tgt.points, args.algorithm, GOLDEN, n_starts=multi,
            dtype=dtype, device=args.device)
        res = ms.best
        print(f"multi-start: kept start {ms.start_index} of {multi} "
              f"(trimmed NN score {ms.scores[ms.start_index]:.6g})")
    else:
        T0 = None
        if args.initial_transform:
            T0 = np.loadtxt(args.initial_transform).reshape(4, 4)
        res = reg.register_pair(src.points, tgt.points, args.algorithm,
                                GOLDEN, dtype=dtype, initial_T=T0,
                                device=args.device)
    print("Estimated transformation = ")
    np.savetxt(sys.stdout, res.transformation, fmt="%10.6f")
    if args.json:
        print(json.dumps({"T": res.transformation.tolist(),
                          "num_iterations": res.num_iterations}))


def _resolve(args) -> None:
    """No card and no ``--device cpu``: say so before any work."""
    from se3_icp_tpu_torch.models import registration as reg
    reg.resolve_device(args.device)


def _print_json(args, rep) -> None:
    if args.json:
        print(json.dumps(rep))


def cmd_bench_lounge(args):
    from se3_icp_tpu_torch.bench import lounge_bench
    if args.generate:
        from se3_icp_tpu_torch.datasets import fixtures
        fixtures.make_lounge_fixture(args.folder)
        print(f"synthetic lounge-layout fixture written to {args.folder}")
        return
    _resolve(args)
    if args.analyze:
        rep = lounge_bench.analyze_lounge(args.folder, device=args.device)
    elif args.alpha_sweep:
        rep = lounge_bench.lounge_alpha_sweep(
            args.algorithm, args.folder, dtype=np.dtype(args.dtype),
            device=args.device)
    else:
        rep = lounge_bench.benchmark_lounge(
            args.algorithm, args.folder, rot_alpha=args.rot_alpha,
            checkpoint=args.checkpoint, dtype=np.dtype(args.dtype),
            device=args.device)
    _print_json(args, rep)


def cmd_bench_kitti(args):
    from se3_icp_tpu_torch.bench import kitti_bench
    if args.generate:
        from se3_icp_tpu_torch.datasets import fixtures
        fixtures.make_kitti_fixture(args.folder, max_index=args.max_index)
        print(f"synthetic KITTI-layout fixture written to {args.folder}")
        return
    _resolve(args)
    if args.analyze:
        rep = kitti_bench.analyze_kitti(args.folder,
                                        max_index=args.max_index,
                                        device=args.device)
    elif args.alpha_sweep:
        rep = kitti_bench.kitti_alpha_sweep(
            args.algorithm, args.folder, max_index=args.max_index,
            dtype=np.dtype(args.dtype), device=args.device)
    else:
        rep = kitti_bench.benchmark_kitti(
            args.algorithm, args.folder, rot_alpha=args.rot_alpha,
            checkpoint=args.checkpoint, dtype=np.dtype(args.dtype),
            max_index=args.max_index, save_traj=args.save_traj,
            online=args.online, voxel=args.voxel, device=args.device)
    _print_json(args, rep)


def cmd_test_se3_pure(args):
    """test_se3_pure: alpha sweep of run_se3_pure variants on lounge
    (examples/test_se3_pure.cpp: max_se3=30)."""
    from se3_icp_tpu_torch.bench import common, lounge_bench
    from se3_icp_tpu_torch.utils import metrics_host
    _resolve(args)
    pairs, gts = lounge_bench.load_lounge_pairs(args.folder)
    for alpha in common.hybrid_alpha_grid():
        cfg = LOUNGE.replace(alpha_rot=alpha, max_num_se3_iterations=30)
        outcomes = common.run_pairs(pairs, args.algorithm, cfg,
                                    dtype=np.dtype(args.dtype),
                                    verbose=False, device=args.device)
        eul = np.mean([metrics_host.avg_euler_error(
            outcomes[i].T_est[:3, :3], gts[i][:3, :3])
            for i in range(len(pairs))])
        print(f"{args.algorithm} | rot_alpha = {alpha} | "
              f"avg_eul_angle_error = {eul}")


def cmd_eval_traj(args):
    from se3_icp_tpu_torch.utils import metrics, ply
    _resolve(args)
    gt = ply.read_trajectory_12col(args.gt)
    est = ply.read_trajectory_12col(args.est)
    rep = metrics.evaluate_trajectory_quality(gt, est, device=args.device)
    print(f"Average translation error = {rep['avg_translation_error']}")
    print(f"Average rotation    error = {rep['avg_rotation_error']}")
    print(f"Success rate              = {rep['success_rate']}")
    _print_json(args, rep)


def cmd_lrf_quality(args):
    """cc::evaluate_LRF_quality as a diagnostic command: TOLDI frames
    on both clouds (exact kNN, as the JAX package's ``lrf.toldi_frames``),
    GT correspondences through the 1-NN kernel K9, the SO(3) error
    between GT-rotated source LRFs and matched target LRFs
    (ref:cc:63-114); --dump writes the per-correspondence errors like
    the reference's file output."""
    import torch

    from se3_icp_tpu_torch.utils import lrf_eval, metrics, ply
    _resolve(args)
    src = ply.read_ply(args.source).points
    tgt = ply.read_ply(args.target).points
    T_gt = ply.read_transform_txt(args.gt)
    k = args.lrf_k
    rot_s = lrf_eval.toldi_frames_exact_route(src, k, args.device)
    rot_t = lrf_eval.toldi_frames_exact_route(tgt, k, args.device)
    corr = metrics.compute_corrs_with_gt(src, tgt, T_gt,
                                         device=args.device).long()
    R = torch.as_tensor(T_gt[:3, :3], dtype=rot_s.dtype,
                        device=rot_s.device)
    errs = metrics.angular_error_so3_alt(
        R @ rot_s[corr[:, 0]], rot_t[corr[:, 1]],
        device=args.device).cpu().numpy()
    print(f"num correspondences = {len(errs)}")
    print(f"mean LRF SO3 error  = {errs.mean():.6f} deg")
    print(f"median LRF SO3 error = {np.median(errs):.6f} deg")
    if args.dump:
        np.savetxt(args.dump, errs, fmt="%.8f")
        print(f"per-correspondence errors written to {args.dump}")
    _print_json(args, {"mean_lrf_so3_error": float(errs.mean()),
                       "median_lrf_so3_error": float(np.median(errs)),
                       "num_corrs": int(len(errs))})


def _add_common(p):
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain versions "
                        "(float64 allowed there)")
    p.add_argument("--dtype", choices=["float32", "float64"],
                   default="float32")
    p.add_argument("--json", action="store_true",
                   help="print a final machine-readable JSON line")


def build_parser():
    ap = argparse.ArgumentParser(
        prog="se3_icp_tpu_torch",
        description="SE(3)-ICP point-cloud registration (PyTorch/CUDA)")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("run", help="register two PLY files")
    # se3_pure_* run through the API; the JAX CLI's run refuses them too
    p.add_argument("algorithm", choices=[a for a in ALGORITHMS
                                         if not a.startswith("se3_pure")]
                   + ["fgr"])
    p.add_argument("source")
    p.add_argument("target")
    p.add_argument("--initial-transform", default=None,
                   help="text file with a 4x4 warm start (original "
                        "coordinates)")
    p.add_argument("--multi-start", type=int, default=0,
                   help="N rotation starts in one batch, keep the best")
    _add_common(p)
    p.set_defaults(fn=cmd_run)

    for name, fn in (("bench-lounge", cmd_bench_lounge),
                     ("bench-kitti", cmd_bench_kitti)):
        p = sub.add_parser(name)
        p.add_argument("algorithm", choices=ALGORITHMS + ("fgr",))
        p.add_argument("folder")
        p.add_argument("--rot-alpha", type=float, default=3.0)
        _add_common(p)
        p.add_argument("--checkpoint", default=None,
                       help="JSONL per-pair checkpoint file (resumable)")
        p.add_argument("--generate", action="store_true",
                       help="write a seed-made stand-in dataset in the "
                            "reference's on-disk layout to the folder")
        p.add_argument("--analyze", action="store_true",
                       help="the reference's dormant dataset difficulty "
                            "+ Chamfer analyses instead of registering")
        p.add_argument("--alpha-sweep", action="store_true",
                       help="the full hybrid alpha grid over the "
                            "protocol (benchmark_different_rot_scales)")
        if name == "bench-kitti":
            p.add_argument("--max-index", type=int, default=1100)
            p.add_argument("--save-traj", default=None,
                           help="write the estimated absolute "
                                "trajectory (12-col rows; feed to "
                                "eval-traj)")
            p.add_argument("--online", action="store_true",
                           help="serial frame-at-a-time odometry with "
                                "a constant-velocity warm start from "
                                "the previous pair (latency mode)")
            p.add_argument("--voxel", type=float, default=0.0,
                           help="voxel-centroid downsampling size for "
                                "RAW velodyne .bin bundles (~0.3 "
                                "reproduces the reference bundle's "
                                "density)")
        p.set_defaults(fn=fn)

    p = sub.add_parser("test-se3-pure")
    p.add_argument("algorithm",
                   choices=[a for a in ALGORITHMS
                            if a.startswith("se3_pure")])
    p.add_argument("folder")
    _add_common(p)
    p.set_defaults(fn=cmd_test_se3_pure)

    p = sub.add_parser("eval-traj")
    p.add_argument("gt")
    p.add_argument("est")
    _add_common(p)
    p.set_defaults(fn=cmd_eval_traj)

    p = sub.add_parser("lrf-quality",
                       help="LRF rotational-consistency diagnostic "
                            "(cc::evaluate_LRF_quality)")
    p.add_argument("source")
    p.add_argument("target")
    p.add_argument("gt", help="4x4 ground-truth transform file")
    p.add_argument("--lrf-k", type=int, default=90)
    p.add_argument("--dump", default=None,
                   help="write per-correspondence errors to a file")
    _add_common(p)
    p.set_defaults(fn=cmd_lrf_quality)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
