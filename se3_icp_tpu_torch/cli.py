"""Command-line surface of the PyTorch/CUDA port, mirroring the
reference's example binaries as sub-commands (the JAX package's twelve):

  run                 <- run_registration_method: register two PLY files
  example             <- registration_example: the bunny demo problem
  example-fgr         <- registration_example_fgr: FGR on the same
  create-problem      <- create_and_save_reg_problem
  bench-synthetic     <- benchmark_synthetic (``bench/synthetic_bench.py``)
  bench-lounge        <- benchmark_lounge (``bench/lounge_bench.py``)
  bench-kitti         <- benchmark_kitti (``bench/kitti_bench.py``)
  bench-extreme-noise <- benchmark_extreme_noise_bunny
                         (``bench/extreme_noise_bench.py``)
  bench-scaling       <- pairs/s over a ladder of cards
                         (``bench/scaling_bench.py``)
  test-se3-pure       <- test_se3_pure: alpha sweep of se3_pure_* on lounge
  eval-traj           <- cc::evaluate_trajectory_quality on two 12-column
                         trajectory files
  lrf-quality         <- cc::evaluate_LRF_quality on two PLY files and a GT

Usage: ``python -m se3_icp_tpu_torch <sub-command> ... [--device cpu]``.
``run <algorithm> source.ply target.ply [--multi-start N]``:
``<algorithm>`` one of the ICP names or ``fgr``; ``--multi-start N``
registers from N rotation starts in one batch and keeps the best.  The
bench commands take a dataset folder in the reference's layout;
``--generate`` writes one there: a seed-made stand-in for lounge and
KITTI (``datasets/fixtures.py``), the protocol's problems drawn from the
bunny for ``bench-synthetic`` and ``bench-extreme-noise``
(``datasets/synthetic.py``).  The bunny commands (``example``,
``example-fgr``, ``create-problem``, ``bench-scaling``, the bunny
benches' ``--generate``) read the bunny PLY that ``SE3_ICP_TPU_BUNNY``
names (``fixtures.write_bunny_standin`` writes a stand-in).  Every
command that registers runs on the CUDA device unless ``--device cpu``
is given, and says so before any work when there is none.
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


def _bunny_demo():
    """The demo problem of ``example`` / ``example-fgr``: the bunny at
    scale 1, independent 2% downsamples, a fixed GT."""
    from scipy.spatial.transform import Rotation

    from se3_icp_tpu_torch.datasets import synthetic
    rng = np.random.default_rng(1)
    bunny = synthetic.load_bunny(scale=1.0)
    src = synthetic.random_downsample(bunny, 0.02, rng)
    T_gt = np.eye(4)
    T_gt[:3, :3] = Rotation.from_euler(
        "xyz", [np.pi / 5, np.pi / 4, np.pi / 6]).as_matrix()
    T_gt[:3, 3] = (2.5, 3.5, 1.2)
    tgt = synthetic.random_downsample(
        bunny @ T_gt[:3, :3].T + T_gt[:3, 3], 0.02, rng)
    return src, tgt, T_gt


def _print_demo(args, res, T_gt) -> None:
    from se3_icp_tpu_torch.utils import metrics_host
    print("Estimated transformation = ")
    np.savetxt(sys.stdout, res.transformation, fmt="%10.6f")
    print("Ground truth transformation = ")
    np.savetxt(sys.stdout, T_gt, fmt="%10.6f")
    so3 = metrics_host.angular_error_so3(res.transformation[:3, :3],
                                         T_gt[:3, :3])
    print(f"SO3 error = {so3:.4f} deg")
    _print_json(args, {
        "T": res.transformation.tolist(), "T_gt": T_gt.tolist(),
        "so3_error_deg": so3,
        "translation_error": metrics_host.translation_error(
            res.transformation[:3, 3], T_gt[:3, 3]),
        "num_iterations": res.num_iterations})


def cmd_example(args):
    """registration_example (a self-contained bunny demo)."""
    from se3_icp_tpu_torch.models import registration as reg
    _resolve(args)
    src, tgt, T_gt = _bunny_demo()
    res = reg.register_pair(src, tgt, "se3_pt2pl", GOLDEN,
                            device=args.device)
    _print_demo(args, res, T_gt)


def cmd_example_fgr(args):
    """registration_example_fgr (FGR on the bunny demo problem).  The
    reference draws the aligned clouds in an Open3D window; headless
    here, ``--save-aligned DIR`` writes source, target and the aligned
    source as PLY files for any viewer."""
    import os

    from se3_icp_tpu_torch.models import fgr
    from se3_icp_tpu_torch.utils import ply
    _resolve(args)
    src, tgt, T_gt = _bunny_demo()
    res = fgr.fgr_register(src, tgt, device=args.device)
    _print_demo(args, res, T_gt)
    if args.save_aligned:
        d = args.save_aligned
        os.makedirs(d, exist_ok=True)
        T = res.transformation
        ply.write_ply(os.path.join(d, "source.ply"), src)
        ply.write_ply(os.path.join(d, "target.ply"), tgt)
        ply.write_ply(os.path.join(d, "source_aligned.ply"),
                      src @ T[:3, :3].T + T[:3, 3])
        print(f"Wrote source/target/source_aligned PLYs to {d}")


def cmd_create_problem(args):
    """create_and_save_reg_problem: the golden-like problem's clouds and
    GT written to ``--out``."""
    import os

    from se3_icp_tpu_torch.datasets import synthetic
    from se3_icp_tpu_torch.utils import ply
    prob = synthetic.golden_like_problem(seed=args.seed)
    os.makedirs(args.out, exist_ok=True)
    ply.write_ply(os.path.join(args.out, "source.ply"), prob.source)
    ply.write_ply(os.path.join(args.out, "target.ply"), prob.target)
    np.savetxt(os.path.join(args.out, "transformation_gt.txt"),
               prob.T_gt, fmt="%9.6f")
    print(f"Registration problem data written to {args.out}")
    print("Gt transformation = ")
    np.savetxt(sys.stdout, prob.T_gt, fmt="%10.6f")


def cmd_bench_synthetic(args):
    from se3_icp_tpu_torch.bench import synthetic_bench
    if args.generate:
        synthetic_bench.generate_dataset(args.folder, args.num_cases,
                                         args.difficulty, args.noise)
        print(f"dataset written to {args.folder}")
        return
    _resolve(args)
    if args.alpha_sweep:
        rep = synthetic_bench.alpha_sweep(args.algorithm, args.folder,
                                          args.out_file, device=args.device)
    else:
        rep = synthetic_bench.benchmark_on_saved_data(
            args.algorithm, args.folder, rot_alpha=args.rot_alpha,
            checkpoint=args.checkpoint, dtype=np.dtype(args.dtype),
            multi_start=args.multi_start, device=args.device)
    _print_json(args, rep)


def cmd_bench_extreme_noise(args):
    from se3_icp_tpu_torch.bench import extreme_noise_bench
    if args.generate:
        extreme_noise_bench.generate_dataset(args.folder)
        print(f"dataset written to {args.folder}")
        return
    _resolve(args)
    errors = extreme_noise_bench.benchmark_extreme_noise(
        args.algorithm, args.folder, dtype=np.dtype(args.dtype),
        device=args.device)
    _print_json(args, {"errors": errors})


def cmd_bench_scaling(args):
    """Weak-scaling sweep over the ladder of cards
    (``bench/scaling_bench.py``)."""
    from se3_icp_tpu_torch.bench import scaling_bench
    _resolve(args)
    rep = scaling_bench.run_scaling(
        algorithm=args.algorithm, per_device=args.per_device,
        reps=args.reps, cloud=args.cloud, device=args.device,
        dtype=np.dtype(args.dtype))
    print(f"devices {rep['device_counts']} -> pairs/s "
          f"{rep['pairs_per_s']} (efficiency {rep['efficiency']})")
    _print_json(args, rep)


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

    p = sub.add_parser("example", help="self-contained bunny demo")
    _add_common(p)
    p.set_defaults(fn=cmd_example)

    p = sub.add_parser("example-fgr",
                       help="FGR baseline on the bunny demo problem")
    _add_common(p)
    p.add_argument("--save-aligned", default=None,
                   help="write source/target/aligned-source PLYs here "
                        "(headless stand-in for the reference's Open3D "
                        "visualization)")
    p.set_defaults(fn=cmd_example_fgr)

    p = sub.add_parser("create-problem")
    p.add_argument("--out", default="created_example_reg_problem")
    p.add_argument("--seed", type=int, default=1)
    p.set_defaults(fn=cmd_create_problem)

    for name, fn in (("bench-synthetic", cmd_bench_synthetic),
                     ("bench-lounge", cmd_bench_lounge),
                     ("bench-kitti", cmd_bench_kitti),
                     ("bench-extreme-noise", cmd_bench_extreme_noise)):
        p = sub.add_parser(name)
        p.add_argument("algorithm", choices=ALGORITHMS + ("fgr",))
        p.add_argument("folder")
        p.add_argument("--rot-alpha", type=float, default=3.0)
        _add_common(p)
        p.add_argument("--checkpoint", default=None,
                       help="JSONL per-pair checkpoint file (resumable)")
        p.add_argument("--generate", action="store_true",
                       help="write the protocol's dataset in the "
                            "reference's on-disk layout to the folder")
        if name in ("bench-lounge", "bench-kitti"):
            p.add_argument("--analyze", action="store_true",
                           help="the reference's dormant dataset "
                                "difficulty + Chamfer analyses instead "
                                "of registering")
        if name != "bench-extreme-noise":
            p.add_argument("--alpha-sweep", action="store_true",
                           help="the full hybrid alpha grid over the "
                                "protocol (benchmark_different_rot_"
                                "scales)")
        if name == "bench-synthetic":
            p.add_argument("--multi-start", type=int, default=0,
                           help="run each problem from N rotation "
                                "starts in one batch and keep the best "
                                "(0/1 = off)")
            p.add_argument("--out-file", default=None,
                           help="append each alpha's success rate here "
                                "(--alpha-sweep)")
            p.add_argument("--num-cases", type=int, default=30)
            p.add_argument("--difficulty", default="moderate",
                           choices=["easy", "moderate", "difficult"])
            p.add_argument("--noise", type=float, default=0.005)
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

    p = sub.add_parser("bench-scaling",
                       help="weak-scaling sweep over the ladder of cards "
                            "(pairs/s + efficiency)")
    p.add_argument("--algorithm", default="se3_pt2pl",
                   choices=ALGORITHMS + ("fgr",))
    p.add_argument("--per-device", type=int, default=8,
                   help="pairs per card (weak scaling)")
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--cloud", default="golden", choices=["golden", "easy"],
                   help="golden: the create-problem clouds; easy: one "
                        "easy synthetic case")
    _add_common(p)
    p.set_defaults(fn=cmd_bench_scaling)

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
