"""Command-line surface of the PyTorch/CUDA port.

  run    <- run_registration_method: register two PLY files

Usage: ``python -m se3_icp_tpu_torch run <algorithm> source.ply
target.ply [--multi-start N] [--device cpu]``, ``<algorithm>`` one of
the ICP names or ``fgr``; ``--multi-start N`` registers from N rotation
starts in one batch and keeps the best.  The run is on the CUDA device
unless ``--device cpu`` is given.  The other sub-commands of the JAX
package's CLI (examples, benchmark protocols) are later slices of the
port.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from se3_icp_tpu_torch.utils.config import ALGORITHMS, GOLDEN


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
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain versions "
                        "(float64 allowed there)")
    p.add_argument("--dtype", choices=["float32", "float64"],
                   default="float32")
    p.add_argument("--json", action="store_true",
                   help="print a final machine-readable JSON line")
    p.set_defaults(fn=cmd_run)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
