"""Readings of the controls: the plain reference put in the program's
place, computed in a lower precision (``tf32``: float32 with the
distance products on TF32 tensor cores, the nearest precision below the
float32 the configurations state; ``bf16``: every stored intermediate
in bfloat16), on the answers a run of the cell would check, at the
cell's own size, and judged as a run's answers are
(``compare.verdict`` against the cell's limits).  The benchmark's runs
do not run this; it is how the upper readings of the cell's limits were
taken (``PERF.md``).

    python3 portbench/control.py --workload <name> --seeds 1 2 3 \
        --units <batches or scans a run completes> [--precision tf32 bf16]

Prints one JSON line a seed and precision: the numbers
``compare.gaps`` gives for the control against the float64 reference,
and ``correct``, which a control has to read false.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


def nominal_units(kind: str, traffic: dict, scene, n: int) -> list:
    """Records standing for a window of n units: what ``compare.sample``
    draws from."""
    from portbench.traffic import Unit
    if kind == "lap":
        per = scene.n_pairs
        return [Unit(k, 0.0, 0.0, None, np.zeros(1), None, None, None,
                     None, lap=k // per, scan=k % per) for k in range(n)]
    return [Unit(k, 0.0, 0.0, None, np.zeros(traffic["batch"]), None, None,
                 None, None) for k in range(n)]


def readings(bench, workload: str, seed: int, units: int, precisions,
             device) -> list:
    """One dict a precision: the control's numbers against the
    reference, its verdict under the cell's limits, and the times."""
    from portbench import compare
    cell = bench.cell(workload)
    config = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    limits = bench.limits(workload)["compare"]
    ref = bench.reference(config["reference"])
    kind = bench.pattern(traffic).UNITS
    scene = bench.scene(config, traffic, seed)
    picked = compare.sample(nominal_units(kind, traffic, scene, units), kind,
                            traffic, seed)
    t0 = time.perf_counter()
    base = compare.reference_answers(picked, kind, scene, config, ref, device)
    t_ref = time.perf_counter() - t0
    out = []
    for prec in precisions:
        t0 = time.perf_counter()
        ctl = compare.reference_answers(picked, kind, scene, config, ref,
                                        device, prec)
        got = compare.gaps(ctl, base)
        correct, _ = compare.verdict(got, limits)
        out.append(dict(workload=workload, seed=seed, precision=prec,
                        answers=len(picked), reference_s=t_ref,
                        control_s=time.perf_counter() - t0,
                        reference_iters=[it for _, it in base],
                        control_iters=[it for _, it in ctl],
                        correct=correct, **got))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--units", type=int, required=True)
    p.add_argument("--precision", nargs="+", default=["tf32", "bf16"])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    sys.path[0] = str(ROOT)
    from portbench.spec import Bench
    bench = Bench(ROOT)
    for seed in args.seeds:
        for line in readings(bench, args.workload, seed, args.units,
                             args.precision, args.device):
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
