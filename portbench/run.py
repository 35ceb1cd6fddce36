"""Run one cell of the port's benchmark once and print its result.

    python3 portbench/run.py --workload <name> --seed <n> \
        --seconds <s> --trace <0|1>

from the root of a checkout.  The last line of standard output is the
result, one JSON object (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` ``breakdown``, then
``checks``: each number compared with the plain reference beside its
limit); the same numbers are the last lines of standard error.  The run
exits non-zero and prints no result where there is no CUDA device, or
fewer than the cell asks for, or where the process holds the JAX
package, ``jax``, ``jaxlib`` or ``flax`` after the window.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
HOST_THREADS = 2


def _args(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi: not readable"


def main(argv=None) -> int:
    args = _args(argv)
    sys.path[0] = str(ROOT)
    # a kernel cache of the port's libraries, if any writes one, stays
    # in the checkout at a fixed path
    cache = ROOT / "portbench" / ".cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))
    os.environ.setdefault("USE_FLAX", "0")
    # load from one process with few threads: the host's cores are
    # shared, and pools of spinning workers widen the spread of runs
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ.setdefault(var, str(HOST_THREADS))
    import torch
    torch.set_num_threads(HOST_THREADS)
    marks = {"torch_s": time.perf_counter() - T_START}

    from portbench import harness
    from portbench.spec import Bench
    bench = Bench(ROOT)
    cell = bench.cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    torch.cuda.init()
    marks["cuda_s"] = time.perf_counter() - T_START
    result, lines, notes = harness.run_cell(
        bench, args.workload, args.seed, args.seconds, bool(args.trace),
        T_START)
    notes["setup"].update(marks)
    print(f"card: {_card_line()}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    print(f"notes: {json.dumps(notes)}", flush=True)
    bad = harness.forbidden_modules()
    if bad:
        print(f"the process holds {', '.join(bad)}: no result",
              file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
