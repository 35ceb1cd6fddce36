"""One rank of the port's multi-process scale-out tests, on the CPU over
gloo (``tests/test_torch_scaleout*.py`` spawn it; it imports no JAX).

    python tests/torch_scaleout_worker.py SCENARIO RANK WORLD RENDEZVOUS OUT

joins a gloo group of WORLD ranks at the ``file://`` RENDEZVOUS, runs
SCENARIO and writes what it got to OUT/rank<RANK>.pt.  One torch thread
a rank.  Scenarios:

  points     the points route (``parallel/points.py``) on the tests'
             problems: threshold route float32 for four configurations,
             exact route float64, the refusals, and the captured
             program's body (``program._program``) on the group with
             every group of steps run, beside the eager loop;
  grid       ``register_batch_2d`` on a 2 x 2 layout of four ranks;
  multihost  ``register_pairs_multihost`` with uneven per-process
             counts, with a process holding none, and FGR.
"""

import contextlib
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from se3_icp_tpu_torch.datasets import fixtures  # noqa: E402
from se3_icp_tpu_torch.utils.config import RegistrationConfig  # noqa: E402

# the port's tests' base configuration (tests/torch_port_cases.BASE),
# with an iteration cap no other test gives the JAX package (its jit
# cache keys on the static config, not on the route-selecting env)
BASE = dict(number_of_nn_for_lrf=90, max_num_se3_iterations=10,
            mse_switch_error=5e-5, max_num_iterations=57)
# (name, algorithm, config overrides, problem kwargs): the threshold
# route's cases of the points route
THR_CASES = [
    ("se3_pt2pl", "se3_pt2pl", {}, {}),
    ("se3_gicp", "se3_gicp", {}, {}),
    ("pt2pl", "pt2pl", {}, dict(kind="room", **fixtures.SMALL_POSE)),
    ("se3_pt2pl_trim075", "se3_pt2pl", {"estimated_overlap": 0.75},
     fixtures.NOISY),
]
EXACT_ALGORITHM = "se3_pt2pl"


def problem(seed=1, n=480, **kw):
    return fixtures.golden_shape_problem(seed=seed, n=n, **kw)


def grid_problems():
    return [problem(seed=s, n=420 + 20 * s) for s in range(1, 5)]


def multihost_problems():
    return [problem(seed=s, n=420 + 15 * s) for s in range(1, 5)]


def _result(r):
    return (torch.as_tensor(r.transformation), r.num_iterations,
            r.num_pure_se3_iterations)


def points(world):
    from se3_icp_tpu_torch.models import registration as reg
    from se3_icp_tpu_torch.parallel import points as mp
    out = {}
    for name, alg, ckw, pkw in THR_CASES:
        p = problem(**pkw)
        cfg = RegistrationConfig(**{**BASE, **ckw})
        out[name] = _result(mp.register_pair_model_parallel(
            p.source, p.target, alg, cfg, device="cpu"))
    p = problem()
    out["exact_f64"] = _result(mp.register_pair_model_parallel(
        p.source, p.target, EXACT_ALGORITHM, RegistrationConfig(**BASE),
        dtype=torch.float64, device="cpu", exact_knn=True))
    refused = {}
    odd = torch.zeros((1, 513, 3))
    n = torch.tensor([400], dtype=torch.int32)
    try:
        mp.register_arrays_points_sharded(odd, n, odd, n,
                                          RegistrationConfig(**BASE),
                                          "se3_pt2pl")
    except ValueError as e:
        refused["width"] = str(e)
    try:
        reg.check_group(mp.points_mesh(), "cuda")
    except ValueError as e:
        refused["cuda_on_gloo"] = str(e)
    out["refused"] = refused
    # the points route's program body (models/program.py) with every
    # group of steps run: the all_gathers of the setup and of each step
    from se3_icp_tpu_torch.models import program
    from se3_icp_tpu_torch.parallel import pairs
    p = problem(seed=2)
    src, n_src, tgt, n_tgt = (torch.as_tensor(a) for a in
                              pairs.pack_pairs([(p.source, p.target)]))
    cfg = RegistrationConfig(**BASE)
    floats, scfg = reg.split_cfg(cfg, torch.float32, "cpu")
    inp = dict(src=src, n_src=n_src, tgt=tgt, n_tgt=n_tgt, floats=floats)
    with torch.no_grad():
        T, it, pure, _, steps = program._program(
            inp, scfg, "se3", "pt2pt", False, False,
            lambda pred: contextlib.nullcontext(), group=mp.points_mesh())
    eager = reg.register_arrays_eager(src, n_src, tgt, n_tgt, cfg, "se3",
                                      "pt2pt", group=mp.points_mesh())
    out["program_body"] = (T[0], int(it[0]), int(pure[0]), int(steps))
    out["program_body_eager"] = (eager[0][0], int(eager[1][0]),
                                 int(eager[2][0]))
    return out


def grid(world):
    import numpy as np
    from se3_icp_tpu_torch.parallel import pairs
    from se3_icp_tpu_torch.parallel import points as mp
    pairs_group, points_group = mp.mesh_2d(2, world // 2)
    pl = [(p.source, p.target) for p in grid_problems()]
    out = {}
    for key, dtype, exact in (("thr", np.float32, False),
                              ("exact_f64", np.float64, True)):
        batch = [torch.as_tensor(a) for a in pairs.pack_pairs(pl, dtype)]
        out[key] = mp.register_batch_2d(*batch, RegistrationConfig(**BASE),
                                        "se3_pt2pl", pairs_group,
                                        points_group, exact_knn=exact)
    return out


def multihost(world):
    import torch.distributed as dist
    from se3_icp_tpu_torch.models import fgr
    from se3_icp_tpu_torch.parallel import multihost as mh
    rank = dist.get_rank()
    pl = [(p.source, p.target) for p in multihost_problems()]
    cfg = RegistrationConfig(**BASE)
    # (rank 0's pairs, rank 1's pairs) of the full list
    layouts = {"uneven": (pl[:3], pl[3:]), "one_empty": (pl[:2], []),
               "fgr": (pl[:1], pl[1:2])}
    out = {}
    for key, local in layouts.items():
        alg, c = (("fgr", fgr.FGRConfig(seed=107)) if key == "fgr"
                  else ("se3_pt2pl", cfg))
        out[key] = [_result(r) for r in mh.register_pairs_multihost(
            local[rank], alg, c, device="cpu")]
    return out


def spawn(scenario: str, world: int, tmp_path, timeout: float = 240.0):
    """Run ``scenario`` on ``world`` gloo ranks, each a process of its
    own, and return what each rank wrote.  A rank that fails, or a run
    that outlives ``timeout`` seconds (a hang), kills every rank and
    fails the caller's test with the ranks' output."""
    import subprocess
    import time
    out = tmp_path / f"{scenario}{world}"
    out.mkdir()
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    logs = [out / f"rank{r}.log" for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), scenario, str(r),
         str(world), str(out / "rendezvous"), str(out)],
        stdout=open(logs[r], "w"), stderr=subprocess.STDOUT, env=env)
        for r in range(world)]
    deadline = time.monotonic() + timeout
    while any(p.poll() is None for p in procs):
        failed = any(p.poll() not in (None, 0) for p in procs)
        if failed or time.monotonic() > deadline:
            for p in procs:
                p.kill()
                p.wait()
            break
        time.sleep(0.1)
    for r, p in enumerate(procs):
        assert p.returncode == 0, (
            f"rank {r} of {scenario} on {world} ranks: exit {p.returncode}"
            f" (a kill: another rank failed, or {timeout} s passed)\n"
            + "\n".join(f"--- rank {i}\n{log.read_text()[-2000:]}"
                        for i, log in enumerate(logs)))
    return [torch.load(out / f"rank{r}.pt") for r in range(world)]


def main():
    scenario, rank, world, rdv, out_dir = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    from se3_icp_tpu_torch.parallel import multihost as mh
    mh.initialize(f"file://{rdv}", world, rank, device="cpu")
    got = {"points": points, "grid": grid, "multihost": multihost}[
        scenario](world)
    torch.save(got, os.path.join(out_dir, f"rank{rank}.pt"))
    import torch.distributed as dist
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
