"""Synthetic-bunny benchmark (examples/benchmark_synthetic.cpp).

Port of the JAX package's ``bench/synthetic_bench.py``.  Protocol: saved
problems ``source{i}.ply`` / ``target{i}.ply`` + ``gt_data`` (12
numbers a row); config overlap=1.0, max_se3=10, mse=1e-5, switch=5e-5,
LRF k=90 (benchmark_synthetic.cpp:356-363); success iff the SO(3) error
<= 2 deg and the translation error <= 0.25 (:410-413); report the
success rate and the average time (:440-448).  Supports the alpha
(rotation-scale) sweep (:472-477) and the multistart restart fleet.

Every entry point runs on the card unless the caller passes
``device='cpu'``; ``exact_knn`` takes the exact sorted-kNN setup, as in
``parallel.pairs.register_pairs``."""

from __future__ import annotations

import time

import numpy as np

from se3_icp_tpu_torch.bench import common
from se3_icp_tpu_torch.datasets import synthetic
from se3_icp_tpu_torch.utils import metrics_host
from se3_icp_tpu_torch.utils.config import GOLDEN


def benchmark_on_saved_data(algorithm: str, folder: str, rot_alpha=3.0,
                            checkpoint=None, dtype=np.float32,
                            multi_start: int = 0, device="cuda",
                            exact_knn: bool = False):
    problems = synthetic.load_problem_folder(folder)
    if not problems:
        raise FileNotFoundError(f"no problems found in {folder}")
    cfg = GOLDEN.replace(alpha_rot=rot_alpha)
    pair_list = [(p.source, p.target) for p in problems]
    if multi_start and multi_start > 1:
        # the restart fleet: (pair, start) chunks batched on the device;
        # a pair's wall time is its share of the whole call
        from se3_icp_tpu_torch.models import multistart
        from se3_icp_tpu_torch.parallel import pairs as par
        if checkpoint:
            print("warning: --checkpoint is not supported with "
                  "--multi-start (fleet runs are not resumable); "
                  "running without a checkpoint")
        t0 = time.time()
        ms_res = multistart.register_pairs_multistart(
            pair_list, algorithm, cfg, n_starts=multi_start,
            dtype=par._torch_dtype(dtype), device=device,
            exact_knn=exact_knn)
        per_ms = 1000.0 * (time.time() - t0) / len(problems)
        outcomes = {
            i: common.PairOutcome(
                index=i, T_est=r.best.transformation,
                num_iterations=r.best.num_iterations,
                num_pure_se3_iterations=r.best.num_pure_se3_iterations,
                wall_ms=per_ms)
            for i, r in enumerate(ms_res)}
    else:
        outcomes = common.run_pairs(pair_list, algorithm, cfg,
                                    checkpoint=checkpoint, dtype=dtype,
                                    device=device, exact_knn=exact_knn)
    fails, times = 0, []
    for i, prob in enumerate(problems):
        o = outcomes[i]
        fails += not metrics_host.success(prob.T_gt, o.T_est)
        times.append(o.wall_ms)
    n = len(problems)
    report = {
        "algorithm": algorithm,
        "rot_alpha": rot_alpha,
        "num_problems": n,
        "num_fails": fails,
        "success_rate": (n - fails) / n,
        "avg_time_ms": float(np.mean(times)),
        "median_time_ms": float(np.median(times)),
    }
    if multi_start and multi_start > 1:
        report["multi_start"] = multi_start
    print(f"===== Synthetic data results of algorithm: {algorithm} =====")
    print(f"Data folder: {folder}")
    print(f"Num of fails over {n} problems is: {fails}")
    print(f"success rate     = {report['success_rate']}")
    print(f"avg time overall = {report['avg_time_ms']:.2f} ms "
          f"(median {report['median_time_ms']:.2f} ms)")
    return report


def alpha_sweep(algorithm: str, folder: str, out_file=None, device="cuda",
                exact_knn: bool = False):
    """benchmark_different_rot_scales (benchmark_synthetic.cpp:472-477)."""
    reports = []
    for alpha in common.hybrid_alpha_grid():
        rep = benchmark_on_saved_data(algorithm, folder, rot_alpha=alpha,
                                      device=device, exact_knn=exact_knn)
        reports.append(rep)
        if out_file:
            with open(out_file, "a") as f:
                f.write(f"{algorithm} | rot_alpha = {alpha} | "
                        f"success_rate = {rep['success_rate']}\n")
    return reports


def generate_dataset(folder: str, num_cases=30, difficulty="moderate",
                     noise=0.005, seed0=1):
    """The dataset factory (write_data path of
    syntetic_experiment_noisy_over_common_cases, :162-182)."""
    problems = [synthetic.synthetic_problem(difficulty, noise, seed0 + i)
                for i in range(num_cases)]
    synthetic.save_problem_folder(folder, problems)
    return problems
