"""Extreme-noise bunny benchmark (examples/benchmark_extreme_noise_bunny
.cpp).

Port of the JAX package's ``bench/extreme_noise_bench.py``.  Protocol:
11 noise levels 0.0..0.1 (x the cloud's diameter, as a std) in folders
``noise_0_0`` .. ``noise_0_1``, 30 saved runs each (:268-333, 390-401),
each folder's runs against one shared ``gt_transform``; config
overlap=1.0, max_iter=100, mse=1e-9 (+ LRF k=90, switch 5e-5, max_se3
10 for the se3 variants, :289-296); metric: 1000 x the FilterReg point
error averaged over the 30 runs (:332).

Every entry point runs on the card unless the caller passes
``device='cpu'``; ``exact_knn`` takes the exact sorted-kNN setup, as in
``parallel.pairs.register_pairs``."""

from __future__ import annotations

import os

import numpy as np

from se3_icp_tpu_torch.bench import common
from se3_icp_tpu_torch.datasets import synthetic
from se3_icp_tpu_torch.utils import metrics_host, ply
from se3_icp_tpu_torch.utils.config import EXTREME_NOISE

LEVEL_FOLDERS = ["noise_0_0"] + [f"noise_0_0{i}" for i in range(1, 10)] \
    + ["noise_0_1"]
LEVELS = [0.0] + [i / 100 for i in range(1, 10)] + [0.1]
RUNS = 30


def read_gt(folder: str) -> np.ndarray:
    return ply.read_transform_txt(os.path.join(folder, "gt_transform"))


def load_level_pairs(folder: str):
    """The level folder's 30 (source, target) pairs."""
    return [(ply.read_ply(os.path.join(folder, f"source{i}.ply")).points,
             ply.read_ply(os.path.join(folder, f"target{i}.ply")).points)
            for i in range(RUNS)]


def level_outcomes(algorithm: str, folder: str, dtype=np.float32,
                   device="cuda", exact_knn: bool = False,
                   checkpoint=None):
    """(pairs, shared GT, {run: PairOutcome}) of one level folder."""
    pairs = load_level_pairs(folder)
    outcomes = common.run_pairs(pairs, algorithm, EXTREME_NOISE,
                                checkpoint=checkpoint, dtype=dtype,
                                verbose=False, device=device,
                                exact_knn=exact_knn)
    return pairs, read_gt(folder), outcomes


def benchmark_level_folder(algorithm: str, folder: str, dtype=np.float32,
                           device="cuda", exact_knn: bool = False) -> float:
    """One noise-level folder: 1000 x the mean FilterReg error of its 30
    runs against the shared gt_transform."""
    pairs, T_gt, outcomes = level_outcomes(algorithm, folder, dtype,
                                           device, exact_knn)
    err = np.mean([metrics_host.error_filterreg(pairs[i][0], T_gt,
                                                outcomes[i].T_est)
                   for i in range(RUNS)])
    return 1000.0 * float(err)


def benchmark_extreme_noise(algorithm: str, folder: str, dtype=np.float32,
                            device="cuda", exact_knn: bool = False):
    errors = []
    for sub in LEVEL_FOLDERS:
        e = benchmark_level_folder(algorithm, os.path.join(folder, sub),
                                   dtype=dtype, device=device,
                                   exact_knn=exact_knn)
        errors.append(e)
        print(f"{sub}: error = {e}")
    print("Errors for different noise levels (saved data):")
    for e in errors:
        print(f"error = {e}")
    return errors


def generate_dataset(folder: str, runs_per_level=RUNS, seed0=1):
    """The noise-level folders from the bunny (the protocol of
    benchmark_algorithm_at_noise_level, :372-382: a 50 deg z rotation)."""
    for sub, level in zip(LEVEL_FOLDERS, LEVELS):
        path = os.path.join(folder, sub)
        os.makedirs(path, exist_ok=True)
        T_ref = None
        for i in range(runs_per_level):
            prob = synthetic.extreme_noise_problem(level, seed=seed0 + i)
            ply.write_ply(os.path.join(path, f"source{i}.ply"), prob.source)
            ply.write_ply(os.path.join(path, f"target{i}.ply"), prob.target)
            T_ref = prob.T_gt
        np.savetxt(os.path.join(path, "gt_transform"), T_ref[:3, :4])
