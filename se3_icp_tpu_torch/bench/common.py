"""Shared benchmark-harness machinery of the sequence protocols.

Port of the JAX package's ``bench/common.py``.  Beside the reference's
serial protocols it gives:

  * frame pairs registered in batches through the pair-batched API
    (``parallel.pairs.register_pairs``) instead of one at a time;
  * per-pair results checkpointed to a JSONL file, so a long sequence
    run resumes where it stopped.

The batches run on one device, or sharded over a pairs mesh
(``run_pairs(mesh=...)``; by default every card when there is more than
one).
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from se3_icp_tpu_torch.parallel import pairs as par
from se3_icp_tpu_torch.utils.config import RegistrationConfig


@dataclass
class PairOutcome:
    index: int
    T_est: np.ndarray
    num_iterations: int
    num_pure_se3_iterations: int
    wall_ms: float


def hybrid_alpha_grid():
    """makeHybridLGrid (benchmark_synthetic.cpp:59-89 /
    benchmark_lounge.cpp:363-393)."""
    grid = [0.0]
    grid += [i * 0.01 for i in range(1, 11)]
    grid += [i * 0.1 for i in range(2, 11)]
    grid += [1.0 + i * 0.5 for i in range(0, 9)]
    grid += [5, 7, 10, 15, 25, 50, 60, 70, 80, 90, 100,
             200, 300, 400, 500, 600, 700, 800, 900, 1000]
    return sorted(set(round(g, 10) for g in grid))


class Checkpoint:
    """Append-only JSONL of per-pair results; resumable.

    A run killed mid-write leaves a torn last line: it is skipped, its
    pair is run again, and the first record added ends the torn line
    before it starts its own (the JAX package's ``Checkpoint`` appends
    to the torn line, so the rerun's record is lost as well)."""

    def __init__(self, path: str | None):
        self.path = path
        self.done: dict[int, PairOutcome] = {}
        self._torn = False
        if path and os.path.exists(path):
            with open(path) as f:
                text = f.read()
            self._torn = bool(text) and not text.endswith("\n")
            for line in text.splitlines():
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue            # the torn line
                self.done[rec["index"]] = PairOutcome(
                    rec["index"], np.asarray(rec["T_est"]),
                    rec["num_iterations"],
                    rec["num_pure_se3_iterations"], rec["wall_ms"])

    def add(self, outcome: PairOutcome):
        self.done[outcome.index] = outcome
        if self.path:
            with open(self.path, "a") as f:
                if self._torn:
                    f.write("\n")
                    self._torn = False
                f.write(json.dumps({
                    "index": outcome.index,
                    "T_est": np.asarray(outcome.T_est).tolist(),
                    "num_iterations": outcome.num_iterations,
                    "num_pure_se3_iterations":
                        outcome.num_pure_se3_iterations,
                    "wall_ms": outcome.wall_ms,
                }) + "\n")


def run_pairs(pair_list, algorithm: str, cfg: RegistrationConfig,
              chunk: int | None = None, checkpoint: str | None = None,
              dtype=np.float32, verbose: bool = True, device="cuda",
              exact_knn: bool = False, mesh=None):
    """Register an indexed list of (src, tgt) pairs in batches of
    ``chunk``, resumably.  Runs on the card unless ``device='cpu'``;
    ``exact_knn`` as ``register_pairs``.  ``mesh``: a pairs mesh each
    batch is sharded over (``parallel.pairs.default_mesh``; by default
    every card when there is more than one, ``False`` for one device);
    the chunk is then a multiple of the mesh's size.  Returns {index:
    PairOutcome}; ``wall_ms`` is a pair's share of its batch's
    ``register_pairs`` call, which returns once the results are on the
    host."""
    ck = Checkpoint(checkpoint)
    todo = [i for i in range(len(pair_list)) if i not in ck.done]
    if not todo:
        return ck.done
    mesh = par._auto_mesh(mesh, device)
    ndev = 1 if mesh is None else len(mesh)
    # size batches from the FULL pair list (not the resume remainder):
    # a resume with 3 pairs left reuses the full run's batch shape, and
    # with it the captured program, instead of capturing a 3-pair one
    chunk = chunk or max(ndev, min(32, len(pair_list)))
    chunk = -(-chunk // ndev) * ndev
    for lo in range(0, len(todo), chunk):
        sel = todo[lo:lo + chunk]
        batch = [pair_list[i] for i in sel]
        # pad the tail batch to the chunk size (repeat the last pair):
        # a smaller final batch is a new shape, a new program for a few
        # stragglers
        n_real = len(batch)
        batch = batch + [batch[-1]] * (chunk - n_real)
        t0 = time.perf_counter()
        results = par.register_pairs(batch, algorithm, cfg, dtype=dtype,
                                     device=device, exact_knn=exact_knn,
                                     mesh=mesh or False)[:n_real]
        wall = (time.perf_counter() - t0) * 1e3 / n_real
        for i, r in zip(sel, results):
            ck.add(PairOutcome(i, r.transformation, r.num_iterations,
                               r.num_pure_se3_iterations, wall))
        if verbose:
            print(f"  pairs {sel[0]}..{sel[-1]}: {wall:.1f} ms/pair "
                  f"(batch of {len(sel)} on "
                  f"{device if mesh is None else f'{ndev} device(s)'})")
    return ck.done


def nn_distance_fn(device):
    """``nn_d(queries, targets[, tgt_valid])`` for
    ``alignment_difficulty`` on ``device``: per-query 1-NN distances
    (numpy), searched in float32 through ``knn.nn_distances`` -- the
    kernel K9 on the card."""
    from se3_icp_tpu_torch.models import registration as reg
    from se3_icp_tpu_torch.ops import knn
    dev = reg.resolve_device(device)

    def nn_d(q, t, tgt_valid=None):
        with torch.no_grad(), knn.full_precision():
            d2 = knn.nn_distances(
                torch.as_tensor(q, dtype=torch.float32, device=dev),
                torch.as_tensor(t, dtype=torch.float32, device=dev),
                None if tgt_valid is None
                else torch.as_tensor(tgt_valid, device=dev))
        return np.sqrt(np.maximum(d2.cpu().numpy(), 0.0))
    return nn_d


def alignment_difficulty(src, tgt, gt, nn_d):
    """Per-pair dataset-difficulty metrics shared by the lounge/KITTI
    analyzers (the reference's dormant evaluate_*_registration_
    difficulty / Chamfer analyses): returns (starting NN mean, after-GT
    NN mean, top-70% trimmed mean, Chamfer squared-form sum).
    ``nn_d(queries, targets)`` -> per-query NN distances."""
    start = float(nn_d(src, tgt).mean())
    moved = src @ gt[:3, :3].T + gt[:3, 3]
    d_lr = nn_d(moved, tgt)
    d_rl = nn_d(tgt, moved)
    after = float(d_lr.mean())
    k70 = max(1, int(0.7 * len(d_lr)))
    top70 = float(np.sort(d_lr)[:k70].mean())
    chamfer = float((d_lr ** 2).mean() + (d_rl ** 2).mean())
    return start, after, top70, chamfer
