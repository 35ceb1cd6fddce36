"""Data-parallel weak-scaling benchmark: pairs/s over a ladder of cards.

Port of the JAX package's ``bench/scaling_bench.py``.  The per-card
batch stays fixed while the card count sweeps a 1, 2, 4, ... ladder, so

    efficiency(n) = rate(n) / (n * rate(1)).

Every rung runs ``reps`` batches with one in flight
(``parallel.pairs.register_pairs_async``): the next batch is packed,
uploaded and dispatched while the card still runs the one before, and
a repetition's time is the gap between two results.  Each repetition
takes fresh arrays (the source jittered by 1e-4), so the upload memo of
``register_pairs_async`` never serves them.

The ladder runs over the cards ``torch.cuda.device_count()`` reports,
each rung on an explicit n-card pairs mesh (``parallel.pairs.
default_mesh(devices[:n])``); ``devices_present`` gives the count.  The
report carries ``platform`` (``gpu`` or ``cpu``): on the CPU the ladder
is one device and the numbers check the mechanics only.
"""

from __future__ import annotations

import time

import numpy as np


def device_ladder(n_devices: int) -> list[int]:
    """1, 2, 4, ... doubling ladder, always ending at n_devices."""
    out, c = [], 1
    while c < n_devices:
        out.append(c)
        c *= 2
    out.append(n_devices)
    return sorted(set(out))


def _jittered_lists(prob, n_pairs: int, n_reps: int, rng):
    """A fresh pair list a repetition (and one for the warm-up, last)."""
    lists = []
    for _ in range(n_reps + 1):
        lists.append([(prob.source
                       + rng.normal(scale=1e-4, size=prob.source.shape),
                       prob.target) for _ in range(n_pairs)])
    return lists


def run_scaling(algorithm: str = "se3_pt2pl", cfg=None,
                per_device: int = 8, reps: int = 3, seed: int = 0,
                cloud: str = "golden", verbose: bool = True,
                device="cuda", dtype=np.float32,
                exact_knn: bool = False) -> dict:
    """Sweep the ladder; returns the scaling report dict.  Runs on the
    card unless ``device='cpu'``."""
    import torch

    from se3_icp_tpu_torch.datasets import synthetic
    from se3_icp_tpu_torch.models import registration as reg
    from se3_icp_tpu_torch.parallel import pairs as par
    from se3_icp_tpu_torch.utils.config import GOLDEN

    dev = reg.resolve_device(device)
    cfg = cfg or GOLDEN
    on_card = dev.type == "cuda"
    present = torch.cuda.device_count() if on_card else 1
    devices = ([torch.device("cuda", i) for i in range(present)] if on_card
               else [dev])
    if cloud == "golden":
        prob = synthetic.golden_like_problem(seed + 1)
    else:
        prob = synthetic.synthetic_problem("easy", 0.002, seed=seed + 1)
    rng = np.random.default_rng(seed)
    counts, rates = [], []
    for n in device_ladder(present):
        # ALWAYS an explicit n-device mesh: mesh=None would take every
        # card of a multi-card host, inflating the one-card base rate
        # and with it every efficiency number
        kw = dict(dtype=dtype, exact_knn=exact_knn,
                  mesh=par.default_mesh(devices[:n]))
        batch = per_device * n
        rep_lists = _jittered_lists(prob, batch, reps, rng)
        par.register_pairs(rep_lists[-1], algorithm, cfg, **kw)
        rep_times = []
        pending = None
        t_prev = time.time()
        for rep in range(reps):
            nxt = par.register_pairs_async(rep_lists[rep], algorithm, cfg,
                                           **kw)
            if pending is not None:
                pending.result()
                now = time.time()
                rep_times.append(now - t_prev)
                t_prev = now
            pending = nxt
        pending.result()
        rep_times.append(time.time() - t_prev)
        rate = batch / float(np.median(rep_times))
        counts.append(n)
        rates.append(rate)
        if verbose:
            print(f"  devices={n}: {rate:.1f} pairs/s "
                  f"({batch} pairs/rep, median of {reps})")

    base = rates[0]
    report = {
        "metric": "dp_weak_scaling",
        "platform": "gpu" if on_card else "cpu",
        "algorithm": algorithm,
        "cloud": cloud,
        "per_device_batch": per_device,
        "device_counts": counts,
        "pairs_per_s": [round(r, 3) for r in rates],
        "efficiency": [round(r / (n * base), 4)
                       for n, r in zip(counts, rates)],
        "devices_present": present,
    }
    if not on_card:
        report["note"] = "CPU plain versions; mechanics only"
    return report
