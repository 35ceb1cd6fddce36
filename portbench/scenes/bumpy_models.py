"""Scan-to-model registration of fixed models (the ``bumpy_models``
scene): the models are the golden problem's surfaces (one per
``model_seeds`` entry, ``points`` each) under the golden pose; a scan is
a model's source seen with ``noise_std`` noise (drawn once a run) and
moved by a fresh small rigid motion."""

from __future__ import annotations

import numpy as np

from portbench import clouds
from portbench.traffic import stream


class Scene:

    def __init__(self, scene: dict, traffic: dict, seed: int):
        lo, hi = scene["model_seeds"]
        self.n = scene["points"]
        probs = [clouds.golden_problem(s, self.n, scene["rpy"], scene["t"])
                 for s in range(lo, hi + 1)]
        self.targets = [t for _, t, _ in probs]
        self.target_block = np.stack(self.targets)
        self.T_gt = np.stack([T for _, _, T in probs])
        rng = stream(seed, "pool")
        src = traffic["source"]
        self.sources = np.stack([s for s, _, _ in probs])
        self.sources += rng.normal(scale=src["noise_std"],
                                   size=self.sources.shape)
        self.src_motion = (src["motion_deg"], src["motion_t"])
        tgt = traffic.get("target", {})
        self.tgt_motion = ((tgt["motion_deg"], tgt["motion_t"])
                           if tgt.get("fresh") else None)
        self.seed = seed

    def count_range(self) -> tuple:
        return self.n, self.n

    def batch(self, kind: str, k: int, size: int):
        """(pairs, ground truths [P,4,4]) of batch ``k``: slot i holds
        model (k * size + i) mod models.  Sources are new arrays of new
        content; targets are the run's model arrays themselves, or new
        moved copies where the traffic's targets are fresh."""
        rng = stream(self.seed, kind, k)
        m = (k * size + np.arange(size)) % len(self.targets)
        M = clouds.small_motions(rng, size, *self.src_motion)
        gts = self.T_gt[m] @ np.linalg.inv(M)
        src = clouds.moved(self.sources if size == len(self.targets)
                           else self.sources[m], M)
        if self.tgt_motion is None:
            tgt = [self.targets[j] for j in m]
        else:
            N = clouds.small_motions(rng, size, *self.tgt_motion)
            tgt = clouds.moved(self.target_block if size == len(self.targets)
                               else self.target_block[m], N)
            gts = N @ gts
        return list(zip(src, tgt)), gts
