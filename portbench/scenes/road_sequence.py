"""LiDAR odometry over a driven sequence (the ``road_sequence`` scene):
a fixed road world (``points``, from ``world_seed``) seen from the poses
of raw frames 0, step, ..., max_index; every use of a frame is a fresh
subsample (each point kept with probability ``keep``) with gaussian
jitter of ``noise``, taken from a table drawn once a run at a fresh
random offset.  Pair j registers frame j+1 (source) to frame j
(target)."""

from __future__ import annotations

import numpy as np

from portbench import clouds
from portbench.traffic import stream


class Scene:

    def __init__(self, scene: dict, traffic: dict, seed: int):
        self.world = clouds.road_scene(
            np.random.default_rng(scene["world_seed"]), scene["points"])
        raw = clouds.road_poses(scene["max_index"] + 2, scene["step_t"],
                                scene["yaw_step"])
        self.poses = raw[:scene["max_index"] + 1:scene["frame_step"]]
        self.keep = scene["keep"]
        self.n_pairs = len(self.poses) - 1
        self.seed = seed
        self.jitter = scene["noise"] * stream(seed, "pool").standard_normal(
            (len(self.poses) * len(self.world), 3), dtype=np.float32)

    def count_range(self) -> tuple:
        """Cloud sizes within six standard deviations of the mean."""
        n = len(self.world)
        mean, sd = n * self.keep, (n * self.keep * (1 - self.keep)) ** 0.5
        return int(mean - 6 * sd), int(mean + 6 * sd) + 1

    def frames(self, fs, rng) -> list:
        return clouds.frame_clouds(self.world, [self.poses[f] for f in fs],
                                   rng, self.keep, self.jitter)

    def gt(self, j: int) -> np.ndarray:
        return np.linalg.inv(self.poses[j]) @ self.poses[j + 1]

    def batch(self, kind: str, k: int, size: int):
        """Batch ``k``: pairs (k * size + i) mod pairs, each frame drawn
        once for the batch, in frame order."""
        rng = stream(self.seed, kind, k)
        js = [(k * size + i) % self.n_pairs for i in range(size)]
        fs = sorted(set(js) | {j + 1 for j in js})
        frames = dict(zip(fs, self.frames(fs, rng)))
        return ([(frames[j + 1], frames[j]) for j in js],
                np.stack([self.gt(j) for j in js]))

    def lap(self, kind: str, k: int):
        """Lap ``k``: every frame of the sequence drawn afresh; returns
        (pairs in sequence order, ground truths)."""
        rng = stream(self.seed, kind, k)
        frames = self.frames(range(len(self.poses)), rng)
        return ([(frames[j + 1], frames[j]) for j in range(self.n_pairs)],
                np.stack([self.gt(j) for j in range(self.n_pairs)]))
