"""The traffic generator: the same seed gives the same inputs, and every
unit of a run brings clouds no earlier unit had."""

import json

import numpy as np
import pytest

from portbench.spec import Bench

SEED = 2 ** 31 + 12345          # larger than 32 signed bits hold


def scene_of(root, cell, seed=SEED):
    bench = Bench(root)
    w = bench.cell(cell)
    t = bench.traffic(w["traffic"])
    return bench.scene(bench.config(w["config"]), t, seed), t


def same_pairs(a, b) -> bool:
    return all(np.array_equal(s0, s1) and np.array_equal(t0, t1)
               for (s0, t0), (s1, t1) in zip(a, b))


@pytest.mark.parametrize("cell", ["golden.serve64", "golden.sync64",
                                  "kitti.online"])
def test_batches_repeat_for_a_seed(tiny_root, cell):
    (a, _), (b, _) = scene_of(tiny_root, cell), scene_of(tiny_root, cell)
    size = 3
    for k in (0, 5):
        pa, ga = a.batch("batch", k, size)
        pb, gb = b.batch("batch", k, size)
        assert same_pairs(pa, pb) and np.array_equal(ga, gb)
    other, _ = scene_of(tiny_root, cell, SEED + 1)
    assert not same_pairs(a.batch("batch", 0, size)[0],
                          other.batch("batch", 0, size)[0])


def test_laps_repeat_for_a_seed(tiny_root):
    (a, _), (b, _) = (scene_of(tiny_root, "kitti.online"),
                      scene_of(tiny_root, "kitti.online"))
    assert same_pairs(a.lap("lap", 3)[0], b.lap("lap", 3)[0])
    first, second = a.lap("lap", 0)[0], a.lap("lap", 1)[0]
    assert not any(np.array_equal(x[0], y[0]) for x in first for y in second)


def test_serving_sources_new_targets_one_list(tiny_root):
    scene, t = scene_of(tiny_root, "golden.serve64")
    size = t["batch"]
    seen_src, targets = [], None
    for k in range(4):
        pairs, _ = scene.batch("batch", k, size)
        for s, _ in pairs:
            assert not any(s is x or np.array_equal(s, x) for x in seen_src)
            seen_src.append(s)
        ids = [id(tg) for _, tg in pairs]
        assert targets is None or ids == targets   # the memo's hit
        targets = ids


def test_sync_both_sides_new(tiny_root):
    scene, t = scene_of(tiny_root, "golden.sync64")
    seen = []
    for k in range(3):
        for s, tg in scene.batch("batch", k, t["batch"])[0]:
            for c in (s, tg):
                assert not any(c is x or np.array_equal(c, x) for x in seen)
                seen.append(c)


def test_road_frames_fresh_every_batch(tiny_root):
    scene, t = scene_of(tiny_root, "kitti.online")
    a, _ = scene.batch("batch", 0, scene.n_pairs)
    b, _ = scene.batch("batch", 1, scene.n_pairs)
    assert not any(np.array_equal(x[0], y[0]) for x in a for y in b)


def test_ground_truth_maps_source_onto_target(tiny_root):
    """Each pair's ground truth takes its source onto its target (the
    golden pairs point for point, up to the scan noise)."""
    scene, t = scene_of(tiny_root, "golden.sync64")
    noise = json.loads((tiny_root / "portbench" / "traffic" /
                        "sync64.json").read_text())["source"]["noise_std"]
    pairs, gts = scene.batch("batch", 2, 3)
    for (s, tg), T in zip(pairs, gts):
        err = np.abs(s @ T[:3, :3].T + T[:3, 3] - tg).max()
        assert err < 10 * noise
