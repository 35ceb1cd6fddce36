"""The bench protocols' file I/O and seed-made datasets, port against
the JAX package, on the CPU.

  * Each trajectory / log / velodyne function of ``utils/ply.py``
    round-trips, and a file the port writes holds the JAX writer's
    bytes; ``voxel_downsample`` gives the JAX package's centroids.
  * ``make_lounge_fixture`` and ``make_kitti_fixture`` (friendly and
    ``hard``) write, for the same seed, the same tree of files as the
    JAX package's, byte for byte, at the JAX tests' sizes.
"""

import filecmp
import os

import numpy as np
import pytest

from se3_icp_tpu.datasets import fixtures as j_fixtures
from se3_icp_tpu.utils import ply as j_ply

from se3_icp_tpu_torch.datasets import fixtures
from se3_icp_tpu_torch.utils import ply


def _poses(n, seed=0):
    rng = np.random.default_rng(seed)
    mats = np.tile(np.eye(4), (n, 1, 1))
    for i in range(n):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        mats[i, :3, :3] = q * np.sign(np.linalg.det(q))
        mats[i, :3, 3] = rng.normal(scale=30.0, size=3)
    return mats


def _traj_12col(d, mod):
    mats = _poses(7)
    path = os.path.join(d, f"{mod.__name__}.txt")
    mod.write_trajectory_12col(path, mats)
    back = mod.read_trajectory_12col(path)
    assert back.shape == (7, 4, 4)
    np.testing.assert_allclose(back, mats, rtol=0, atol=1e-8)   # %.10g
    return path


def _redwood_log(d, mod):
    mats = _poses(5, seed=1)
    ids = np.stack([np.arange(5), np.arange(5), np.arange(5) + 1], 1)
    path = os.path.join(d, f"{mod.__name__}.log")
    mod.write_redwood_log(path, ids, mats)
    got_ids, got = mod.read_redwood_log(path)
    np.testing.assert_array_equal(got_ids, ids)
    np.testing.assert_allclose(got, mats, rtol=0, atol=5e-9)    # %.8f
    return path


def _velodyne_bin(d, mod):
    """A raw scan has no writer in either package: one file read by
    both; the port reads the points of the float32 rows."""
    rng = np.random.default_rng(2)
    rows = rng.normal(scale=20.0, size=(333, 4)).astype("<f4")
    path = os.path.join(d, "scan.bin")
    if not os.path.exists(path):
        rows.tofile(path)
    pts = mod.read_velodyne_bin(path)
    assert pts.dtype == np.float64 and pts.shape == (333, 3)
    np.testing.assert_array_equal(pts, rows[:, :3].astype(np.float64))
    return path


@pytest.mark.parametrize("io", [_traj_12col, _redwood_log, _velodyne_bin],
                         ids=["trajectory_12col", "redwood_log",
                              "velodyne_bin"])
def test_ply_io_round_trips_with_the_jax_writers_bytes(tmp_path, io):
    mine = io(str(tmp_path), ply)
    theirs = io(str(tmp_path), j_ply)
    with open(mine, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    # each package reads the other's file to the same arrays
    if io is _traj_12col:
        np.testing.assert_array_equal(ply.read_trajectory_12col(theirs),
                                      j_ply.read_trajectory_12col(mine))
    if io is _redwood_log:
        for x, y in zip(ply.read_redwood_log(theirs),
                        j_ply.read_redwood_log(mine)):
            np.testing.assert_array_equal(x, y)


def test_velodyne_bin_of_a_ragged_length_is_refused(tmp_path):
    path = str(tmp_path / "bad.bin")
    np.zeros(7, "<f4").tofile(path)
    with pytest.raises(ValueError, match="multiple of 4"):
        ply.read_velodyne_bin(path)


@pytest.mark.parametrize("voxel", [0.0, 0.3, 1.7])
def test_voxel_downsample_equals_jax(voxel):
    rng = np.random.default_rng(4)
    pts = np.concatenate([rng.normal(scale=6.0, size=(3000, 3)),
                          rng.normal(scale=0.05, size=(500, 3))])
    got = ply.voxel_downsample(pts, voxel)
    np.testing.assert_array_equal(got, j_ply.voxel_downsample(pts, voxel))
    if voxel > 0:
        # one centroid per occupied voxel
        keys = np.floor((pts - pts.min(0)) / voxel)
        assert len(got) == len(np.unique(keys, axis=0)) < len(pts)
    with pytest.raises(ValueError, match="too small"):
        ply.voxel_downsample(pts, 1e-6)


def _same_tree(a, b):
    cmp = filecmp.dircmp(a, b)
    assert not cmp.left_only and not cmp.right_only, (cmp.left_only,
                                                      cmp.right_only)
    _, mismatch, errors = filecmp.cmpfiles(a, b, cmp.common_files,
                                           shallow=False)
    assert not mismatch and not errors, (mismatch, errors)
    return len(cmp.common_files) + sum(
        _same_tree(os.path.join(a, sub), os.path.join(b, sub))
        for sub in cmp.common_dirs)


@pytest.mark.parametrize("maker,kw", [
    ("make_lounge_fixture", dict(n_frames=11, n_points=900)),
    ("make_lounge_fixture", dict(n_frames=11, n_points=900, hard=True)),
    ("make_kitti_fixture", dict(max_index=6, n_points=900)),
    ("make_kitti_fixture", dict(max_index=6, n_points=1200, hard=True)),
], ids=["lounge", "lounge-hard", "kitti", "kitti-hard"])
def test_fixtures_write_the_jax_packages_bytes(tmp_path, maker, kw):
    mine, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    getattr(fixtures, maker)(mine, **kw)
    getattr(j_fixtures, maker)(theirs, **kw)
    n_files = _same_tree(mine, theirs)
    if maker == "make_kitti_fixture":
        files = os.listdir(os.path.join(mine, "Sequence_07", "Downsampled"))
        assert sorted(files) == [f"{i:06d}.ply" for i in range(0, 7, 2)]
        raw = ply.read_trajectory_12col(
            os.path.join(mine, "Sequence_07", "07.txt"))
        assert raw.shape == (8, 4, 4)       # one row per raw frame
        assert n_files == 5
    else:
        files = os.listdir(os.path.join(mine, "lounge_data"))
        assert len(files) == n_files == 12  # 11 frames and the log


def test_road_scene_draws_as_the_jax_package():
    """``_scene``'s "road" branch (the friendly KITTI world) takes the
    JAX package's draws, in its order."""
    for n in (1000, 1001, 3):
        np.testing.assert_array_equal(
            fixtures._scene(np.random.default_rng(5), n, "road"),
            j_fixtures._scene(np.random.default_rng(5), n, "road"))
