"""The port's bunny-protocol generators (``datasets/synthetic.py``), the
bunny stand-in (``fixtures.write_bunny_standin``) and the twist maps
(``utils/se3.py``: ``so3_exp``, ``se3_exp``, ``se3_log``) against the
JAX package's, on the CPU.

Both packages read one stand-in file, written here at 25,000 points
(the protocols' 2% downsample keeps 500): the JAX package through its
``synthetic.BUNNY_PATH``, the port through ``SE3_ICP_TPU_BUNNY``.  The
generators draw from numpy in the same order, so every problem is the
same bytes; a saved folder written by either package reads back the
same in the other.  The twist maps agree at float64 to 1e-12 across the
small-angle branches and near pi.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se3_icp_tpu import cli as j_cli
from se3_icp_tpu.datasets import synthetic as j_synthetic
from se3_icp_tpu.utils import ply as j_ply
from se3_icp_tpu.utils import se3 as j_se3

from se3_icp_tpu_torch import cli
from se3_icp_tpu_torch.datasets import fixtures, synthetic
from se3_icp_tpu_torch.utils import ply, se3

SMALL_BUNNY = 25_000


@pytest.fixture(scope="module")
def bunny(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("bunny") / "bunny.ply")
    fixtures.write_bunny_standin(path, n_points=SMALL_BUNNY)
    return path


@pytest.fixture
def both_read(bunny, monkeypatch):
    monkeypatch.setenv(synthetic.BUNNY_ENV, bunny)
    monkeypatch.setattr(j_synthetic, "BUNNY_PATH", bunny)
    return bunny


def same_problem(a, b):
    for f in ("source", "target", "T_gt"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y, err_msg=f)


def test_standin_is_a_binary_float_bunny_both_packages_read(bunny):
    with open(bunny, "rb") as f:
        head = f.read(200).decode("ascii", "replace")
    assert "format binary_little_endian" in head
    assert "property float x" in head
    mine, theirs = ply.read_ply(bunny).points, j_ply.read_ply(bunny).points
    assert mine.shape == (SMALL_BUNNY, 3)
    np.testing.assert_array_equal(mine, theirs)
    # x50 gives the golden surface's size: a few units across
    assert 4.0 < np.ptp(mine * 50.0, axis=0).max() < 16.0
    assert int(fixtures.BUNNY_POINTS * 0.02) == fixtures.GOLDEN_POINTS


@pytest.mark.parametrize("kind,arg", [
    ("golden_like", 1), ("golden_like", 5),
    ("synthetic", "easy"), ("synthetic", "moderate"),
    ("synthetic", "difficult"),
    ("extreme_noise", 0.0), ("extreme_noise", 0.05), ("extreme_noise", 0.1),
])
def test_generators_give_the_jax_packages_bytes(kind, arg, both_read):
    if kind == "golden_like":
        a, b = synthetic.golden_like_problem(arg), \
            j_synthetic.golden_like_problem(arg)
        assert a.source.shape == (SMALL_BUNNY // 50, 3)
    elif kind == "synthetic":
        a = synthetic.synthetic_problem(arg, 0.005, seed=3)
        b = j_synthetic.synthetic_problem(arg, 0.005, seed=3)
    else:
        a = synthetic.extreme_noise_problem(arg, seed=4)
        b = j_synthetic.extreme_noise_problem(arg, seed=4)
    same_problem(a, b)
    rng_a, rng_b = (np.random.default_rng(9) for _ in range(2))
    np.testing.assert_array_equal(
        synthetic.add_noise(a.source, 0.01, rng_a),
        j_synthetic.add_noise(a.source, 0.01, rng_b))
    assert synthetic.DIFFICULTY == j_synthetic.DIFFICULTY


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_saved_folder_round_trips_across_packages(writer, both_read,
                                                  tmp_path):
    probs = [synthetic.synthetic_problem("moderate", 0.005, seed=s)
             for s in (1, 2, 3)]
    folder = str(tmp_path / "ds")
    (synthetic.save_problem_folder if writer == "port"
     else j_synthetic.save_problem_folder)(folder, probs)
    mine = synthetic.load_problem_folder(folder)
    theirs = j_synthetic.load_problem_folder(folder)
    assert len(mine) == len(theirs) == 3
    for a, b, p in zip(mine, theirs, probs):
        same_problem(a, b)
        np.testing.assert_array_equal(a.source, p.source)
        np.testing.assert_allclose(a.T_gt, p.T_gt, rtol=0, atol=5e-9)
    with open(os.path.join(folder, "gt_data")) as f:
        text = f.read()
    other = str(tmp_path / "other")
    (j_synthetic.save_problem_folder if writer == "port"
     else synthetic.save_problem_folder)(other, probs)
    with open(os.path.join(other, "gt_data")) as f:
        assert f.read() == text
    for i in range(3):
        for side in ("source", "target"):
            with open(os.path.join(folder, f"{side}{i}.ply"), "rb") as f, \
                    open(os.path.join(other, f"{side}{i}.ply"), "rb") as g:
                assert f.read() == g.read()


def test_create_problem_writes_the_jax_packages_files(both_read, tmp_path,
                                                      capsys):
    mine, theirs = str(tmp_path / "mine"), str(tmp_path / "theirs")
    cli.main(["create-problem", "--out", mine, "--seed", "2"])
    j_cli.main(["create-problem", "--out", theirs, "--seed", "2"])
    for f in ("source.ply", "target.ply", "transformation_gt.txt"):
        with open(os.path.join(mine, f), "rb") as a, \
                open(os.path.join(theirs, f), "rb") as b:
            assert a.read() == b.read(), f
    assert "Gt transformation" in capsys.readouterr().out


def test_missing_bunny_raises_by_path_and_variable(tmp_path, monkeypatch):
    path = str(tmp_path / "absent.ply")
    monkeypatch.setenv(synthetic.BUNNY_ENV, path)
    for fn in (synthetic.load_bunny, synthetic.golden_like_problem,
               lambda: synthetic.synthetic_problem("easy"),
               lambda: synthetic.extreme_noise_problem(0.0)):
        with pytest.raises(FileNotFoundError) as e:
            fn()
        assert path in str(e.value) and synthetic.BUNNY_ENV in str(e.value)
    with pytest.raises(FileNotFoundError, match=synthetic.BUNNY_ENV):
        cli.main(["create-problem", "--out", str(tmp_path / "x")])
    monkeypatch.delenv(synthetic.BUNNY_ENV)
    assert synthetic.bunny_path() == synthetic.DEFAULT_BUNNY


def test_one_voxel_downsample_in_the_port():
    assert synthetic.voxel_downsample is ply.voxel_downsample
    pts = np.random.default_rng(2).normal(size=(500, 3))
    np.testing.assert_array_equal(synthetic.voxel_downsample(pts, 0.3),
                                  j_synthetic.voxel_downsample(pts, 0.3))


THETAS = [0.0, 1e-8, 1e-4, 0.5, np.pi - 1e-6]


@pytest.mark.parametrize("theta", THETAS)
def test_twist_maps_match_jax_at_float64(theta):
    rng = np.random.default_rng(int(1e6 * theta) % 1000)
    axis = rng.normal(size=(6, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    w = axis * theta
    xi = np.concatenate([w, rng.normal(size=(6, 3))], 1).reshape(2, 3, 6)
    R = se3.so3_exp(torch.tensor(w)).numpy()
    np.testing.assert_allclose(R, np.asarray(j_se3.so3_exp(jnp.asarray(w))),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(R @ R.transpose(0, 2, 1),
                               np.broadcast_to(np.eye(3), R.shape),
                               atol=1e-12)
    T = se3.se3_exp(torch.tensor(xi)).numpy()          # batched [2,3]
    assert T.shape == (2, 3, 4, 4)
    np.testing.assert_allclose(T, np.asarray(j_se3.se3_exp(jnp.asarray(xi))),
                               rtol=0, atol=1e-12)
    back = se3.se3_log(torch.tensor(T)).numpy()
    np.testing.assert_allclose(
        back, np.asarray(j_se3.se3_log(jnp.asarray(T))), rtol=0, atol=1e-12)
    if theta < np.pi - 1e-3:
        np.testing.assert_allclose(back, xi, rtol=0, atol=1e-9)


def test_twist_maps_keep_float32():
    xi = torch.tensor([[0.3, -0.2, 0.1, 1.0, 2.0, 3.0]], dtype=torch.float32)
    T = se3.se3_exp(xi)
    assert T.dtype == torch.float32 and se3.se3_log(T).dtype == torch.float32
    np.testing.assert_allclose(se3.se3_log(T).numpy(), xi.numpy(), atol=1e-5)
