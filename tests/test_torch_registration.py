"""The port's exact route (``exact_knn=True``: sorted-kNN setup, fused
loop) as a whole, on the CPU, in float32 against the JAX package on its
interpret route, at the full golden shape; the CLI, the entry points'
device rule and the package's import hygiene.

The interpret route runs with the sort-free setup off
(``SE3_ICP_TPU_NO_THR_KNN=1``): the Pallas match and epilogue kernels
against this port's plain versions inside the full loop, on seed-made
inputs (``datasets/fixtures.py``, 420-480 points padded to 512).
float32 sums in different orders: equal iteration counts, 1e-3 deg,
1e-4 in translation.  The float64 hold against the JAX plain route
(equal counts, 1e-9 deg) is in ``test_torch_registration_f64.py``; the
default threshold route's holds are in ``test_torch_registration_thr*.py``.
"""

import ast
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from se3_icp_tpu.ops import knn as j_knn
from se3_icp_tpu.parallel import pairs as j_pairs
from se3_icp_tpu.utils.config import RegistrationConfig as JaxConfig

import torch_port_cases as cases
from se3_icp_tpu_torch import cli
from se3_icp_tpu_torch.datasets import fixtures
from se3_icp_tpu_torch.models import registration as reg
from se3_icp_tpu_torch.parallel import pairs
from se3_icp_tpu_torch.utils import convert, metrics_host, ply
from se3_icp_tpu_torch.utils.config import GOLDEN, RegistrationConfig

# the suite runs several worker processes side by side: keep each
# one's torch thread pool small
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.mark.parametrize(
    "case", [c for c in cases.CASES if c[0] in cases.F32_CASES],
    ids=cases.F32_CASES)
def test_register_pairs_float32_matches_jax_interpret_route(case,
                                                            monkeypatch):
    name, alg, ckw, kind, pkw = case
    probs = cases.problems(kind, pkw)
    pair_list = [(p.source, p.target) for p in probs]
    jcfg, cfg = cases.configs(ckw, 71 + cases.F32_CASES.index(name))
    monkeypatch.setenv("SE3_ICP_TPU_FORCE_PALLAS", "1")
    monkeypatch.setenv("SE3_ICP_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("SE3_ICP_TPU_NO_THR_KNN", "1")
    assert j_knn.use_fused_match() and not j_knn.use_thr_knn()
    j_res = j_pairs.register_pairs(pair_list, alg, jcfg, mesh=None)
    t_res = pairs.register_pairs(pair_list, alg, cfg, device="cpu",
                                 exact_knn=True)
    cases.hold(probs, j_res, t_res, 1e-3, 1e-4)

def test_jax_package_and_port_pass_the_gate_at_the_golden_shape():
    """Full size, float32, one seed: the JAX package (plain CPU route)
    and the port (exact route, CPU plain versions) both pass the gate, in the same
    number of iterations, 1e-3 deg / 1e-4 apart at most (float32 sums in
    different orders)."""
    probs = [fixtures.golden_shape_problem(seed=1)]
    assert all(p.source.shape == (fixtures.GOLDEN_POINTS, 3) for p in probs)
    pair_list = [(p.source, p.target) for p in probs]
    j_res = j_pairs.register_pairs(pair_list, "se3_pt2pl", JaxConfig(**dataclasses.asdict(GOLDEN)),
                                   mesh=None)
    t_res = pairs.register_pairs(pair_list, "se3_pt2pl", GOLDEN,
                                 device="cpu", exact_knn=True)
    for p, j, t in zip(probs, j_res, t_res):
        assert metrics_host.success(p.T_gt, j.transformation)
        assert metrics_host.success(p.T_gt, t.transformation)
        assert t.num_iterations == j.num_iterations
        assert metrics_host.angular_error_so3(
            j.transformation[:3, :3], t.transformation[:3, :3]) < 1e-3
        assert np.linalg.norm(j.transformation[:3, 3]
                              - t.transformation[:3, 3]) < 1e-4

def test_sanitize_and_pack_drop_non_finite_points():
    pts = np.arange(30, dtype=np.float64).reshape(10, 3)
    pts[3, 1] = np.nan
    pts[7, 0] = np.inf
    assert reg.sanitize_cloud(pts).shape == (8, 3)
    out, counts = pairs.pack_clouds([pts, pts[:2]])
    assert out.shape == (2, 512, 3) and out.dtype == np.float32
    assert counts.tolist() == [8, 2]
    assert reg._bucket(4167) == 4608 and reg._bucket(1) == 512


def test_entry_points_default_to_the_card_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    p = fixtures.golden_shape_problem(seed=1, n=64)
    with pytest.raises(RuntimeError, match="CUDA"):
        pairs.register_pairs([(p.source, p.target)], "pt2pt", GOLDEN)
    with pytest.raises(RuntimeError, match="CUDA"):
        reg.register_pair(p.source, p.target, "pt2pt", GOLDEN)
    # tensors made the default way lie on the CPU: no silent CPU run
    batch = [torch.as_tensor(a) for a in pairs.pack_pairs(
        [(p.source, p.target)])]
    with pytest.raises(RuntimeError, match="CUDA"):
        pairs.register_batch(*batch, GOLDEN, "pt2pt")
    # tensors that do not lie on the device asked for raise as well
    with pytest.raises(ValueError, match="lies on"):
        pairs.register_batch(*[x.to("meta") for x in batch], GOLDEN,
                             "pt2pt", device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["run", "pt2pt", "a.ply", "b.ply"])


@pytest.mark.parametrize("ckw,exc", [
    ({"anderson_m": 1}, ValueError),
])
def test_later_slices_raise_by_name(ckw, exc):
    p = fixtures.golden_shape_problem(seed=1, n=200)
    with pytest.raises(exc):
        reg.register_pair(p.source, p.target, "se3_pt2pl",
                          RegistrationConfig(**ckw), device="cpu")


def test_config_carried_across_is_the_same_config():
    from se3_icp_tpu.utils import config as j_config
    from se3_icp_tpu_torch.utils import config as t_config
    for name in ("GOLDEN", "LOUNGE", "KITTI_VANILLA", "KITTI_SE3",
                 "EXTREME_NOISE"):
        assert dataclasses.asdict(getattr(t_config, name)) == \
            dataclasses.asdict(getattr(j_config, name)), name
        assert convert.config_from_dict(dataclasses.asdict(
            getattr(j_config, name))) == getattr(t_config, name)
    assert t_config.ALGORITHMS == j_config.ALGORITHMS
    for a in t_config.ALGORITHMS:
        assert t_config.parse_algorithm(a) == j_config.parse_algorithm(a)
    with pytest.raises(ValueError):
        t_config.parse_algorithm("se3_pt2line")
    with pytest.raises(ValueError):
        convert.config_from_dict({"no_such_field": 1})


def test_cli_run_on_cpu(tmp_path, capsys):
    p = fixtures.golden_shape_problem(seed=6, n=450)
    ply.write_ply(tmp_path / "source.ply", p.source)
    ply.write_ply(tmp_path / "target.ply", p.target)
    back = ply.read_ply(tmp_path / "source.ply")
    np.testing.assert_array_equal(back.points, p.source)
    np.savetxt(tmp_path / "gt.txt", p.T_gt)
    np.testing.assert_allclose(ply.read_transform_txt(tmp_path / "gt.txt"),
                               p.T_gt, atol=1e-15)
    cli.main(["run", "se3_pt2pl", str(tmp_path / "source.ply"),
              str(tmp_path / "target.ply"), "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "source point cloud size = 450"
    assert lines[2] == "Estimated transformation = "
    T = np.asarray([[float(v) for v in ln.split()] for ln in lines[3:7]])
    assert metrics_host.success(p.T_gt, T)
    ref = reg.register_pair(p.source, p.target, "se3_pt2pl", GOLDEN,
                            device="cpu")
    np.testing.assert_allclose(T, ref.transformation, atol=1e-6)


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((REPO / "se3_icp_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 15
    for f in files:
        for mod in _imported_modules(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "se3_icp_tpu", "flax"), \
                f"{f.relative_to(REPO)} imports {mod}"


def test_kernel_wrappers_count_launches_only_on_the_card():
    """On CPU tensors the wrappers take the plain versions and launch
    nothing; the CUDA sources they would build are in the package."""
    from se3_icp_tpu_torch.ops import (_build, cuda_frames, cuda_knn,
                                       cuda_loop, cuda_moments, cuda_nn,
                                       cuda_prep, cuda_step)
    wrappers = (cuda_knn.nn_match_affine, cuda_loop.loop_epilogue_batched,
                cuda_moments.neighborhood_thresholds_batched,
                cuda_moments.moments_batched, cuda_moments.axis_sums_batched,
                cuda_nn.nn_argmin_batched, cuda_nn.nn_argmin_unbatched,
                cuda_nn.nn_match_batched, cuda_nn.nn_match_packed,
                cuda_frames.frame_inputs, cuda_frames.frame_assembly,
                cuda_step.step_update, cuda_prep.center_scale)
    assert sorted(w.__name__ for w in wrappers) == sorted(_build.COUNTED)
    before = _build.launches()
    # icp pt2pl reaches K1, K2, K4, K5; se3_pt2pl all five
    p = fixtures.golden_shape_problem(seed=1, n=200, **cases.SMALL_POSE)
    reg.register_pair(p.source, p.target, "pt2pl", GOLDEN, device="cpu")
    p = fixtures.golden_shape_problem(seed=1, n=200)
    reg.register_pair(p.source, p.target, "se3_pt2pl", GOLDEN, device="cpu")
    assert _build.launches() == before
    names = [s.name for s in _build.sources()]
    assert names == ["frames.cu", "graph_cond.cu", "loop_epilogue.cu",
                     "match_affine.cu", "moments.cu", "nn_argmin.cu",
                     "prep.cu", "step_update.cu", "thresholds.cu"]
    for s in _build.sources():
        text = s.read_text()
        assert "torch/extension.h" not in text
        assert 'extern "C" int se3icp_' in text
    assert set(_build.SIGNATURES) == {
        "se3icp_match_affine", "se3icp_loop_epilogue", "se3icp_thresholds",
        "se3icp_moments", "se3icp_axis", "se3icp_thresholds_rows",
        "se3icp_moments_rows", "se3icp_axis_rows",
        "se3icp_nn_argmin",
        "se3icp_nn_argmin_batched", "se3icp_nn_match_batched",
        "se3icp_nn_tiled_smem", "se3icp_nn_match_packed",
        "se3icp_nn_match_packed_batched", "se3icp_cond_begin",
        "se3icp_cond_end", "se3icp_frame_inputs", "se3icp_frame_assembly",
        "se3icp_step_update", "se3icp_prep"}
    assert [h.name for h in _build.headers()] == ["dist.cuh", "eigh3_rn.cuh"]
