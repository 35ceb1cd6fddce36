"""Two contracts of the port's entry points, on the CPU.

  * The engine (``registration.register_arrays``) and FGR
    (``fgr.fgr_register_arrays``) run their work at full float32 matrix
    precision and give the caller's settings back: TF32 on cuBLAS and
    cuDNN and torch's float32 matmul precision are as the caller left
    them after a call, also after one that raised.
  * The CLI's ``run`` takes the algorithms the JAX package's ``run``
    takes: ``se3_pure_*`` is refused there (it runs through the API).
"""

import numpy as np
import pytest
import torch

from se3_icp_tpu_torch import cli
from se3_icp_tpu_torch.datasets import fixtures
from se3_icp_tpu_torch.models import fgr
from se3_icp_tpu_torch.models import registration as reg
from se3_icp_tpu_torch.ops import knn
from se3_icp_tpu_torch.parallel import pairs
from se3_icp_tpu_torch.utils.config import GOLDEN

torch.set_num_threads(1)


def _settings():
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())


@pytest.fixture(params=[("high", True), ("medium", False)],
                ids=["tf32-high", "tf32-medium"])
def caller_settings(request):
    """The caller's own settings (TF32 allowed for matmuls, cuDNN TF32
    on or off), restored after the test whatever it does."""
    saved = (torch.get_float32_matmul_precision(),
             torch.backends.cudnn.allow_tf32)
    precision, cudnn = request.param
    torch.set_float32_matmul_precision(precision)
    torch.backends.cudnn.allow_tf32 = cudnn
    yield _settings()
    torch.set_float32_matmul_precision(saved[0])
    torch.backends.cudnn.allow_tf32 = saved[1]


def _batch(n=300):
    p = fixtures.golden_shape_problem(seed=3, n=n)
    arrs = pairs.pack_pairs([(p.source, p.target)])
    return [torch.as_tensor(a) for a in arrs]


def test_full_precision_sets_and_restores(caller_settings):
    with knn.full_precision():
        assert _settings() == (False, False, "highest")
    assert _settings() == caller_settings
    with pytest.raises(KeyError):
        with knn.full_precision():
            raise KeyError("body")
    assert _settings() == caller_settings


def test_engine_call_leaves_the_callers_precision(caller_settings,
                                                  monkeypatch):
    src, n_src, tgt, n_tgt = _batch()
    cfg = GOLDEN.replace(max_num_iterations=2)
    T, it, _ = reg.register_arrays(src, n_src, tgt, n_tgt, cfg, "se3",
                                   "pt2pl")
    assert bool(torch.isfinite(T).all()) and int(it[0]) >= 1
    assert _settings() == caller_settings

    seen = []

    def broken_loop(*a, **kw):
        seen.append(_settings())
        raise RuntimeError("loop failed")
    monkeypatch.setattr(reg, "run_loop", broken_loop)
    with pytest.raises(RuntimeError, match="loop failed"):
        reg.register_arrays(src, n_src, tgt, n_tgt, cfg, "se3", "pt2pl")
    assert seen == [(False, False, "highest")]     # the work ran at full
    assert _settings() == caller_settings


def test_fgr_call_leaves_the_callers_precision(caller_settings,
                                               monkeypatch):
    src, n_src, tgt, n_tgt = _batch()
    cfg = fgr.FGRConfig(iteration_number=4, tuple_trials=256)
    T, _, _ = fgr.fgr_register_arrays(src, n_src, tgt, n_tgt, cfg)
    assert bool(torch.isfinite(T).all())
    assert _settings() == caller_settings

    def broken_features(*a, **kw):
        raise RuntimeError("features failed")
    monkeypatch.setattr(fgr, "features", broken_features)
    with pytest.raises(RuntimeError, match="features failed"):
        fgr.fgr_register_arrays(src, n_src, tgt, n_tgt, cfg)
    assert _settings() == caller_settings


@pytest.mark.parametrize("algorithm", ["se3_pure_pt2pl", "se3_pure_pt2pt",
                                       "se3_pure_gicp"])
def test_cli_run_refuses_se3_pure(algorithm, capsys):
    with pytest.raises(SystemExit) as exc:
        cli.build_parser().parse_args(["run", algorithm, "a.ply", "b.ply"])
    assert exc.value.code == 2
    assert "invalid choice" in capsys.readouterr().err


@pytest.mark.parametrize("algorithm", ["se3_pt2pl", "fgr", "pt2pt",
                                       "se3_gicp_with_cf"])
def test_cli_run_accepts_the_jax_run_choices(algorithm):
    args = cli.build_parser().parse_args(["run", algorithm, "a.ply",
                                          "b.ply"])
    assert args.algorithm == algorithm and args.fn is cli.cmd_run


def test_se3_pure_still_runs_through_the_api():
    p = fixtures.golden_shape_problem(seed=4, n=300)
    res = reg.register_pair(p.source, p.target, "se3_pure_pt2pl",
                            GOLDEN.replace(max_num_iterations=2), device="cpu")
    assert np.isfinite(res.transformation).all()
