"""The bench protocols' two contracts with the captured program
(``models/program.py``), on the card.  These tests need a CUDA device
and ``nvcc``; elsewhere they skip.  Run them on a GPU machine with
``python -m pytest tests/test_torch_gpu_protocols.py -q --noconftest``.

  * An alpha sweep captures no program for its second alpha: alpha is a
    float of the program's input vector, not part of its key.
  * The warm start is an input buffer of the program: two calls of one
    key with different starts each give the eager loop's bits for their
    own start (``registration.register_arrays_eager``), so a warm frame
    never replays an earlier frame's start.
"""

import numpy as np
import pytest
import torch

from se3_icp_tpu_torch.bench import common, lounge_bench
from se3_icp_tpu_torch.datasets import fixtures
from se3_icp_tpu_torch.models import program, registration as reg
from se3_icp_tpu_torch.parallel import pairs
from se3_icp_tpu_torch.utils.config import KITTI_VANILLA

torch.set_num_threads(1)

pytestmark = pytest.mark.gpu


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the program is a CUDA graph")
    return torch.device("cuda")


def test_second_alpha_of_a_sweep_captures_nothing(card, tmp_path,
                                                  monkeypatch):
    d = str(tmp_path / "lounge")
    fixtures.make_lounge_fixture(d, n_frames=11, n_points=900)
    captures = []
    bench = lounge_bench.benchmark_lounge

    def counted(*a, **kw):
        c0 = program.totals["captures"]
        rep = bench(*a, **kw)
        captures.append(program.totals["captures"] - c0)
        return rep

    monkeypatch.setattr(lounge_bench, "benchmark_lounge", counted)
    monkeypatch.setattr(common, "hybrid_alpha_grid", lambda: [3.0, 100.0])
    reps = lounge_bench.lounge_alpha_sweep("se3_pt2pl", d)
    assert [r["rot_alpha"] for r in reps] == [3.0, 100.0]
    assert captures[1] == 0, captures
    assert all(r["avg_angular_SO3_error"] < 2.0 for r in reps)


def test_warm_start_is_an_input_of_the_program(card):
    p = fixtures.golden_shape_problem(seed=4, n=1500, **fixtures.SMALL_POSE)
    src, n_src, tgt, n_tgt = (torch.as_tensor(a, device=card)
                              for a in pairs.pack_pairs([(p.source,
                                                          p.target)]))
    starts = [np.eye(4), p.T_gt.copy()]
    starts[1][:3, 3] += (0.02, -0.01, 0.015)
    got, want = [], []
    for T0 in starts:
        t0 = torch.as_tensor(T0[None], dtype=torch.float32, device=card)
        got.append(reg.register_arrays(src, n_src, tgt, n_tgt,
                                       KITTI_VANILLA, "icp", "pt2pl",
                                       initial_T=t0))
        want.append(reg.register_arrays_eager(src, n_src, tgt, n_tgt,
                                              KITTI_VANILLA, "icp", "pt2pl",
                                              initial_T=t0))
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert torch.equal(a, b)
    # the two starts end in different bits, so the second call's bits
    # are its own start's, not the first call's start replayed
    assert not torch.equal(want[0][0], want[1][0])
