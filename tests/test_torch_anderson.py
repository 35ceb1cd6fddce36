"""Anderson acceleration in the port (``anderson_m`` >= 2:
``models/registration.anderson_step`` in ``loop_step``, the window in
``LoopState``) against the JAX package's loop, on the CPU.

Held on the exact route (``exact_knn=True``) against the JAX CPU route,
on the noisy resampled problems of ``torch_port_cases``, per pair:
equal iteration counts and 1e-9 deg at float64 (``mse`` 1e-9, a long R3
phase where the accelerated step is taken), equal counts and 1e-3 deg
at float32 (``mse`` 1e-6, above float32's noise).  The window changes
the counts against ``anderson_m = 0``, so the hold is not of an idle
step.  The window's buffers are loop state: a done pair keeps them, and
the captured program's body carries them between groups.  On the
card, ``anderson_m`` = 3 and 5 on the captured program give the eager
loop's bits with no host sync (``tests/test_torch_gpu_program.py``).
"""

import numpy as np
import pytest
import torch

from se3_icp_tpu.parallel import pairs as j_pairs

import torch_port_cases as cases
from se3_icp_tpu_torch.datasets import fixtures
from se3_icp_tpu_torch.models import program, registration as reg
from se3_icp_tpu_torch.parallel import pairs
from se3_icp_tpu_torch.utils.config import (GOLDEN, RegistrationConfig,
                                            parse_algorithm)

torch.set_num_threads(2)

MSE = {"float64": 1e-9, "float32": 1e-6}
TOL = {"float64": (1e-9, 1e-10), "float32": (1e-3, 1e-4)}


def _run(m, dtype, cap, alg="se3_pt2pl"):
    probs = cases.problems("bumpy", cases.NOISY)
    pair_list = [(p.source, p.target) for p in probs]
    jcfg, cfg = cases.configs({"anderson_m": m, "mse": MSE[dtype]}, cap)
    dt = np.dtype(dtype)
    j_res = j_pairs.register_pairs(pair_list, alg, jcfg, mesh=None,
                                   dtype=dt)
    t_res = pairs.register_pairs(pair_list, alg, cfg, dtype=dt,
                                 device="cpu", exact_knn=True)
    return probs, j_res, t_res


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("m", [3, 5])
def test_anderson_matches_jax(m, dtype):
    cap = {("float64", 3): 701, ("float64", 5): 702, ("float32", 3): 703,
           ("float32", 5): 704}[dtype, m]
    probs, j_res, t_res = _run(m, dtype, cap)
    cases.hold(probs, j_res, t_res, *TOL[dtype])


def test_the_window_changes_the_iterations():
    """The same problems without the window take other counts: the
    accelerated step is really taken."""
    probs = cases.problems("bumpy", cases.NOISY)
    pair_list = [(p.source, p.target) for p in probs]
    its = []
    for m in (0, 5):
        cfg = RegistrationConfig(max_num_iterations=150, anderson_m=m,
                                 **{**cases.BASE, "mse": MSE["float64"]})
        its.append([r.num_iterations for r in pairs.register_pairs(
            pair_list, "se3_pt2pl", cfg, dtype=np.float64, device="cpu",
            exact_knn=True)])
    assert its[0] != its[1]


def test_anderson_m_one_is_refused():
    p = fixtures.golden_shape_problem(seed=1, n=200)
    with pytest.raises(ValueError, match="anderson_m"):
        reg.register_pair(p.source, p.target, "se3_pt2pl",
                          RegistrationConfig(anderson_m=1), device="cpu")


def test_the_window_is_loop_state_done_pairs_keep():
    probs = cases.problems("bumpy", cases.NOISY)
    src, n_src, tgt, n_tgt = (torch.as_tensor(a) for a in pairs.pack_pairs(
        [(p.source, p.target) for p in probs], dtype=np.float64))
    cfg = GOLDEN.replace(anderson_m=3, mse=1e-9, max_num_iterations=40)
    mode, variant = parse_algorithm("se3_pt2pl")
    floats, scfg = reg.split_cfg(cfg, src.dtype, src.device)
    h = reg.hyper(floats)
    with torch.no_grad():
        ms, pre = reg.setup(src, n_src, tgt, n_tgt, scfg, mode, variant, h,
                            exact_knn=True)
        s, c = reg.init_loop(ms, pre.scaling, scfg, mode, h)
        assert len(s.tensors()) == 11           # 7 + the window's 4
        assert s.aa_X.shape == (2, 3, 6) and s.aa_n.dtype == torch.int32
        used = False
        for _ in range(c.hist_len):
            prev = s
            s = reg.loop_step(s, ms, c)
            for old, new in zip(prev.tensors(), s.tensors()):
                keep = prev.done.view((-1,) + (1,) * (old.dim() - 1))
                assert torch.equal(torch.where(keep, old, new), new)
            used |= bool((s.aa_n[~prev.done] > 0).any())
        assert used and bool(s.done.all())
        assert int(s.aa_n.max()) <= 2
        # the program's body, every group run, carries the window
        inp = dict(src=src, n_src=n_src, tgt=tgt, n_tgt=n_tgt, floats=floats)

        class Always:
            def __call__(self, pred):
                return self

            def __enter__(self):
                return self

            def __exit__(self, *exc):
                return False

        T, it, pure, _, _ = program._program(inp, scfg, mode, variant, True,
                                             False, Always())
        ref = reg.register_arrays_eager(src, n_src, tgt, n_tgt, cfg, mode,
                                        variant, exact_knn=True)
    assert torch.equal(T, ref[0]) and torch.equal(it, ref[1])
    assert torch.equal(pure, ref[2])
