"""The invariants the captured registration program
(``models/program.py``) rests on, held on the CPU with the kernels'
plain versions, for every mode and estimator of ``torch_port_cases``:

  (a) every step of the loop run through ``loop_step`` with no poll
      gives the polled eager loop's bits: a step after every pair is
      done changes nothing, so the captured loop may run or skip the
      tail as a group;
  (b) setup and steps on the traced float vector (``split_cfg``) give
      the bits of the same code on the config's Python floats;
  (c) the program's own body (``program._program``: groups of
      ``_POLL_EVERY`` steps copied into the state buffers, the device
      step counter), with every group run, gives the eager route's bits;
  (d) which loop each algorithm takes (``loop_route``): the captured
      program on the card for every one, the pt2pt variants too, the
      eager loop on the CPU.

Two pairs of ~450 points a case, float32, a loop cap of 40.
"""

import contextlib

import pytest
import torch

import torch_port_cases as cases
from se3_icp_tpu_torch.models import program, registration as reg
from se3_icp_tpu_torch.parallel import pairs
from se3_icp_tpu_torch.utils.config import (ALGORITHMS, RegistrationConfig,
                                            parse_algorithm)

torch.set_num_threads(1)

IDS = [c[0] for c in cases.CASES]


def _batch(case):
    name, alg, ckw, kind, pkw = case
    probs = cases.problems(kind, pkw)
    cfg = RegistrationConfig(max_num_iterations=40, **{**cases.BASE, **ckw})
    arrs = pairs.pack_pairs([(p.source, p.target) for p in probs])
    mode, variant = parse_algorithm(alg)
    return [torch.as_tensor(a) for a in arrs], cfg, mode, variant


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("case", cases.CASES, ids=IDS)
def test_unpolled_steps_give_the_polled_loops_bits(case):
    (src, n_src, tgt, n_tgt), cfg, mode, variant = _batch(case)
    floats, scfg = reg.split_cfg(cfg, src.dtype, src.device)
    h = reg.hyper(floats)
    with torch.no_grad():
        ms, pre = reg.setup(src, n_src, tgt, n_tgt, scfg, mode, variant,
                            h=h)
        stats = {}
        polled = reg.run_loop(ms, pre.scaling, scfg, mode,
                              record_history=True, stats=stats, h=h)
        s, c = reg.init_loop(ms, pre.scaling, scfg, mode, h, None, True)
        for _ in range(c.hist_len):
            s = reg.loop_step(s, ms, c)
    # the polled loop stopped early, so the tail really ran here
    assert stats["loop_steps"] < c.hist_len and stats["host_syncs"] > 0
    assert int(polled[1].max()) <= stats["loop_steps"]
    _same(polled[:3], (s.T, s.it, s.pure_it))
    # the history past a pair's own iterations is undefined (a done pair
    # writes its pose one past them on every later step)
    for b, n in enumerate(s.it.tolist()):
        assert torch.equal(polled[3][b, :n], s.hist[b, :n])


@pytest.mark.parametrize("case", cases.CASES, ids=IDS)
def test_the_float_vector_gives_the_python_floats_bits(case):
    (src, n_src, tgt, n_tgt), cfg, mode, variant = _batch(case)
    is_se3 = mode != "icp"
    h = reg.Hyper(*reg.traced_values(cfg))          # Python floats
    with torch.no_grad():
        ms, pre = reg.setup(src, n_src, tgt, n_tgt, cfg, mode, variant, h)
        T, it, pure, _ = reg.run_loop(ms, pre.scaling, cfg, mode, h)
    on_floats = (reg.to_original(T, pre, is_se3), it, pure)
    on_vector = reg.register_arrays_eager(src, n_src, tgt, n_tgt, cfg, mode,
                                          variant)
    _same(on_floats, on_vector)
    # the vector route reads no traced value from the static config
    scfg = reg.static_cfg(cfg)
    assert all(getattr(scfg, f) in (0.0, 1.0) for f in reg._TRACED_FIELDS)


@pytest.mark.parametrize("case", cases.CASES, ids=IDS)
def test_the_programs_body_gives_the_eager_bits(case):
    (src, n_src, tgt, n_tgt), cfg, mode, variant = _batch(case)
    history = case[0].startswith(("se3_pt2pl", "icp_gicp"))
    T0 = None
    if case[0] == "se3_gicp":      # a warm start through the T0 buffer
        T0 = torch.eye(4).repeat(src.shape[0], 1, 1)
        T0[:, :3, 3] = 0.01
    floats, scfg = reg.split_cfg(cfg, src.dtype, src.device)
    inp = dict(src=src, n_src=n_src.to(torch.int32), tgt=tgt,
               n_tgt=n_tgt.to(torch.int32), floats=floats)
    if T0 is not None:
        inp["T0"] = T0
    with torch.no_grad():
        T, it, pure, hist, steps = program._program(
            inp, scfg, mode, variant, False, history,
            lambda pred: contextlib.nullcontext())
    eager = reg.register_arrays_eager(src, n_src, tgt, n_tgt, cfg, mode,
                                      variant, record_history=history,
                                      initial_T=T0)
    _same(eager[:3], (T, it, pure))
    if history:     # defined up to each pair's own iterations
        for b, n in enumerate(it.tolist()):
            assert torch.equal(eager[3][b, :n], hist[b, :n])
    assert int(steps) == max(cfg.max_num_iterations,
                             cfg.max_num_se3_iterations) + 1


def test_every_algorithm_takes_the_graph_on_the_card():
    for alg in ALGORITHMS:
        mode, variant = parse_algorithm(alg)
        assert reg.loop_route("cuda", mode, variant) == "graph", alg
        assert reg.loop_route("cuda:0", mode, variant) == "graph", alg
        assert reg.loop_route("cpu", mode, variant) == "eager", alg