"""The captured registration program (``models/program.py``) and the
serving surface on the card.  These tests need a CUDA device and
``nvcc``; elsewhere they skip (the program is a CUDA graph).  Run them
on a GPU machine with ``python -m pytest tests/test_torch_gpu_program.py
-q --noconftest``.

Held: every mode and estimator on the captured program -- the pt2pt
variants too, their rotation from ``solve.kabsch3`` -- gives the eager
loop's bits (``registration.register_arrays_eager``) at 8 pairs, with
the eager loop's step count and no host sync, the loop kernels' launches
counted on the card once a step that ran; configs that differ in a
traced float share one program and each gets its own eager bits; a
second dispatched batch
leaves the first one's results alone; a failing capture raises and
nothing runs eagerly in its place; SHOT frames (exact and capped) and
Anderson acceleration (``anderson_m`` 3 and 5) give the eager loop's
bits on the captured program with no host sync; FGR's captured program
(``program.run_fgr``) gives ``fgr_register_arrays``' transforms and
per-pair counts bit for bit, on a second batch of other clouds too (the
inputs reloaded), with a caller's own triples and with the default ones
after them (the triples buffer reloaded); the exact route with GICP
covariances captures and gives the eager bits.
"""

import numpy as np
import pytest
import torch

from se3_icp_tpu_torch.datasets import fixtures
from se3_icp_tpu_torch.models import program, registration as reg
from se3_icp_tpu_torch.ops import _build, cuda_loop
from se3_icp_tpu_torch.parallel import pairs
from se3_icp_tpu_torch.utils.config import GOLDEN, LOUNGE, parse_algorithm

torch.set_num_threads(1)

pytestmark = pytest.mark.gpu

# (algorithm, config, problem kwargs), as chip_smoke.py's batches
ALGORITHMS = [
    ("se3_pt2pl", GOLDEN, {}),
    ("se3_gicp", GOLDEN, {}),
    ("se3_gicp_with_cf", LOUNGE, fixtures.NOISY),
    ("se3_pure_pt2pl", GOLDEN.replace(alpha_rot=0.1,
                                      max_num_se3_iterations=30), {}),
    ("se3_pt2pl", GOLDEN.replace(estimated_overlap=0.75), fixtures.NOISY),
    ("pt2pl", GOLDEN, fixtures.SMALL_POSE),
    ("gicp", GOLDEN, fixtures.SMALL_POSE),
    ("se3_pt2pt", GOLDEN, {}),
    ("pt2pt", GOLDEN, fixtures.SMALL_POSE),
    ("se3_pure_pt2pt", GOLDEN.replace(alpha_rot=0.1,
                                      max_num_se3_iterations=30), {}),
]


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the program is a CUDA graph")
    return torch.device("cuda")


def _batch(card, n_pairs=8, **kw):
    probs = [fixtures.golden_shape_problem(seed=s, **kw)
             for s in range(1, n_pairs + 1)]
    arrs = pairs.pack_pairs([(p.source, p.target) for p in probs])
    return probs, [torch.as_tensor(a, device=card) for a in arrs]


def _same(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("alg,cfg,kw", ALGORITHMS,
                         ids=[f"{a}-{i}" for i, (a, _, _) in
                              enumerate(ALGORITHMS)])
def test_the_captured_program_gives_the_eager_bits(card, alg, cfg, kw):
    _, (src, n_src, tgt, n_tgt) = _batch(card, **kw)
    mode, variant = parse_algorithm(alg)
    assert reg.loop_route(card, mode, variant) == "graph"
    st, se = {}, {}
    got = reg.register_arrays(src, n_src, tgt, n_tgt, cfg, mode, variant,
                              stats=st)
    ref = reg.register_arrays_eager(src, n_src, tgt, n_tgt, cfg, mode,
                                    variant, stats=se)
    assert _same(got, ref)
    assert st["loop_steps"] == se["loop_steps"] > 0
    assert st["host_syncs"] == 0 and se["host_syncs"] > 0
    # a second call replays the same program; its loop kernels count
    # one launch a step that ran on the card
    before = program.info()["captures"]
    _build.zero_launches()
    again = reg.register_arrays(src, n_src, tgt, n_tgt, cfg, mode, variant)
    n = _build.launches()
    assert _same(again, ref) and program.info()["captures"] == before
    assert (n["nn_match_affine"] == n["loop_epilogue_batched"]
            == se["loop_steps"])


def test_history_and_warm_start_on_the_captured_program(card):
    _, (src, n_src, tgt, n_tgt) = _batch(card)
    T0 = torch.eye(4, device=card).repeat(src.shape[0], 1, 1)
    T0[:, :3, 3] = 0.05
    got = reg.register_arrays(src, n_src, tgt, n_tgt, GOLDEN, "se3",
                              "pt2pl", record_history=True, initial_T=T0)
    ref = reg.register_arrays_eager(src, n_src, tgt, n_tgt, GOLDEN, "se3",
                                    "pt2pl", record_history=True,
                                    initial_T=T0)
    assert _same(got, ref)


def test_a_traced_float_shares_one_program(card):
    _, (src, n_src, tgt, n_tgt) = _batch(card)
    program.clear()
    outs = []
    for alpha in (3.0, 1.5):
        cfg = GOLDEN.replace(alpha_rot=alpha, mse_switch_error=2e-4)
        got = reg.register_arrays(src, n_src, tgt, n_tgt, cfg, "se3",
                                  "pt2pl")
        ref = reg.register_arrays_eager(src, n_src, tgt, n_tgt, cfg, "se3",
                                        "pt2pl")
        assert _same(got, ref)
        outs.append(got)
    assert program.info()["entries"] == 1
    assert not torch.equal(outs[0][0], outs[1][0])


def test_a_second_dispatch_leaves_the_first_results(card):
    probs = [fixtures.golden_shape_problem(seed=s) for s in range(1, 9)]
    moved = [fixtures.golden_shape_problem(seed=s, **fixtures.SMALL_POSE)
             for s in range(1, 9)]
    a = [(p.source, p.target) for p in probs]
    b = [(p.source, p.target) for p in moved]
    ref_a = pairs.register_pairs(a, "se3_pt2pl", GOLDEN)
    ref_b = pairs.register_pairs(b, "se3_pt2pl", GOLDEN)
    first = pairs.register_pairs_async(a, "se3_pt2pl", GOLDEN)
    second = pairs.register_pairs_async(b, "se3_pt2pl", GOLDEN)
    for got, ref in ((second.result(), ref_b), (first.result(), ref_a)):
        for x, y in zip(got, ref):
            assert np.array_equal(x.transformation, y.transformation)
            assert x.num_iterations == y.num_iterations


def test_a_failing_capture_raises_and_runs_nothing_eagerly(card,
                                                           monkeypatch):
    _, (src, n_src, tgt, n_tgt) = _batch(card, n_pairs=3)
    real = cuda_loop.loop_epilogue_batched

    def refuse(*a, **kw):
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("refused under capture")
        return real(*a, **kw)
    monkeypatch.setattr(cuda_loop, "loop_epilogue_batched", refuse)
    ran = []
    monkeypatch.setattr(reg, "run_loop",
                        lambda *a, **kw: ran.append(1) or 1 / 0)
    k4 = _build.launches()["nn_match_affine"]
    cfg = GOLDEN.replace(max_num_iterations=37)     # a program of its own
    with pytest.raises(RuntimeError, match="capturing the registration"):
        reg.register_arrays(src, n_src, tgt, n_tgt, cfg, "se3", "pt2pl")
    assert not ran
    # the warm-up's eager launches only (one group), no loop after it
    assert _build.launches()["nn_match_affine"] - k4 == reg._POLL_EVERY
    torch.cuda.synchronize()
    monkeypatch.undo()
    got = reg.register_arrays(src, n_src, tgt, n_tgt, cfg, "se3", "pt2pl")
    assert _same(got, reg.register_arrays_eager(src, n_src, tgt, n_tgt, cfg,
                                                "se3", "pt2pl"))


# SHOT frames (both routes: their setup takes the exact route) and
# Anderson acceleration (its window is loop state, its solve has no host
# check) on the captured program
OPTIONS = [
    ("shot_exact", GOLDEN.replace(lrf_method="shot"), {}),
    ("shot_capped", GOLDEN.replace(lrf_method="shot", shot_exact=False), {}),
    ("anderson_3", GOLDEN.replace(anderson_m=3), fixtures.NOISY),
    ("anderson_5", GOLDEN.replace(anderson_m=5, mse=1e-7), fixtures.NOISY),
]


@pytest.mark.parametrize("name,cfg,kw", OPTIONS, ids=[o[0] for o in OPTIONS])
def test_shot_and_anderson_on_the_captured_program(card, name, cfg, kw):
    _, (src, n_src, tgt, n_tgt) = _batch(card, **kw)
    assert reg.loop_route(card, "se3", "pt2pl") == "graph"
    captures = program.info()["captures"]
    st, se = {}, {}
    got = reg.register_arrays(src, n_src, tgt, n_tgt, cfg, "se3", "pt2pl",
                              stats=st)
    ref = reg.register_arrays_eager(src, n_src, tgt, n_tgt, cfg, "se3",
                                    "pt2pl", stats=se)
    assert program.info()["captures"] == captures + 1
    assert _same(got, ref)
    assert st["host_syncs"] == 0 and st["loop_steps"] == se["loop_steps"]


def test_fgr_program_gives_the_eager_bits(card):
    from se3_icp_tpu_torch.models import fgr
    cfg = fgr.FGRConfig(iteration_number=32)        # a program of its own
    _, first = _batch(card)
    _, moved = _batch(card, **fixtures.SMALL_POSE)
    captures = program.info()["captures"]
    outs = []
    for arrs in (first, moved):
        se, sg = {}, {}
        ref = fgr.fgr_register_arrays(*arrs, cfg, stats=se)
        got = pairs.register_batch(*arrs, cfg, "fgr", stats=sg)
        assert _same(got, ref) and se == sg
        assert len(sg["reciprocal"]) == first[0].shape[0]
        outs.append(got)
    assert program.info()["captures"] == captures + 1
    assert not torch.equal(outs[0][0], outs[1][0])
    # a caller's own triples, then the default ones again
    raw = torch.randint(0, 1 << 30, (cfg.tuple_trials, 3),
                        generator=torch.Generator().manual_seed(5))
    own = fgr.dispatch_arrays(*first, cfg, raw=raw).settle()
    assert _same(own, fgr.fgr_register_arrays(*first, cfg,
                                              raw=raw.to(card)))
    assert not torch.equal(own[0], outs[0][0])
    assert _same(fgr.dispatch_arrays(*first, cfg).settle(), outs[0])
    assert program.info()["captures"] == captures + 1


def test_the_exact_route_with_gicp_on_the_captured_program(card):
    # the GICP covariances' constant is made by fills on the card, so the
    # exact route's setup holds no copy from the host
    _, (src, n_src, tgt, n_tgt) = _batch(card)
    st, se = {}, {}
    got = reg.register_arrays(src, n_src, tgt, n_tgt, GOLDEN, "se3", "gicp",
                              stats=st, exact_knn=True)
    ref = reg.register_arrays_eager(src, n_src, tgt, n_tgt, GOLDEN, "se3",
                                    "gicp", stats=se, exact_knn=True)
    assert _same(got, ref)
    assert st["host_syncs"] == 0 and st["loop_steps"] == se["loop_steps"]
