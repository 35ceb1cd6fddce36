"""The yardstick's arithmetic: rates and percentiles over all of the
window, kernel counts from valid counts alone, the trace's reduction."""

import numpy as np
import pytest

from portbench import compare, kernel_counts, peaks, profiling, readers
from portbench.harness import Run
from portbench.traffic import Spans, Unit


def unit(k, t_sub, t_done, n=4, bad=0, it=10, pure=4, ns=100, nt=120):
    gts = np.repeat(np.eye(4)[None], n, 0)
    T = gts.copy()
    T[:bad, 0, 3] = 1.0                      # misses the 0.25 gate
    return Unit(k, t_sub, t_done, T, np.full(n, it), np.full(n, pure), gts,
                np.full(n, ns), np.full(n, nt))


def run_of(units, t0, t_end, trace=None, config=None):
    return Run({}, config or {}, {}, 1.0, units, t0, t_end,
               {"hits": 3, "uploads": 5, "captures": 0}, Spans(), trace)


def test_rate_is_all_passing_pairs_over_the_whole_window():
    us = [unit(0, 0.0, 0.5), unit(1, 0.3, 1.0, bad=1),
          unit(2, 0.9, 4.0)]                  # one slow batch stays in
    run = run_of(us, 0.0, 4.0)
    assert readers.pairs_per_s(run) == pytest.approx(11 / 4.0)
    assert run.passed().size == 12 and int(run.passed().sum()) == 11


def test_percentiles_over_every_scan():
    lat = list(np.arange(1, 101) / 1e3)       # 1..100 ms
    lat[17] = 5.0                             # one stall, kept
    us = [unit(k, 0.0, d, n=1) for k, d in enumerate(lat)]
    run = run_of(us, 0.0, 10.0)
    assert readers.scan_latency_ms(run, 50) == pytest.approx(51.0)
    assert readers.scan_latency_ms(run, 95) == pytest.approx(96.0)
    assert readers.scan_latency_ms(run, 100) == pytest.approx(5000.0)


def test_k4_count_reads_valid_counts_and_phases():
    f, b = kernel_counts.k4_work([4167], [4167], [12], [5])
    assert f == pytest.approx(2 * 4167 * 4167 * (12 * 5 + 3 * 7))
    # the count has no padded width, tile or plan in it: twice the
    # valid sources, twice the work
    f2, _ = kernel_counts.k4_work([8334], [4167], [12], [5])
    assert f2 == pytest.approx(2 * f)
    assert b == pytest.approx(4 * (5 * (12 + 12 + 7) * 4167
                                   + 7 * (3 + 3 + 7) * 4167))


def test_k1_count_is_all_valid_distances():
    f, b = kernel_counts.k1_work([4167, 2048], 3)
    assert f == pytest.approx(8 * (4167 ** 2 + 2048 ** 2))
    assert b == pytest.approx(4 * 6 * (4167 + 2048))


def test_k4_share_from_the_traced_units():
    tr = profiling.Trace([unit(0, 0, 1, n=2, it=10, pure=4, ns=3000,
                               nt=4000)],
                         {"void match_affine_kernel<9>(...)": 2e-3,
                          "thresholds_kernel": 1e-3}, 0.5, 1.0, {}, 1.0,
                         {"void match_affine_kernel<9>(...)": 20,
                          "thresholds_kernel": 2})
    run = run_of([], 0, 1, trace=tr)
    flops, nbytes = kernel_counts.k4_work([3000] * 2, [4000] * 2, [10] * 2,
                                          [4] * 2)
    want = 100 * peaks.least_seconds(flops, nbytes) / 2e-3
    assert readers.k4_roofline(run) == pytest.approx(want)
    assert readers.device_idle_share(run) == pytest.approx(50.0)
    assert readers.k4_roofline(run_of([], 0, 1)) is None
    # records the profiler dropped: the recorded mean stands for them
    tr.launched = {"nn_match_affine": 40}
    assert readers.k4_roofline(run) == pytest.approx(want / 2)


def test_trace_reduction():
    dev = [("k", 10.0, 20.0), ("k", 15.0, 30.0), ("copy", 40.0, 50.0)]
    spans = [("submit", 0.0, 12.0), ("wait", 12.0, 45.0)]
    r = profiling.reduce(dev, spans)
    assert r["busy_s"] == pytest.approx(30e-6)
    assert r["window_s"] == pytest.approx(40e-6)
    assert r["idle_by_span"] == {"wait": pytest.approx(10e-6)}
    assert r["kernels"]["k"] == pytest.approx(25e-6)


def test_gate_and_gaps():
    T = np.repeat(np.eye(4)[None], 3, 0)
    gts = T.copy()
    ang = np.radians(2.5)
    gts[1, :2, :2] = [[np.cos(ang), -np.sin(ang)], [np.sin(ang), np.cos(ang)]]
    gts[2, 2, 3] = 0.3
    assert compare.gate(T, gts).tolist() == [True, False, False]
    g = compare.gaps([(T[1], 5)], [(gts[1], 7)])
    assert g["rot_gap_deg"] == pytest.approx(2.5)
    assert g["iter_gap"] == 2
