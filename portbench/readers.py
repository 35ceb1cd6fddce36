"""The quantities the metric files under ``metrics/`` read from a run
(``harness.Run``).  A reader that finds nothing to read returns None,
and the metric is left out of the result."""

from __future__ import annotations

import numpy as np

from portbench import kernel_counts, peaks


def percentile(values, q: float) -> float:
    """The nearest-rank q-th percentile of all ``values``: the smallest
    value that at least q percent of them do not exceed."""
    v = np.sort(np.asarray(values, float))
    return float(v[max(0, int(np.ceil(q / 100.0 * len(v))) - 1)])


def pairs_per_s(run):
    """Pairs whose results reached the host in the window and passed
    the gate, over the window: from the first submission to the last
    result."""
    if not run.units or run.t_end <= run.t0:
        return None
    return float(run.passed().sum()) / (run.t_end - run.t0)


def scan_latency_ms(run, q: float):
    """The q-th percentile over every scan of the window of its time
    from submission to its transform on the host."""
    if not run.units:
        return None
    return 1e3 * percentile([u.t_done - u.t_submit for u in run.units], q)


def span_mean_ms(run, name: str):
    d = [b - a for n, a, b in run.spans.items if n == name]
    return 1e3 * float(np.mean(d)) if d else None


def memo_hit_share(run):
    hits, uploads = run.counters["hits"], run.counters["uploads"]
    return hits / (hits + uploads) if hits + uploads else None


def iterations_per_pair(run):
    if not run.units:
        return None
    return float(np.mean(np.concatenate([u.it for u in run.units])))


def captures_in_window(run):
    return float(run.counters["captures"])


def _kernel_seconds(run, tag: str, wrapper: str) -> float:
    """A kernel's device seconds in the traced window.  The profiler can
    drop records of kernels; where it recorded fewer launches than the
    program counted (``wrapper``'s count), the recorded mean time stands
    for the launches it missed."""
    t = sum(s for name, s in run.trace.kernels.items() if tag in name)
    seen = sum(n for name, n in run.trace.recorded.items() if tag in name)
    counted = (run.trace.launched or {}).get(wrapper, 0)
    if seen and counted > seen:
        t *= counted / seen
    return t


def k4_roofline(run):
    """K4's least time over its profiled time in the traced window, %."""
    if run.trace is None:
        return None
    t = _kernel_seconds(run, "match_affine_kernel", "nn_match_affine")
    us = run.trace.units
    if t <= 0 or not us:
        return None
    flops, nbytes = kernel_counts.k4_work(
        np.concatenate([u.n_src for u in us]),
        np.concatenate([u.n_tgt for u in us]),
        np.concatenate([u.it for u in us]),
        np.concatenate([u.pure for u in us]))
    return 100.0 * peaks.least_seconds(flops, nbytes) / t


def k1_roofline(run):
    """K1's least time over its profiled time in the traced window, %:
    both clouds of every traced pair, the source asked for the TOLDI
    ball sizes, the target for those and the normals' one."""
    if run.trace is None:
        return None
    t = _kernel_seconds(run, "thresholds_kernel",
                        "neighborhood_thresholds_batched")
    us = run.trace.units
    if t <= 0 or not us:
        return None
    reg = run.config["registration"]
    k = reg["number_of_nn_for_lrf"]
    toldi = {k // 3, k // 3 + 1, k}
    fs, bs = kernel_counts.k1_work(np.concatenate([u.n_src for u in us]),
                                   len(toldi))
    ft, bt = kernel_counts.k1_work(np.concatenate([u.n_tgt for u in us]),
                                   len(toldi | {reg["normals_knn"]}))
    return 100.0 * (peaks.least_seconds(fs, bs)
                    + peaks.least_seconds(ft, bt)) / t


def device_idle_share(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
