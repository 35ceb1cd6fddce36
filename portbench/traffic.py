"""The one traffic generator, and the driver that runs a cell's pattern
with it.

A configuration's ``scene`` says what its clouds are: its ``kind`` names
a file ``scenes/<kind>.py`` whose ``Scene`` makes them.  A traffic file
(``traffic/<mix>.json``) says how they arrive: its ``pattern`` names a
file ``patterns/<pattern>.py`` that holds the loop and the program's
entry call, and the rest are parameters.  Every unit of traffic (a
batch, or an online lap) is drawn from its own random stream,
``stream(seed, kind, index)``, so the same seed gives the same inputs,
a unit can be made again after the window to check its answers, and
every seed asks for the same work in sizes and order.

A pattern file holds

  * ``UNITS``: what a unit is, ``"batch"`` (pairs made by
    ``Scene.batch``) or ``"lap"`` (a sequence made by ``Scene.lap``,
    registered scan by scan, each warm-started from the last);
  * ``warm(driver)``: set-up's capture of every program key the traffic
    can use;
  * ``run(driver, spans, open_, kind, start)``: the loop, a closed loop
    in one process on one card; it submits units while ``open_(sent)``
    holds and returns their records (``unit``) in order of completion.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import numpy as np

_KINDS = {"pool": 1, "batch": 2, "lap": 3, "warm": 4, "sample": 5}


def stream(seed: int, kind: str, index: int = 0) -> np.random.Generator:
    """The random stream of one unit of a run."""
    return np.random.default_rng([seed % (1 << 64), _KINDS[kind], index])


def resized(cloud: np.ndarray, n: int, rng) -> np.ndarray:
    """``cloud`` cut or grown (jittered copies of its points) to n rows:
    set-up clouds of a chosen width."""
    if len(cloud) >= n:
        return cloud[:n]
    extra = cloud[rng.integers(0, len(cloud), n - len(cloud))]
    return np.concatenate([cloud, extra + rng.normal(scale=1e-2,
                                                     size=extra.shape)])


# --- the record of a run ----------------------------------------------


@dataclass
class Unit:
    """One call's outcome: its pairs' transforms, iteration counts,
    ground truths and valid counts, and when it was submitted and its
    results reached the host."""

    index: int
    t_submit: float
    t_done: float
    T: np.ndarray
    it: np.ndarray
    pure: np.ndarray
    gts: np.ndarray
    n_src: np.ndarray
    n_tgt: np.ndarray
    lap: int = -1
    scan: int = -1


@dataclass
class Spans:
    """Host spans of the benchmark's own loop: (name, start, end), on
    the host clock; with ``profiled`` each is also a
    ``torch.profiler.record_function`` range."""

    profiled: bool = False
    items: list = field(default_factory=list)

    @contextlib.contextmanager
    def __call__(self, name: str):
        if self.profiled:
            import torch
            rf = torch.profiler.record_function("portbench." + name)
        else:
            rf = contextlib.nullcontext()
        t0 = time.perf_counter()
        with rf:
            yield
        self.items.append((name, t0, time.perf_counter()))


def unit(index, t_sub, t_done, results, gts, pairs, **kw) -> Unit:
    """The record of a call from the program's results."""
    return Unit(index, t_sub, t_done,
                np.stack([r.transformation for r in results]),
                np.array([r.num_iterations for r in results]),
                np.array([r.num_pure_se3_iterations for r in results]),
                gts, np.array([len(s) for s, _ in pairs]),
                np.array([len(t) for _, t in pairs]), **kw)


def warm_batches(driver, submit) -> None:
    """Set-up of a batch pattern whose entry is ``submit(port, pairs)``
    (returning a pending batch): one batch at every pair of bucket widths
    its clouds reach."""
    rng = stream(driver.scene.seed, "warm", 1 << 20)
    pairs, _ = driver.scene.batch("warm", 1 << 20, driver.traffic["batch"])
    ws = driver.widths()
    if len(ws) == 1:        # the clouds reach one width only
        submit(driver.port, pairs).result()
        return
    for a in ws:
        for b in ws:
            submit(driver.port, [(resized(s, a, rng), resized(t, b, rng))
                                 for s, t in pairs]).result()


# --- the driver ----------------------------------------------------------


class Driver:
    """Drives the program with one cell's traffic.  ``port``: the
    program (``harness.Port``); ``pattern``: the traffic's pattern
    module."""

    def __init__(self, port, scene, traffic: dict, pattern):
        self.port, self.scene, self.traffic = port, scene, traffic
        self.pattern = pattern

    def widths(self) -> list:
        lo, hi = self.scene.count_range()
        return sorted({self.port.bucket(n) for n in range(lo, hi + 1)})

    def make(self, spans, kind, k, size):
        with spans("generate"):
            return self.scene.batch(kind, k, size)

    def warm(self) -> dict:
        """Capture every program key the traffic can use, then run
        ``warm_units`` units of the pattern.  Returns the seconds of
        each part."""
        t0 = time.perf_counter()
        self.pattern.warm(self)
        t1 = time.perf_counter()
        self.run(Spans(), 0.0, "warm", units=self.traffic["warm_units"])
        return {"keys_s": t1 - t0, "warm_units_s": time.perf_counter() - t1,
                "widths": self.widths()}

    def run(self, spans: Spans, seconds: float, kind: str | None = None,
            units: int | None = None, start: int = 0) -> list:
        """Drive the program for ``seconds`` (new units are submitted
        while the window is open; it closes at the first result after
        that), or for exactly ``units`` units.  Returns the units'
        records in order of completion."""
        t0 = time.perf_counter()

        def open_(n_sent):
            if units is not None:
                return n_sent < units
            return time.perf_counter() - t0 < seconds
        return self.pattern.run(self, spans, open_,
                                kind or self.pattern.UNITS, start)
