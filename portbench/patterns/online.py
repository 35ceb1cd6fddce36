"""One scan at a time through ``register_pair``, each warm-started from
the previous scan's transform; a lap of the sequence starts cold and
draws fresh frames."""

from __future__ import annotations

import time

import numpy as np

from portbench import traffic

UNITS = "lap"


def register(port, src, tgt, T0):
    return port.reg.register_pair(
        src, tgt, port.algorithm, port.cfg, dtype=port.torch_dtype,
        initial_T=T0, device=port.device)


def warm(driver) -> None:
    """Every pair of bucket widths the scans reach, cold and warm
    started."""
    rng = traffic.stream(driver.scene.seed, "warm", 1 << 20)
    pairs, _ = driver.scene.lap("warm", 1 << 20)
    s, t = pairs[0]
    ws = driver.widths()
    for a in ws:
        for b in ws:
            for T0 in (None, np.eye(4)):
                register(driver.port, traffic.resized(s, a, rng),
                         traffic.resized(t, b, rng), T0)


def run(driver, spans, open_, kind, start) -> list:
    out = []
    lap, sent = start, 0
    while open_(sent):
        with spans("generate"):
            pairs, gts = driver.scene.lap(kind, lap)
        T_prev = None
        for i, pair in enumerate(pairs):
            if not open_(sent):
                break
            t_sub = time.perf_counter()
            with spans("register_pair"):
                r = register(driver.port, *pair, T_prev)
            sent += 1
            T_prev = r.transformation
            out.append(traffic.unit(sent - 1, t_sub, time.perf_counter(),
                                    [r], gts[i:i + 1], [pair], lap=lap,
                                    scan=i))
        lap += 1
    return out
