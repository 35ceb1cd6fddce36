"""Batches through ``register_pairs_async``, with ``in_flight`` batches
dispatched while the host waits for the oldest; the next batch's clouds
are made while the card runs."""

from __future__ import annotations

import collections
import time

from portbench import traffic

UNITS = "batch"


def submit(port, pairs):
    return port.pairs.register_pairs_async(
        pairs, port.algorithm, port.cfg, dtype=port.np_dtype,
        device=port.device, mesh=False)


def warm(driver) -> None:
    traffic.warm_batches(driver, submit)


def run(driver, spans, open_, kind, start) -> list:
    size, depth = driver.traffic["batch"], driver.traffic["in_flight"]
    pending = collections.deque()
    out = []
    k = start
    ready = driver.make(spans, kind, k, size) if open_(0) else None
    while True:
        if ready is not None:
            pairs, gts = ready
            t_sub = time.perf_counter()
            with spans("submit"):
                p = submit(driver.port, pairs)
            pending.append((k, t_sub, p, gts, pairs))
            k += 1
            ready = (driver.make(spans, kind, k, size)
                     if open_(k - start) else None)
            if ready is not None and len(pending) <= depth:
                continue
        if not pending:
            return out
        j, t_sub, p, gts, pairs = pending.popleft()
        with spans("wait"):
            res = p.result()
        out.append(traffic.unit(j, t_sub, time.perf_counter(), res, gts,
                                pairs))
