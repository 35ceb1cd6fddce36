"""Batches through the synchronous main path, one at a time: the
submission (``register_pairs_async``: pack, upload, dispatch) and the
wait for its results (``PendingBatch.result``), which together are
``register_pairs``.  The client makes the next batch's clouds in a
helper thread during the wait, so that the loop times the program and
not the client."""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor

from portbench import traffic

UNITS = "batch"


def submit(port, pairs):
    return port.pairs.register_pairs_async(
        pairs, port.algorithm, port.cfg, dtype=port.np_dtype,
        device=port.device, mesh=False)


def warm(driver) -> None:
    traffic.warm_batches(driver, submit)


def run(driver, spans, open_, kind, start) -> list:
    size = driver.traffic["batch"]
    out = []
    k = start
    with ThreadPoolExecutor(1) as client:
        nxt = (client.submit(driver.make, spans, kind, k, size)
               if open_(0) else None)
        while nxt is not None:
            pairs, gts = nxt.result()
            t_sub = time.perf_counter()
            with spans("submit"):
                p = submit(driver.port, pairs)
            # the next batch is made while the card runs this one, not
            # while the host packs it
            nxt = (client.submit(driver.make, spans, kind, k + 1, size)
                   if open_(k + 1 - start) else None)
            with spans("wait"):
                res = p.result()
            out.append(traffic.unit(k, t_sub, time.perf_counter(), res, gts,
                                    pairs))
            k += 1
    return out
