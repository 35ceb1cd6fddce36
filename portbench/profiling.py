"""The traced window: a fixed number of units of the cell's traffic under
``torch.profiler``, reduced to what the per-layer readers and the
result's ``breakdown`` read.

  * busy: the union of the intervals in which a device operation (a
    kernel, a copy, a set) ran, over the traced window: from the first
    device operation's start to the last one's end (the units' host work
    before the first launch and after the last result is left out, as a
    steady stream of units has none of it);
  * kernel time by name, summed over the window;
  * idle gaps: the stretches of the window with no device operation,
    each given to the benchmark span (submit, wait, register_pair; or
    generate, where no other span is open: it can run in a helper
    thread) the host was in at the gap's middle, ``other`` outside
    them, and summed by that name.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

SPAN_PREFIX = "portbench."


@dataclass
class Trace:
    units: list            # the traced units' records (traffic.Unit)
    kernels: dict          # device operation name -> seconds
    busy_s: float
    window_s: float
    idle_by_span: dict     # span name -> idle seconds
    host_window_s: float   # the same window on the host clock
    recorded: dict         # device operation name -> records in the trace
    launched: dict = None  # the program's launch counts over the window


def union_seconds(intervals) -> float:
    """Length of the union of (start, end) intervals, in their unit."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def gaps(intervals, lo: float, hi: float) -> list:
    """The (start, end) stretches of [lo, hi] that no interval covers."""
    out, cur = [], lo
    for a, b in sorted(intervals):
        if a > cur:
            out.append((cur, min(a, hi)))
        cur = max(cur, b)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(a, b) for a, b in out if b > a]


def reduce(device_ops, spans) -> dict:
    """``device_ops``: (name, start, end); ``spans``: (name, start, end)
    of the host, on one clock in microseconds."""
    inside = [(s, e) for _, s, e in device_ops]
    lo = min(s for s, _ in inside)
    hi = max(e for _, e in inside)
    kernels, recorded = {}, {}
    for name, s, e in device_ops:
        kernels[name] = kernels.get(name, 0.0) + (e - s) / 1e6
        recorded[name] = recorded.get(name, 0) + 1
    idle = {}
    for a, b in gaps(inside, lo, hi):
        mid = 0.5 * (a + b)
        open_ = [name for name, s, e in spans if s <= mid <= e]
        label = next((n for n in open_ if n != "generate"),
                     open_[0] if open_ else "other")
        idle[label] = idle.get(label, 0.0) + (b - a) / 1e6
    return dict(kernels=kernels, busy_s=union_seconds(inside) / 1e6,
                window_s=(hi - lo) / 1e6, idle_by_span=idle,
                recorded=recorded)


def traced(driver, spans, units: int, kind: str, start: int) -> Trace:
    """Run ``units`` units of the driver's pattern under the profiler,
    from unit index ``start``; ``spans`` records the benchmark's host
    spans as profiler ranges too."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        recs = driver.run(spans, 0.0, kind, units=units, start=start)
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
    dev, host = [], []
    for e in prof.events():
        if e.name.startswith(SPAN_PREFIX):
            if e.device_type == DeviceType.CPU:
                host.append((e.name[len(SPAN_PREFIX):], e.time_range.start,
                             e.time_range.end))
        elif e.device_type == DeviceType.CUDA:
            dev.append((e.name, e.time_range.start, e.time_range.end))
    if not dev:
        raise RuntimeError("the profiler recorded no device operation")
    r = reduce(dev, host)
    return Trace(recs, r["kernels"], r["busy_s"], r["window_s"],
                 r["idle_by_span"], host_s, r["recorded"])
