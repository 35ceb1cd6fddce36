"""One run of one cell: set-up, the measured window, with ``--trace 1`` a
traced window after it, the comparison with the plain reference, and
the result line.

Only the port, ``se3_icp_tpu_torch``, is measured, through the public
entry points that each traffic pattern calls (``patterns/``).  The
benchmark reads the program's counters (the upload memo's hits and
uploads, the captured programs' count) and the names of its kernels in
the profiler's trace, and nothing else of it.
"""

from __future__ import annotations

import gc
import sys
import time
from dataclasses import dataclass

import numpy as np

from portbench import compare, profiling, traffic as traffic_mod
from portbench.spec import Bench

# what the process that prints a result must not hold, by top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "se3_icp_tpu")


class Port:
    """The program, set up for one configuration: the modules whose
    entry points the traffic's pattern calls, and the configuration's
    settings in the program's types."""

    def __init__(self, config: dict, device: str):
        import torch

        from se3_icp_tpu_torch.models import program, registration
        from se3_icp_tpu_torch.parallel import pairs
        from se3_icp_tpu_torch.utils.config import RegistrationConfig
        self.torch, self.pairs, self.reg = torch, pairs, registration
        self.program = program
        self.cfg = RegistrationConfig(**config["registration"])
        self.algorithm = config["algorithm"]
        self.np_dtype = np.dtype(config["dtype"])
        self.torch_dtype = getattr(torch, config["dtype"])
        self.device = device

    def bucket(self, n: int) -> int:
        return self.reg._bucket(n)

    def launches(self) -> dict:
        """The program's own device counts of its kernels' launches, by
        wrapper (read after the device has finished)."""
        from se3_icp_tpu_torch.ops import _build
        return _build.launches()

    def counters(self) -> dict:
        c = dict(self.pairs.cloud_cache_counts)
        c["captures"] = self.program.totals["captures"]
        return c

    def free(self) -> None:
        """Drop the program's captured programs, uploads and pools."""
        if self.torch.device(self.device).type == "cuda":
            self.program.clear()
            self.pairs._cloud_cache.clear()
            gc.collect()
            self.torch.cuda.empty_cache()


@dataclass
class Run:
    """What the metric readers read."""

    cell: dict
    config: dict
    traffic: dict
    setup_s: float
    units: list                # the window's units (traffic.Unit)
    t0: float                  # the window's start and end, host clock
    t_end: float
    counters: dict             # the program's counters: window deltas
    spans: object              # traffic.Spans of the window
    trace: object              # profiling.Trace, or None

    def passed(self) -> np.ndarray:
        return np.concatenate([compare.gate(u.T, u.gts) for u in self.units])


def device_info(count: int) -> dict:
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count}


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(bench: Bench, workload: str, seed: int, seconds: float,
             traced: bool, t_start: float, device: str = "cuda") -> tuple:
    """Run one cell once.  Returns (result dict, lines for standard
    error, notes for earlier lines of standard output).
    ``device="cpu"`` runs the program's plain CPU route: for the
    benchmark's own tests only (no device numbers come out)."""
    cell = bench.cell(workload)
    config = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    limits = bench.limits(workload)["compare"]
    metrics = bench.metrics(cell, traced)
    readers = {m["name"]: bench.reader(m["name"]) for m in metrics}
    ref = bench.reference(config["reference"])
    pattern = bench.pattern(traffic)
    kind = pattern.UNITS
    on_card = device != "cpu"
    if on_card:
        import torch
        torch.cuda.reset_peak_memory_stats()

    marks = {"start": time.perf_counter() - t_start}
    port = Port(config, device)
    marks["import_s"] = time.perf_counter() - t_start
    scene = bench.scene(config, traffic, seed)
    marks["scene_s"] = time.perf_counter() - t_start
    driver = traffic_mod.Driver(port, scene, traffic, pattern)
    marks.update(driver.warm())

    spans = traffic_mod.Spans()
    gc.collect()
    gc.freeze()         # what set-up made stays out of the window's GC
    before = port.counters()
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    units = driver.run(spans, seconds)
    t_end = units[-1].t_done if units else time.perf_counter()
    after = port.counters()
    counters = {k: after[k] - before[k] for k in after}
    trace = None
    if traced:
        start = 1 + max(u.lap if kind == "lap" else u.index for u in units)
        launched = port.launches()
        trace = profiling.traced(
            driver, traffic_mod.Spans(profiled=True),
            traffic["trace_units"], kind, start)
        trace.launched = {k: v - launched.get(k, 0)
                          for k, v in port.launches().items()}
    info = device_info(cell["chips"]) if on_card else {"platform": "cpu"}
    if on_card:
        import torch
        info["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated())
    if trace is not None:
        info["busy_s"] = trace.busy_s
        info["window_s"] = trace.window_s

    run = Run(cell, config, traffic, setup_s, units, t0, t_end, counters,
              spans, trace)
    values = {}
    for m in metrics:
        v = readers[m["name"]](run)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    passed = run.passed()

    port.free()
    t_ref = time.perf_counter()
    correct, numbers = compare.judge(units, kind, scene, traffic, config,
                                     ref, limits, seed, device)
    checks = {k: {"value": v, "limit": lim} for k, (v, lim) in
              numbers.items() if lim is not None}
    result = {"correct": bool(correct), "attempted": int(passed.size),
              "failed": int(passed.size - passed.sum()), "metrics": values,
              "device": info}
    if trace is not None:
        result["breakdown"] = breakdown(trace)
    result["checks"] = checks
    its = np.concatenate([u.it for u in units]) if units else np.zeros(1)
    cap = config["registration"]["max_num_iterations"]
    notes = {"setup": marks, "counters": counters, "units": len(units),
             "window_s": t_end - t0, "iterations_max": int(its.max()),
             "pairs_at_cap": int((its >= cap).sum()),
             "reference_s": time.perf_counter() - t_ref}
    if trace is not None:
        tags = {"nn_match_affine": "match_affine_kernel",
                "neighborhood_thresholds_batched": "thresholds_kernel"}
        notes["trace"] = {
            "host_window_s": trace.host_window_s,
            "launched_recorded": {
                w: [trace.launched.get(w, 0),
                    sum(n for k, n in trace.recorded.items() if t in k)]
                for w, t in tags.items()}}
    lines = [f"{k} {v!r} (not compared)" for k, (v, lim) in numbers.items()
             if lim is None]
    lines += [f"{k} {c['value']!r} limit {c['limit']!r}"
              for k, c in checks.items()]
    return result, lines, notes


def breakdown(trace) -> dict:
    ops = sorted(trace.kernels.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(trace.idle_by_span.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[name[:120], s] for name, s in ops],
            "idle_gaps": [[name, s] for name, s in idle]}
