#!/usr/bin/env python3
"""Wall time of the eager route on the card (``se3_pt2pt``, whose loop
stays eager), this checkout against an older one, in one process and
in alternating turns.

    python3 tools/eager_timing.py --parent DIR [--rounds 12] [--out F]

Both checkouts' ``se3_icp_tpu_torch`` are imported side by side: each
call runs with its own checkout's modules installed in ``sys.modules``
(imports made inside functions then find the right ones).  The batch
is ``chip_smoke.py``'s: 8 golden-shape pairs, ``se3_pt2pt``, ``GOLDEN``.
Each round times, in an order that turns around every round:

  parent          the older checkout;
  change_cached   this checkout right after the main path's call (64 x
                  4608, ``se3_pt2pl``, a replay of its captured
                  program), as after ``chip_smoke.py``'s main path;
  change_floats   the same, the hyperparameters as Python floats in
                  place of the card vector (the same bits);
  change_cleared  this checkout with its program cache and pools
                  dropped and ``torch.cuda.empty_cache()``: the first
                  call after them;
  parent_after_cf, change_after_cf
                  each checkout right after its own 8-pair
                  ``se3_gicp_with_cf`` batch (``LOUNGE``, noisy pairs;
                  a graph replay in this checkout, eager in the older
                  one), the order ``tools/path_digest.py`` times them
                  in;
  parent_digest_order, change_digest_order
                  each checkout right after a whole turn of
                  ``tools/path_digest.py`` up to ``se3_pt2pt`` (untimed):
                  its 8-pair ``pt2pl`` batch, FGR on the 64 main-path
                  pairs, the main path on the same arrays and on fresh
                  copies, the multistart fleet, the ``se3_gicp`` and
                  ``se3_gicp_with_cf`` batches.

What runs before a timed call is untimed; where it captured a program
(a capture empties torch's block cache), an untimed call and that work
again follow, so only ``change_cleared`` times a call on an emptied
cache.  Each condition is timed twice a round: ``register_pairs`` on the numpy
clouds (packing and upload included) and ``register_arrays`` on the
clouds already on the card; the host clock around a call that ends in
a synchronize.  Prints (and writes to ``--out``) one JSON object with
each condition's median and quartiles and every round's times.  Needs
a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "se3_icp_tpu_torch"


def _ours(name: str) -> bool:
    return name == PKG or name.startswith(PKG + ".")


class Checkout:
    """One checkout's ``se3_icp_tpu_torch`` modules, installed in
    ``sys.modules`` only inside ``with self.active():``."""

    def __init__(self, root: str):
        self.modules: dict = {}
        sys.path.insert(0, os.path.abspath(root))
        try:
            with self.active():
                for mod in ("parallel.pairs", "models.registration",
                            "models.fgr", "models.multistart",
                            "datasets.fixtures", "utils.config"):
                    __import__(f"{PKG}.{mod}")
        finally:
            sys.path.pop(0)
        self.pairs = self.modules[f"{PKG}.parallel.pairs"]
        self.reg = self.modules[f"{PKG}.models.registration"]
        self.fixtures = self.modules[f"{PKG}.datasets.fixtures"]
        self.fgr = self.modules[f"{PKG}.models.fgr"]
        self.multistart = self.modules[f"{PKG}.models.multistart"]
        self.GOLDEN = self.modules[f"{PKG}.utils.config"].GOLDEN
        self.LOUNGE = self.modules[f"{PKG}.utils.config"].LOUNGE

    @contextlib.contextmanager
    def active(self):
        saved = {k: sys.modules.pop(k) for k in list(sys.modules)
                 if _ours(k)}
        sys.modules.update(self.modules)
        try:
            yield
        finally:
            self.modules = {k: sys.modules.pop(k) for k in list(sys.modules)
                            if _ours(k)}
            sys.modules.update(saved)


@contextlib.contextmanager
def python_floats(reg):
    """The eager route with the hyperparameters as Python floats."""
    orig = reg.hyper
    reg.hyper = lambda floats: reg.Hyper(*floats.tolist())
    try:
        yield
    finally:
        reg.hyper = orig


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    ap.add_argument("--rounds", type=int, default=12)
    ap.add_argument("--out")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("eager_timing: no CUDA device")

    parent, change = Checkout(args.parent), Checkout(HERE)
    with change.active():
        from se3_icp_tpu_torch.models import program
    probs = [change.fixtures.golden_shape_problem(seed=s)
             for s in range(1, 9)]
    plist = [(p.source, p.target) for p in probs]
    arrs = [torch.as_tensor(a, device="cuda")
            for a in change.pairs.pack_pairs(plist)]
    main_list = [(p.source, p.target) for p in
                 (change.fixtures.golden_shape_problem(seed=s)
                  for s in range(1, 65))]
    cf_list = [(p.source, p.target) for p in
               (change.fixtures.golden_shape_problem(
                   seed=s, **change.fixtures.NOISY) for s in range(1, 9))]

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def pt2pt(co):
        return co.pairs.register_pairs(plist, "se3_pt2pt", co.GOLDEN)

    def settled(prep):
        """``prep``, and, where it captured a program (a capture empties
        torch's block cache), an untimed call and ``prep`` again."""
        def run():
            captures = program.totals["captures"]
            prep()
            if program.totals["captures"] != captures:
                with change.active():
                    pt2pt(change)
                prep()
            torch.cuda.synchronize()
        return run

    def cache_main_path():
        with change.active():
            change.pairs.register_pairs(main_list, "se3_pt2pl",
                                        change.GOLDEN)

    def clear():
        program.clear()
        torch.cuda.empty_cache()

    def after_cf(co):
        def prep():
            with co.active():
                co.pairs.register_pairs(cf_list, "se3_gicp_with_cf",
                                        co.LOUNGE)
        return prep

    def batch(kw):
        return [(p.source, p.target) for p in
                (change.fixtures.golden_shape_problem(seed=s, **kw)
                 for s in range(1, 9))]
    flip_list = batch(change.fixtures.FLIPPED_POSE)
    gicp_list = batch({})
    pt2pl_list = batch(change.fixtures.SMALL_POSE)

    def digest_order(co):
        def prep():
            with co.active():
                G = co.GOLDEN
                co.pairs.register_pairs(pt2pl_list, "pt2pl", G)
                co.pairs.register_pairs(main_list, "fgr",
                                        co.fgr.FGRConfig())
                co.pairs.register_pairs(main_list, "se3_pt2pl", G)
                co.pairs.register_pairs(
                    [(s.copy(), t.copy()) for s, t in main_list],
                    "se3_pt2pl", G)
                co.multistart.register_pairs_multistart(
                    flip_list, "se3_pt2pl", G, n_starts=8, pair_chunk=8)
                co.pairs.register_pairs(gicp_list, "se3_gicp", G)
                co.pairs.register_pairs(cf_list, "se3_gicp_with_cf",
                                        co.LOUNGE)
        return prep

    def conditions():
        out = {}
        for name, co, prep, ctx in (
                ("parent", parent, None, contextlib.nullcontext),
                ("change_cached", change, settled(cache_main_path),
                 contextlib.nullcontext),
                ("change_floats", change, settled(cache_main_path),
                 lambda: python_floats(change.reg)),
                ("change_cleared", change, clear, contextlib.nullcontext),
                ("parent_after_cf", parent, settled(after_cf(parent)),
                 contextlib.nullcontext),
                ("change_after_cf", change, settled(after_cf(change)),
                 contextlib.nullcontext),
                ("parent_digest_order", parent,
                 settled(digest_order(parent)), contextlib.nullcontext),
                ("change_digest_order", change,
                 settled(digest_order(change)), contextlib.nullcontext)):
            def run(co=co, prep=prep, ctx=ctx):
                if prep is not None:
                    prep()
                with co.active(), ctx():
                    pairs_s = timed(lambda: pt2pt(co))
                    arrays_s = timed(lambda: co.reg.register_arrays(
                        *arrs, co.GOLDEN, "se3", "pt2pt"))
                return pairs_s, arrays_s
            out[name] = run
        return out

    conds = conditions()
    for run in conds.values():          # builds, handles, first calls
        run()
    names = list(conds)
    rounds = []
    for r in range(args.rounds):
        order = names if r % 2 == 0 else names[::-1]
        rounds.append({n: conds[n]() for n in order})

    def summary(vals):
        q = statistics.quantiles(vals, n=4)
        return dict(median=statistics.median(vals), q1=q[0], q3=q[2])

    report = dict(
        batch="8 pairs x 4167 points, se3_pt2pt, GOLDEN",
        device=torch.cuda.get_device_name(0), rounds=args.rounds,
        register_pairs_seconds={n: summary([r[n][0] for r in rounds])
                                for n in names},
        register_arrays_seconds={n: summary([r[n][1] for r in rounds])
                                 for n in names},
        every_round=rounds)
    line = json.dumps(report)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
