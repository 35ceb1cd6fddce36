"""The registration paths as captured device programs: the counterpart of
the JAX package's ``_register_arrays_jit``, ``_compiled_batch``, FGR's
one jitted program and the points route's ``jit(shard_map(...))``.

On the card ``registration.register_arrays`` replays a CUDA graph that
holds the whole registration: the setup (K1-K3 and their glue kernels
G1, G2), every step of the loop (K4, K5 and G3: the solve and the state
update, written in place) and the way back to original coordinates, for
every mode and estimator (nothing in them reads back).  The
loop's ``hist_len`` steps are captured in groups of
``registration._POLL_EVERY``, each group inside a conditional "if" node
(``csrc/graph_cond.cu``) on "some pair is not done": once every pair is
done the remaining groups are skipped on the device, so a call reads
nothing back between its upload and its download, and runs the same
steps as the eager loop, which polls ``done.all()`` after every group.
A device counter of the steps that ran comes back with the results.

The points route (``group``: an NCCL process group, ``parallel/
points.py``) is the same program with the group's all_gathers captured
inside it; every rank holds the same ``done`` (K5 runs replicated), so
every rank's graph takes the same groups.  FGR (``run_fgr``) is one
program of features, the reciprocal match (2 x K6), the tuple test and
the 64 Gauss-Newton steps, its per-pair counts device outputs.

Programs of every kind share one cache, an LRU of ``_CACHE_MAX``
entries keyed by what a capture bakes in: for the registration the
static config (``registration.static_cfg``), mode and variant, dtype,
pairs and the two bucket widths, the setup route, whether there is a
warm start and a history, the device and the points group (the group
itself, its size and this rank); for FGR its config, dtype, pairs,
widths and device.  The registration's float hyperparameters are an
input vector, so a sweep over them shares one entry.  An entry owns its
input buffers (clouds, counts, the float vector, the warm start; FGR's
tuple-test triples) and its outputs.  A call copies its inputs into the
buffers, replays, and clones the outputs, all in stream order: a later
replay cannot overwrite the results of an earlier call.

The entries of one device share one graph memory pool and one pool for
the loop bodies' intermediates.  That is safe because every replay
computes all it reads from its input buffers, and replays are ordered
on the caller's stream, each one's outputs cloned before the next one
runs; so the cache holds about the largest entry's intermediates, not
the sum of all.  ``info()`` gives the pools' bytes and each entry's
growth of them at its capture.

A capture is made with TF32 off (``knn.full_precision``): cuBLAS picks
its kernels then.  Before it, one eager run of the program -- for the
registration the setup and one group of steps -- on the capture's
streams initializes the libraries' handles, workspaces and the NCCL
communicator outside the graph.  A capture that fails raises; nothing
runs eagerly in its place.

The kernels' launch counts (``ops/_build.count_launch``) are additions
on the card captured beside each launch: a replay counts the setup
kernels once and the loop kernels once a step that ran.
"""

from __future__ import annotations

import collections
import time

import torch

from se3_icp_tpu_torch.models import registration as reg
from se3_icp_tpu_torch.ops import _build

FORM = "if-nodes"       # how the loop stops on the device
_CACHE_MAX = 8
_cache: collections.OrderedDict = collections.OrderedDict()
_shared: dict = {}      # device index -> _Shared
totals = {"captures": 0, "capture_seconds": 0.0, "replays": 0}


def info() -> dict:
    """The cache and the captures so far, for reports: the bytes of the
    shared pools, and each entry's key (kind, pairs, widths; for the
    registration mode, variant, setup route and points group size) with
    the bytes its capture added to the pools."""
    entries = [dict(e.desc, pool_bytes_added=e.pool_bytes_added)
               for e in _cache.values()]
    return dict(form=FORM, entries=len(_cache), cache_max=_CACHE_MAX,
                pool_bytes=sum(map(_pool_bytes, _shared)), cached=entries,
                **totals)


def _pool_bytes(index: int) -> int:
    """Bytes that device ``index``'s shared pools hold on the card."""
    sh = _shared[index]
    ids = {tuple(sh.graph_pool), tuple(sh.body_pool.id)}
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if seg["device"] == index
               and tuple(seg["segment_pool_id"]) in ids)


def clear() -> None:
    """Drop every cached program and the pools they share, once the
    replays queued so far have finished."""
    for index in _shared:
        torch.cuda.synchronize(index)
    _cache.clear()
    _shared.clear()


def release_group(group) -> None:
    """Drop the points route's programs of ``group`` (their graphs hold
    its communicator's collectives), once the replays queued so far have
    finished: call it before destroying the group."""
    if group is None:
        return
    for key in [k for k, e in _cache.items() if e.group is group]:
        torch.cuda.synchronize(_cache.pop(key).inputs["src"].device)


class _Shared:
    """What one device's programs share: the capture stream, the loop
    bodies' stream, the graphs' memory pool and the bodies' pool."""

    def __init__(self, dev: torch.device):
        self.cap = torch.cuda.Stream(dev)
        self.body = torch.cuda.Stream(dev)
        self.graph_pool = torch.cuda.graph_pool_handle()
        self.body_pool = torch.cuda.MemPool()


class _IfNode:
    """``with node(pred):`` captures its body into a conditional node
    that runs only when the bool ``pred`` (a 0-dim card tensor) is true
    at that point of the replay.  The body is issued to its own stream,
    which must not be capturing already."""

    def __init__(self, stream: torch.cuda.Stream):
        self.stream = stream
        self.lib = _build.load()

    def __call__(self, pred: torch.Tensor):
        if pred.dtype != torch.bool or pred.dim() != 0:
            raise ValueError("an if node needs a 0-dim bool predicate")
        self.pred = pred
        return self

    def __enter__(self):
        parent = torch.cuda.current_stream(self.stream.device)
        _build.check(self.lib.se3icp_cond_begin(
            parent.cuda_stream, self.stream.cuda_stream,
            self.pred.data_ptr()), "if node")
        self._ctx = torch.cuda.stream(self.stream)
        self._ctx.__enter__()

    def __exit__(self, *exc):
        self._ctx.__exit__(*exc)
        code = self.lib.se3icp_cond_end(self.stream.cuda_stream)
        if exc[0] is None:
            _build.check(code, "if node")
        return False


class _OnStream:
    """The eager stand-in of ``_IfNode`` for the warm-up: the body runs
    unconditionally on the body stream, ordered after and before the
    caller's stream."""

    def __init__(self, stream: torch.cuda.Stream):
        self.stream = stream

    def __call__(self, pred):
        return self

    def __enter__(self):
        self._parent = torch.cuda.current_stream(self.stream.device)
        self.stream.wait_stream(self._parent)
        self._ctx = torch.cuda.stream(self.stream)
        self._ctx.__enter__()

    def __exit__(self, *exc):
        self._ctx.__exit__(*exc)
        self._parent.wait_stream(self.stream)
        return False


def _program(inp: dict, cfg, mode, variant, exact_knn, record_history,
             if_node, groups=None, group=None):
    """The registration on the buffers ``inp``, the loop's groups of
    steps each under ``if_node(pred)``; ``groups`` limits them (the
    warm-up).  ``group``: the points route's process group.  Returns
    (T, it, pure_it, hist | None, steps)."""
    src = inp["src"]
    is_se3 = mode != "icp"
    h = reg.hyper(inp["floats"])
    ms, pre = reg.setup(src, inp["n_src"], inp["tgt"], inp["n_tgt"], cfg,
                        mode, variant, h, exact_knn, group)
    T_init = (reg.warm_start(inp["T0"], pre, src.dtype) if "T0" in inp
              else None)
    state, c = reg.init_loop(ms, pre.scaling, cfg, mode, h, T_init,
                             record_history)
    steps = torch.zeros((), dtype=torch.int32, device=src.device)
    pred = torch.logical_not(state.done.all())
    bufs = state.buffers()
    starts = range(0, c.hist_len, reg._POLL_EVERY)
    for g0 in starts[:groups]:
        n = min(reg._POLL_EVERY, c.hist_len - g0)
        with if_node(pred):
            s = state
            for _ in range(n):
                s = reg.loop_step(s, ms, c)
            for buf, new in zip(bufs, s.buffers()):
                buf.copy_(new)      # no-op where a kernel wrote in place
            steps.add_(n)
            torch.logical_not(s.done.all(), out=pred)
    T = reg.to_original(state.T, pre, is_se3)
    hist = (reg.to_original(state.hist, pre, is_se3) if record_history
            else None)
    return T, state.it, state.pure_it, hist, steps


class _Entry:
    """One captured program and what it owns: its input buffers, its
    ``body(inputs, if_node, groups=None)`` -> outputs, ``desc``, what
    ``info`` reports of it, and the points group its graph's collectives
    run on."""

    def __init__(self, inputs: dict, body, desc: dict, group=None):
        self.inputs, self.body, self.desc = inputs, body, desc
        self.group = group
        self.graph = self.outputs = None
        self.capture_seconds = 0.0
        self.pool_bytes_added = 0


def _capture(entry: _Entry, dev: torch.device) -> None:
    t0 = time.perf_counter()
    _build.load()
    _build.launch_counters(dev)
    if dev.index not in _shared:
        _shared[dev.index] = _Shared(dev)
    sh = _shared[dev.index]
    # warm-up, eagerly, on the streams the capture takes: the libraries'
    # handles and workspaces for them (and a group's communicator) are
    # made here, outside the graph
    cur = torch.cuda.current_stream(dev)
    sh.cap.wait_stream(cur)
    with torch.cuda.stream(sh.cap):
        entry.body(entry.inputs, _OnStream(sh.body), groups=1)
    cur.wait_stream(sh.cap)
    pool_bytes = _pool_bytes(dev.index)
    graph = torch.cuda.CUDAGraph()
    try:
        # the graph's pool takes the capture stream's allocations, the
        # body pool those of the bodies' stream (a thread-wide route
        # consulted after the graph's own)
        with torch.cuda.graph(graph, pool=sh.graph_pool, stream=sh.cap), \
                torch.cuda.use_mem_pool(sh.body_pool, dev):
            outputs = entry.body(entry.inputs, _IfNode(sh.body))
    except Exception as exc:
        raise RuntimeError(
            f"capturing the {entry.desc['kind']} program failed; nothing "
            "ran eagerly in its place") from exc
    entry.graph, entry.outputs = graph, outputs
    entry.pool_bytes_added = _pool_bytes(dev.index) - pool_bytes
    entry.capture_seconds = time.perf_counter() - t0
    totals["captures"] += 1
    totals["capture_seconds"] += entry.capture_seconds


def _replay(key, dev, make, load) -> tuple:
    """Replay (capturing first, on a cache miss) the program of ``key``
    on device ``dev``: ``make()`` gives a new entry, ``load(entry)``
    copies a call's inputs into its buffers in stream order.  Returns
    clones of the outputs, without waiting."""
    entry = _cache.get(key)
    fresh = entry is None
    if fresh:
        entry = make()
    load(entry)
    if fresh:
        _capture(entry, dev)
        _cache[key] = entry
        while len(_cache) > _CACHE_MAX:
            _cache.popitem(last=False)
    else:
        _cache.move_to_end(key)
    entry.graph.replay()
    totals["replays"] += 1
    return tuple(None if t is None else t.clone() for t in entry.outputs)


def _clouds(src, tgt) -> dict:
    """New buffers for a batch's clouds and valid counts."""
    dev = src.device
    return dict(
        src=torch.empty_like(src, memory_format=torch.contiguous_format),
        n_src=torch.empty(src.shape[0], dtype=torch.int32, device=dev),
        tgt=torch.empty_like(tgt, memory_format=torch.contiguous_format),
        n_tgt=torch.empty(tgt.shape[0], dtype=torch.int32, device=dev))


def _load_clouds(inp: dict, src, n_src, tgt, n_tgt) -> None:
    for name, x in (("src", src), ("n_src", n_src), ("tgt", tgt),
                    ("n_tgt", n_tgt)):
        inp[name].copy_(x)


def _key(src, tgt, cfg, mode, variant, exact_knn, initial_T,
         record_history, group):
    """A registration program's key; a points group enters as the group
    itself (held, so no later group takes its identity), its size and
    this rank."""
    gkey = None
    if group is not None:
        import torch.distributed as dist
        gkey = (group, dist.get_world_size(group), dist.get_rank(group))
    return (reg.static_cfg(cfg), mode, variant, src.dtype, src.shape[0],
            src.shape[1], tgt.shape[1], bool(exact_knn),
            initial_T is not None, bool(record_history), src.device, gkey)


def run(src, n_src, tgt, n_tgt, cfg, mode: str, variant: str, *,
        exact_knn: bool = False, initial_T=None,
        record_history: bool = False, stats: dict | None = None,
        group=None) -> reg.Dispatched:
    """Replay (capturing first, on a cache miss) the program of this
    batch's key on the batch's card tensors; returns without waiting.
    ``group``: the points route over that NCCL group (every rank calls
    this with the same arguments)."""
    from se3_icp_tpu_torch.ops import knn
    dev = src.device
    floats = torch.tensor(reg.traced_values(cfg),
                          dtype=src.dtype).pin_memory()
    scfg = reg.static_cfg(cfg)
    key = _key(src, tgt, cfg, mode, variant, exact_knn, initial_T,
               record_history, group)

    def make():
        inputs = _clouds(src, tgt)
        inputs["floats"] = torch.empty(len(reg._TRACED_FIELDS),
                                       dtype=src.dtype, device=dev)
        if initial_T is not None:
            inputs["T0"] = torch.empty((src.shape[0], 4, 4),
                                       dtype=src.dtype, device=dev)

        def body(inp, if_node, groups=None):
            return _program(inp, scfg, mode, variant, exact_knn,
                            record_history, if_node, groups, group)
        desc = dict(kind="registration", pairs=src.shape[0],
                    source_width=src.shape[1], target_width=tgt.shape[1],
                    mode=mode, variant=variant, exact_knn=bool(exact_knn),
                    points_group=None if key[-1] is None else key[-1][1])
        return _Entry(inputs, body, desc, group)

    def load(entry):
        inp = entry.inputs
        _load_clouds(inp, src, n_src, tgt, n_tgt)
        inp["floats"].copy_(floats, non_blocking=True)
        if initial_T is not None:
            inp["T0"].copy_(initial_T)

    with torch.no_grad(), knn.full_precision(), torch.cuda.device(dev):
        T, it, pure_it, hist, steps = _replay(key, dev, make, load)
    out = (T, it, pure_it) + ((hist,) if record_history else ())
    return reg.Dispatched(out, steps, stats)


def run_fgr(src, n_src, tgt, n_tgt, cfg, raw=None,
            stats: dict | None = None) -> reg.Dispatched:
    """FGR (``fgr.fgr_register_arrays``) of a batch of padded pairs on
    the card, as one replayed program; returns without waiting.  The
    entry's triples buffer holds ``fgr.raw_triples(cfg)``, filled once
    at its creation; a caller's own ``raw`` is copied into it for that
    call (and the default back for the next call without one).
    ``stats`` gets ``reciprocal`` and ``kept_correspondences`` per pair,
    read back with the results."""
    from se3_icp_tpu_torch.models import fgr
    from se3_icp_tpu_torch.ops import knn
    dev = src.device
    key = ("fgr", cfg, src.dtype, src.shape[0], src.shape[1], tgt.shape[1],
           dev)

    def make():
        inputs = _clouds(src, tgt)
        entry = _Entry(inputs, lambda inp, if_node, groups=None:
                       fgr.program_body(inp, cfg),
                       dict(kind="FGR", pairs=src.shape[0],
                            source_width=src.shape[1],
                            target_width=tgt.shape[1]))
        if cfg.tuple_test:
            entry.raw_default = fgr.raw_triples(cfg, dev)
            inputs["raw"] = entry.raw_default.clone()
            entry.raw_is_default = True
        return entry

    def load(entry):
        inp = entry.inputs
        _load_clouds(inp, src, n_src, tgt, n_tgt)
        if cfg.tuple_test and (raw is not None or not entry.raw_is_default):
            inp["raw"].copy_(entry.raw_default if raw is None else raw)
            entry.raw_is_default = raw is None

    with torch.no_grad(), knn.full_precision(), torch.cuda.device(dev):
        T, it, pure, recip, kept = _replay(key, dev, make, load)
    return reg.Dispatched((T, it, pure), stats=stats,
                          per_pair=dict(reciprocal=recip,
                                        kept_correspondences=kept))
