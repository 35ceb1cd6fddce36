"""Batched registration of independent frame pairs, on one device or
sharded over several.

The serving surface: a list of (source, target) numpy clouds is packed
into padded batch arrays, uploaded, registered by the natively batched
engine (every pair iterates until the whole batch converged; per-pair
``done`` masking keeps finished pairs idle and results exact), and
downloaded with one transfer.

On the card the engine is one captured program
(``models/program.py``) that reads nothing back before its results, so
``register_pairs_async`` returns as soon as the batch is dispatched and
a serving loop packs and uploads batch N+1 while the card still runs
batch N; ``PendingBatch.result()`` waits for one batch and fetches it
in one transfer.  Each side of a batch is uploaded max-padded from a
pinned staging buffer and padded to the 512-point bucket on the card
(``_pad_to_bucket``), and its upload is memoised by the identity of the
caller's arrays (``_device_clouds``).

``algorithm="fgr"`` runs Fast Global Registration (``models/fgr.py``)
on the same batch contract; on the card it too is one captured program
(``program.run_fgr``), its per-pair counts fetched with the results.

A pairs mesh (``default_mesh``: a tuple of devices, every visible card
by default) shards the pair axis with no communication, the JAX
package's ``shard_map`` over a ``pairs`` axis: a pair count that does
not divide the mesh is padded by repeating the last pair, the pairs are
split into ``len(mesh)`` contiguous shards of one width, each shard is
dispatched on its device (the captured program is keyed by device, so
several cards run at once), and the results are gathered in pair order
with the padding cut off.  A mesh may name one device more than once:
its shards then run one after another there.  On the card
``register_pairs(_async)`` defaults to every card when there is more
than one.  ``setup_checksum_batch`` is the sharding oracle: a per-pair
checksum of the setup under the same shard layout, equal to the
unsharded one bit for bit.  Processes on several hosts:
``parallel/multihost.py``; one registration's points over a process
group: ``parallel/points.py``.
"""

from __future__ import annotations

import collections
import os
import weakref

import numpy as np
import torch
import torch.nn.functional as F

from se3_icp_tpu_torch.models import registration as reg
from se3_icp_tpu_torch.utils.config import parse_algorithm


def default_mesh(devices=None) -> tuple:
    """A pairs mesh: the tuple of ``devices`` (as ``torch.device``s; a
    device may appear more than once), every visible CUDA device by
    default."""
    if devices is None:
        reg.resolve_device("cuda")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    mesh = tuple(torch.device(d) for d in devices)
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    return mesh


def _auto_mesh(mesh, device):
    """The mesh a call runs on: ``mesh=False`` forces one device (None);
    ``mesh=None`` on the generic card, with more than one visible, is
    every card (as the JAX package shards over all its devices);
    otherwise the given mesh, normalised."""
    if mesh is False:
        return None
    if mesh is None:
        dev = torch.device(device)
        if (dev.type == "cuda" and dev.index is None
                and torch.cuda.is_available()
                and torch.cuda.device_count() > 1):
            return default_mesh()
        return None
    return default_mesh(mesh)


def _mesh_shards(p: int, mesh) -> tuple:
    """(pairs after repeat-padding, pairs a shard) of p pairs over
    ``mesh``."""
    p_pad = -(-p // len(mesh)) * len(mesh)
    return p_pad, p_pad // len(mesh)


def _repeat_last(x, pad: int):
    """``x`` with its last entry along the pair axis repeated ``pad``
    more times."""
    if x is None or not pad:
        return x
    return torch.cat([x, x[-1:].expand(pad, *x.shape[1:])], 0)


def _mesh_split(mesh, *xs):
    """Yield (device, [each x's shard, copied there], real pairs in it)
    for the shards of ``xs`` (tensors along the pair axis, or None) over
    ``mesh``, the pair axis repeat-padded until it divides."""
    p = xs[0].shape[0]
    p_pad, c = _mesh_shards(p, mesh)
    xs = [_repeat_last(x, p_pad - p) for x in xs]
    for i, dev in enumerate(mesh):
        dev = reg.resolve_device(dev)
        yield dev, [None if x is None else
                    x[i * c:(i + 1) * c].to(dev, non_blocking=True)
                    for x in xs], max(0, min(c, p - i * c))


def _pad_to_bucket(x: torch.Tensor) -> torch.Tensor:
    """Pad [P,N,3] clouds to the 512-point bucket of N on their device
    (zero rows): uploads carry only the batch's largest count
    (``pack_clouds(pad="max")``).  A no-op for aligned inputs."""
    b = reg._bucket(x.shape[1])
    if b == x.shape[1]:
        return x
    return F.pad(x, (0, 0, 0, b - x.shape[1]))


def _dispatch_batch(src, n_src, tgt, n_tgt, cfg, algorithm: str,
                    initial_T=None, device="cuda",
                    stats: dict | None = None,
                    exact_knn: bool = False) -> reg.Dispatched:
    """``register_batch`` without waiting for the card."""
    if initial_T is not None and algorithm == "fgr":
        raise ValueError("initial_T is not supported for fgr (a global "
                         "method: it estimates from scratch by design)")
    dev = reg.resolve_device(device)
    for name, x in (("src", src), ("n_src", n_src), ("tgt", tgt),
                    ("n_tgt", n_tgt), ("initial_T", initial_T)):
        if x is not None and (x.device.type != dev.type or (
                dev.index is not None and x.device.index != dev.index)):
            raise ValueError(
                f"register_batch runs on device '{dev}' but {name} lies on "
                f"'{x.device}'; move the tensors there, or pass "
                "device='cpu' to run the plain versions on the CPU")
    src, tgt = _pad_to_bucket(src), _pad_to_bucket(tgt)
    if algorithm == "fgr":
        from se3_icp_tpu_torch.models import fgr
        fcfg = cfg if isinstance(cfg, fgr.FGRConfig) else fgr.FGRConfig()
        return fgr.dispatch_arrays(src, n_src, tgt, n_tgt, fcfg,
                                   stats=stats)
    mode, variant = parse_algorithm(algorithm)
    return reg.dispatch_arrays(src, n_src, tgt, n_tgt, cfg, mode, variant,
                               initial_T=initial_T, stats=stats,
                               exact_knn=exact_knn)


def _dispatch_mesh(src, n_src, tgt, n_tgt, cfg, algorithm: str, mesh,
                   initial_T=None, stats: dict | None = None,
                   exact_knn: bool = False) -> list:
    """``_dispatch_batch`` over a mesh: [(Dispatched, pairs, stats)] a
    shard, in pair order, the repeat-padding counted out."""
    for name, x in (("src", src), ("n_src", n_src), ("tgt", tgt),
                    ("n_tgt", n_tgt), ("initial_T", initial_T)):
        if x is not None and x.device != src.device:
            raise ValueError(f"{name} lies on '{x.device}', src on "
                             f"'{src.device}'")
    out = []
    for dev, shard, n in _mesh_split(mesh, src, n_src, tgt, n_tgt,
                                     initial_T):
        sub = None if stats is None else {}
        d = _dispatch_batch(*shard[:4], cfg, algorithm, shard[4], dev,
                            sub, exact_knn)
        out.append((d, n, sub))
    return out


def _merge_stats(stats: dict | None, shards) -> None:
    """Add the settled shards' stats to ``stats``: counts summed,
    per-pair lists (FGR's) joined in pair order without the padding."""
    if stats is None:
        return
    for _, n, sub in shards:
        for key, val in sub.items():
            if isinstance(val, list):
                stats[key] = stats.get(key, []) + val[:n]
            else:
                stats[key] = stats.get(key, 0) + val


def _gather_shards(shards, device, stats) -> tuple:
    """The shards' settled results on ``device``, in pair order, with
    the padding cut off; their stats added to ``stats``."""
    parts = [tuple(x[:n].to(device) for x in d.settle())
             for d, n, _ in shards]
    _merge_stats(stats, shards)
    return tuple(torch.cat(xs, 0) for xs in zip(*parts))


def register_batch(src, n_src, tgt, n_tgt, cfg, algorithm: str,
                   initial_T=None, device="cuda",
                   stats: dict | None = None, exact_knn: bool = False,
                   mesh=None):
    """Register a batch of padded pairs held in tensors.

    src [P,Ns,3], n_src [P], tgt [P,Nt,3], n_tgt [P], all on ``device``:
    the card unless the caller passes ``device='cpu'``.  Tensors that lie
    elsewhere raise (nothing is moved, and nothing runs on the CPU unasked).
    Ns and Nt need not be bucket widths: the clouds are padded to the
    512-point bucket on their device.
    ``cfg``: a ``RegistrationConfig``; for ``algorithm='fgr'`` an
    ``FGRConfig``, any other config giving the default ``FGRConfig``.
    ``initial_T`` [P,4,4] optionally warm-starts each pair (original
    coordinates; not for fgr).  ``exact_knn``: the exact sorted-kNN setup
    instead of the sort-free threshold route (ICP algorithms).  Returns
    (T [P,4,4], iters [P], pure_iters [P]) as tensors on that device.

    ``mesh``: a pairs mesh (``default_mesh``, or any sequence of
    devices): the pair axis is split over it (see the module docstring),
    each shard copied to its device, and the results are gathered on the
    inputs' device (``device`` is then not read).
    """
    if mesh is None:
        return _dispatch_batch(src, n_src, tgt, n_tgt, cfg, algorithm,
                               initial_T, device, stats,
                               exact_knn).settle()
    shards = _dispatch_mesh(src, n_src, tgt, n_tgt, cfg, algorithm,
                            default_mesh(mesh), initial_T, stats, exact_knn)
    return _gather_shards(shards, src.device, stats)


def setup_checksum_batch(src, n_src, tgt, n_tgt, cfg, algorithm: str,
                         mesh=None, device="cuda",
                         exact_knn: bool = False) -> torch.Tensor:
    """The sharding oracle: run the engine's setup (everything before
    the loop, ``registration.setup``) over the same shard layout as
    ``register_batch`` and return a [P] per-pair checksum of the
    pre-loop tensors (``registration.setup_checksum``) on the inputs'
    device.  The sharded checksum must equal the unsharded one bit for
    bit.  Tensors as ``register_batch`` takes them; ``mesh=None`` runs
    the batch whole on ``device``."""
    from se3_icp_tpu_torch.ops import knn
    mode, variant = parse_algorithm(algorithm)

    def one(s, ns, t, nt, dev):
        with torch.no_grad(), knn.full_precision():
            floats, scfg = reg.split_cfg(cfg, s.dtype, dev)
            h = reg.hyper(floats)
            ms, _ = reg.setup(_pad_to_bucket(s), ns, _pad_to_bucket(t), nt,
                              scfg, mode, variant, h, exact_knn)
            return reg.setup_checksum(ms, h)

    if mesh is None:
        dev = reg.resolve_device(device)
        return one(src, n_src, tgt, n_tgt, dev)
    return torch.cat([one(*shard, dev)[:n].to(src.device)
                      for dev, shard, n in _mesh_split(
                          default_mesh(mesh), src, n_src, tgt, n_tgt)])


def pack_clouds(clouds, dtype=np.float32, bucket: int = 512,
                pad: str = "bucket", out: np.ndarray | None = None):
    """Host-side packing of one cloud list -> ([P,N,3], counts [P]).

    Non-finite points are dropped (as ``registration.sanitize_cloud``).
    ``pad``: 'bucket' pads N to the 512-point bucket of the largest
    cloud (device-ready); 'max' pads only to the largest cloud's point
    count, non-finite rows included -- the engine pads to the bucket on
    the card (``_pad_to_bucket``), keeping the pad bytes off the host
    link.  ``out``: an optional zeroed [P,N,3] array of ``dtype`` to pack
    into (a pinned staging buffer).

    One pass over all clouds at once: concatenated (and cast) once, one
    ``isfinite`` mask, counts from the mask, and the kept rows scattered
    as 3-float records into the slots ``row < count`` of each cloud
    (row-major, so in order).  Rows are tested in the input's float
    type: float32 and float64 input is cast to ``dtype`` once, other
    input through float64, as a cloud-by-cloud float64 pass would.
    """
    arrs = [np.asarray(c).reshape(-1, 3) for c in clouds]
    lens = np.array([len(a) for a in arrs], np.int64)
    n_max = int(lens.max(initial=0))
    width = n_max if pad == "max" else reg._bucket(n_max, bucket)
    p = len(arrs)
    if out is None:
        out = np.zeros((p, width, 3), dtype)
    counts = np.zeros(p, np.int32)
    if not p:
        return out, counts
    if all(a.dtype in (np.float32, np.float64) for a in arrs):
        with np.errstate(over="ignore"):    # overflowed rows: see below
            rows = np.concatenate(arrs, dtype=dtype, casting="unsafe")
        exact = all(np.can_cast(a.dtype, dtype) for a in arrs)
    else:
        rows = np.concatenate(arrs).astype(np.float64).astype(dtype)
        exact = False
    fin = np.isfinite(rows)
    if fin.all():
        counts[:] = lens
    else:
        keep = fin[:, 0] & fin[:, 1] & fin[:, 2]
        if not exact:
            # a row that the cast overflowed was finite before it
            cand = np.flatnonzero(~keep)
            keep[cand] = np.isfinite(np.concatenate(arrs)[cand].astype(
                np.float64)).all(axis=1)
        # the cloud of each dropped row, by its offset in the concatenation
        cloud = np.searchsorted(np.cumsum(lens), np.flatnonzero(~keep),
                                side="right")
        counts[:] = lens - np.bincount(cloud, minlength=p)
        rows = _records(rows)[keep].view(rows.dtype).reshape(-1, 3)
    slots = np.arange(out.shape[1]) < counts[:, None]
    _records(out).reshape(slots.shape)[slots] = _records(rows)
    return out, counts


def _records(a: np.ndarray) -> np.ndarray:
    """A C-contiguous [..., 3] array as a flat array of 3-float records
    (one element a row, for fast row masks)."""
    return a.view(np.dtype((np.void, 3 * a.itemsize))).reshape(-1)


def pack_pairs(pairs, dtype=np.float32, bucket: int = 512,
               pad: str = "bucket"):
    """Host-side packing: list of (src_pts, tgt_pts) -> padded batch
    arrays (src [P,Ns,3], n_src [P], tgt [P,Nt,3], n_tgt [P])."""
    src, n_src = pack_clouds([s for s, _ in pairs], dtype, bucket, pad)
    tgt, n_tgt = pack_clouds([t for _, t in pairs], dtype, bucket, pad)
    return src, n_src, tgt, n_tgt


# --- device-resident cloud-batch cache --------------------------------
#
# Serving repeats clouds across calls: scan-to-model registration
# reuses one target for every source, sequence odometry reuses each
# scan as the source of one pair and the target of the next.  So the
# upload of each cloud-batch SIDE is memoised, keyed by the identity of
# the caller's arrays plus a sampled-value fingerprint, and a side whose
# arrays are unchanged is not packed or uploaded again.  An entry goes
# when any of its arrays is garbage collected (weakrefs).  Clouds passed
# to register_pairs are treated as immutable; SE3_ICP_TPU_NO_CLOUD_CACHE=1
# turns the memo off.

_CLOUD_CACHE_MAX = 8
_cloud_cache: collections.OrderedDict = collections.OrderedDict()
cloud_cache_counts = {"hits": 0, "uploads": 0}


def _cloud_cache_key(clouds, dtype, device, width=None):
    if os.environ.get("SE3_ICP_TPU_NO_CLOUD_CACHE"):
        return None
    parts = []
    for a in clouds:
        if not (isinstance(a, np.ndarray) and a.size >= 3):
            return None
        f = a.reshape(-1)
        parts.append((id(a), a.shape, a.dtype.str, float(f[0]),
                      float(f[f.size // 2]), float(f[-1])))
    return (np.dtype(dtype).str, str(device), width, tuple(parts))


def _device_clouds(clouds, dtype, device, width: int | None = None):
    """Upload one side of a pair batch, memoised (see above).  Returns
    (dev [P,N,3], counts [P] int32) on ``device`` with N the batch's
    largest point count, or ``width`` if given (the shards of a mesh take
    the whole batch's; the bucket padding happens on the card).  On
    the card the side is packed into a pinned staging buffer and copied
    with ``non_blocking``; the pinned block is not handed out again
    before that copy has finished (torch's pinned-memory cache records
    an event on the copy's stream)."""
    dev = torch.device(device)
    key = _cloud_cache_key(clouds, dtype, dev, width)
    if key is not None:
        hit = _cloud_cache.get(key)
        if hit is not None:
            refs, pts, counts = hit
            if all(r() is not None for r in refs):
                _cloud_cache.move_to_end(key)
                cloud_cache_counts["hits"] += 1
                return pts, counts
            del _cloud_cache[key]
    n_max = max((int(np.asarray(c).size) // 3 for c in clouds), default=0)
    if width is not None:
        n_max = max(n_max, width)
    pin = dev.type == "cuda"
    stage = torch.zeros((len(clouds), n_max, 3), dtype=_torch_dtype(dtype),
                        pin_memory=pin)
    _, counts = pack_clouds(clouds, dtype, pad="max", out=stage.numpy())
    cnt = torch.from_numpy(counts)
    if pin:
        cnt = cnt.pin_memory()
    pts = stage.to(dev, non_blocking=True)
    counts = cnt.to(dev, non_blocking=True)
    cloud_cache_counts["uploads"] += 1
    if key is not None:
        _cloud_cache[key] = ([weakref.ref(a) for a in clouds], pts, counts)
        while len(_cloud_cache) > _CLOUD_CACHE_MAX:
            _cloud_cache.popitem(last=False)
    return pts, counts


def _torch_dtype(dtype) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, dtype)).dtype


class PendingBatch:
    """A dispatched batch registration.

    Holds the batch's results on the device; ``result()`` waits for the
    card with ONE device-to-host fetch of the transforms, iteration
    counts and the loop's step count (FGR: its per-pair counts), and
    builds the RegistrationResult list.  A serving loop packs and
    dispatches batch N+1 while the card still runs batch N (its queue
    runs in order), hiding host packing and the upload behind compute --
    see
    ``examples/streaming_registration.py`` of the JAX package, whose
    ``PendingBatch`` this is.  Over a mesh it holds each shard's
    results and fetches them one transfer a shard.
    """

    def __init__(self, dispatched, n_pairs: int,
                 stats: dict | None = None):
        # one Dispatched, or [(Dispatched, pairs, stats)] of a mesh's
        # shards, whose stats go to ``stats`` once all are settled
        self._shards = (dispatched if isinstance(dispatched, list)
                        else [(dispatched, n_pairs, None)])
        self._stats = stats
        self._results = None

    def result(self) -> list:
        if self._results is None:
            self._results = []
            for d, n, _ in self._shards:
                T, it, pure = d.out[:3]
                cols = [T.flatten(1).double(), it[:, None].double(),
                        pure[:, None].double()]
                if d.steps is not None:
                    cols.append(d.steps.double().expand(T.shape[0], 1))
                cols += [v[:, None].double() for v in d.per_pair.values()]
                flat = torch.cat(cols, dim=1).cpu().numpy()  # one fetch
                extra = flat[:, 18:].T.astype(np.int64).tolist()
                steps = extra.pop(0)[0] if d.steps is not None else None
                d.settle(steps, dict(zip(d.per_pair, extra)))
                self._results += [
                    reg.RegistrationResult(row[:16].reshape(4, 4).copy(),
                                           int(row[16]), int(row[17]))
                    for row in flat[:n]]
            if self._shards[0][2] is not None:
                _merge_stats(self._stats, self._shards)
        return self._results


def _upload_transforms(Ts, dtype, dev):
    t0 = torch.as_tensor(np.asarray(Ts, dtype))
    return (t0.pin_memory() if dev.type == "cuda" else t0).to(
        dev, non_blocking=True)


def register_pairs_async(pairs, algorithm: str, cfg, dtype=np.float32,
                         initial_Ts=None, device="cuda",
                         stats: dict | None = None,
                         exact_knn: bool = False,
                         mesh=None) -> PendingBatch:
    """Pack, upload and dispatch a batch without waiting for its
    results; ``.result()`` of the returned ``PendingBatch`` gives what
    ``register_pairs`` returns.  Arguments as ``register_pairs``; with
    ``device='cpu'`` the batch runs synchronously on the plain path.
    ``stats`` is complete once ``result()`` has returned.  Over a mesh
    each shard's sides are uploaded to its device at the whole batch's
    width and dispatched there."""
    mesh = _auto_mesh(mesh, device)
    if mesh is None:
        dev = reg.resolve_device(device)
        src, n_src = _device_clouds([s for s, _ in pairs], dtype, dev)
        tgt, n_tgt = _device_clouds([t for _, t in pairs], dtype, dev)
        t0 = (None if initial_Ts is None
              else _upload_transforms(initial_Ts, dtype, dev))
        d = _dispatch_batch(src, n_src, tgt, n_tgt, cfg, algorithm,
                            initial_T=t0, device=dev, stats=stats,
                            exact_knn=exact_knn)
        return PendingBatch(d, len(pairs))
    p = len(pairs)
    p_pad, c = _mesh_shards(p, mesh)
    padded = list(pairs) + [pairs[-1]] * (p_pad - p)
    Ts = None
    if initial_Ts is not None:
        Ts = list(np.asarray(initial_Ts))
        Ts += [Ts[-1]] * (p_pad - p)
    ws = max(int(np.asarray(s).size) // 3 for s, _ in pairs)
    wt = max(int(np.asarray(t).size) // 3 for _, t in pairs)
    shards = []
    for i, dev in enumerate(mesh):
        dev = reg.resolve_device(dev)
        part = padded[i * c:(i + 1) * c]
        src, n_src = _device_clouds([s for s, _ in part], dtype, dev, ws)
        tgt, n_tgt = _device_clouds([t for _, t in part], dtype, dev, wt)
        t0 = (None if Ts is None
              else _upload_transforms(Ts[i * c:(i + 1) * c], dtype, dev))
        sub = None if stats is None else {}
        d = _dispatch_batch(src, n_src, tgt, n_tgt, cfg, algorithm,
                            initial_T=t0, device=dev, stats=sub,
                            exact_knn=exact_knn)
        shards.append((d, max(0, min(c, p - i * c)), sub))
    return PendingBatch(shards, p, stats)


def register_pairs(pairs, algorithm: str, cfg, dtype=np.float32,
                   initial_Ts=None, device="cuda",
                   stats: dict | None = None, exact_knn: bool = False,
                   mesh=None):
    """High-level: list of (src, tgt) numpy clouds -> list of
    ``RegistrationResult``.  Runs on the card unless ``device='cpu'``.
    ``algorithm='fgr'`` takes an ``FGRConfig`` (or any other config for
    the default one), as ``register_batch``.

    ``initial_Ts``: optional [P,4,4] (or list of [4,4]) warm starts.
    ``stats``: optional dict that receives ``loop_steps`` and
    ``host_syncs`` of the call (for fgr: ``reciprocal`` and
    ``kept_correspondences`` per pair).  ``exact_knn``: the exact
    sorted-kNN setup instead of the threshold route.  ``mesh``: a pairs
    mesh to shard the batch over (``default_mesh``; ``device`` is then
    not read); by default every card when there is more than one, and
    ``mesh=False`` keeps the batch on ``device``."""
    return register_pairs_async(pairs, algorithm, cfg, dtype, initial_Ts,
                                device, stats, exact_knn, mesh).result()
