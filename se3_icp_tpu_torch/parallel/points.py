"""Model-parallel registration: shard ONE registration's points over a
``torch.distributed`` process group.

Port of the JAX package's ``parallel/points.py``.  The reference's only
parallelism is OpenMP worksharing over per-point loops inside one
process; here the row-wise work of a registration is split over the
ranks of a process group (the ``points`` axis) while both clouds stay
replicated on every rank:

  * setup: each rank runs the neighbourhood kernels on its contiguous
    row slice of each cloud against the whole cloud -- K1's thresholds,
    K2's moments and K3's TOLDI axis sums on the default route, the
    sorted kNN and the dense reductions on the exact route -- and the
    small per-point products (frames, normals, covariances) are
    all-gathered back to full rows;
  * every step runs the match kernel K4 on the rank's rows of the query
    features and all-gathers the matched payload rows;
  * the loop's epilogue K5, the solve and the pose update run
    replicated on the full rows, so every rank holds the same state
    bits and takes the same stop decision (``models/registration.py``
    says why K5 is not sharded, unlike the JAX package's route).

Every rank calls the entry points with the same arguments; the padded
widths must divide by the group's size.  Tensors on the card need an
NCCL group and CPU tensors a gloo group: nothing falls back.  On an
NCCL group the route replays a captured program (``models/program.py``)
with its all_gathers inside the graph, as the JAX package runs it as one
``jit(shard_map(...))``; on a gloo group it runs the eager polled loop.
It is for clouds too large for one card; many small pairs shard better
over a pairs mesh (``parallel/pairs.py``), which needs no
communication.

A 2-D layout (``mesh_2d``, ``register_batch_2d``) shards a batch of
large pairs both ways: the ranks are laid out pairs x points, each row
of ``n_points`` ranks registers its shard of the pairs over its points
group, and the results are gathered over the pairs groups.
"""

from __future__ import annotations

import numpy as np
import torch

from se3_icp_tpu_torch.models import registration as reg
from se3_icp_tpu_torch.utils.config import RegistrationConfig, parse_algorithm


def points_mesh(group=None):
    """The points group: ``group``, by default the world group of the
    initialised ``torch.distributed`` (``parallel.multihost.initialize``
    or ``init_process_group``)."""
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialised: call "
                           "parallel.multihost.initialize first")
    return dist.group.WORLD if group is None else group


def register_arrays_points_sharded(src, n_src, tgt, n_tgt,
                                   cfg: RegistrationConfig, algorithm: str,
                                   group=None, exact_knn: bool = False,
                                   stats: dict | None = None):
    """A batch of padded pairs, each row-sharded over ``group``.

    src [B,Ns,3], n_src [B], tgt [B,Nt,3], n_tgt [B] on this rank's
    device (the same values on every rank); Ns and Nt must divide by the
    group's size (``ValueError``).  Returns (T [B,4,4], iters [B],
    pure_iters [B]), the same on every rank.  ``stats`` (optional dict)
    receives ``loop_steps`` and ``host_syncs``.  On the card this replays
    the group's captured program."""
    if algorithm == "fgr":
        raise ValueError("fgr has no points route")
    mode, variant = parse_algorithm(algorithm)
    return reg.dispatch_arrays(src, n_src, tgt, n_tgt, cfg, mode, variant,
                               stats=stats, exact_knn=exact_knn,
                               group=points_mesh(group)).settle()


def register_pair_model_parallel(source_points, target_points,
                                 algorithm: str = "se3_pt2pl",
                                 cfg: RegistrationConfig | None = None,
                                 group=None, dtype=torch.float32,
                                 device="cuda", exact_knn: bool = False
                                 ) -> reg.RegistrationResult:
    """Host-facing single-pair entry point over a points group: every
    rank passes the same clouds.  Each cloud is padded to the 512-point
    bucket (to a multiple of the group's size past 512 ranks), as the
    JAX package pads.  ``device``: this rank's device (``"cuda"`` is its
    current card)."""
    import torch.distributed as dist
    group = points_mesh(group)
    dev = reg.resolve_device(device)
    cfg = cfg or RegistrationConfig()
    quantum = max(512, dist.get_world_size(group))
    src = reg.sanitize_cloud(source_points)
    tgt = reg.sanitize_cloud(target_points)
    ns, nt = len(src), len(tgt)
    src_p = np.zeros((1, reg._bucket(ns, quantum), 3))
    src_p[0, :ns] = src
    tgt_p = np.zeros((1, reg._bucket(nt, quantum), 3))
    tgt_p[0, :nt] = tgt
    T, it, pure = register_arrays_points_sharded(
        torch.as_tensor(src_p, dtype=dtype, device=dev),
        torch.tensor([ns], dtype=torch.int32, device=dev),
        torch.as_tensor(tgt_p, dtype=dtype, device=dev),
        torch.tensor([nt], dtype=torch.int32, device=dev), cfg, algorithm,
        group, exact_knn)
    return reg.RegistrationResult(T[0].double().cpu().numpy(), int(it[0]),
                                  int(pure[0]))


def mesh_2d(n_pairs: int, n_points: int) -> tuple:
    """(pairs_group, points_group) of this rank in a pairs x points
    layout of the world's ranks: rank r sits in row r // n_points (its
    points group: the n_points ranks of that row) and column
    r % n_points (its pairs group: the n_pairs ranks of that column).
    Every rank must call it (``new_group`` is collective)."""
    import torch.distributed as dist
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_pairs * n_points != world:
        raise ValueError(f"a {n_pairs} x {n_points} layout needs "
                         f"{n_pairs * n_points} ranks, the world has "
                         f"{world}")
    points_group = pairs_group = None
    for i in range(n_pairs):
        g = dist.new_group(list(range(i * n_points, (i + 1) * n_points)))
        if rank // n_points == i:
            points_group = g
    for j in range(n_points):
        g = dist.new_group(list(range(j, world, n_points)))
        if rank % n_points == j:
            pairs_group = g
    return pairs_group, points_group


def register_batch_2d(src, n_src, tgt, n_tgt, cfg: RegistrationConfig,
                      algorithm: str, pairs_group, points_group,
                      exact_knn: bool = False, stats: dict | None = None):
    """A batch of padded pairs over a 2-D (pairs, points) layout
    (``mesh_2d``): the pair axis is split over ``pairs_group`` (repeating
    the last pair until it divides), each shard is registered
    row-sharded over ``points_group``, and the results are gathered over
    ``pairs_group`` in pair order.  Every rank passes the whole batch and
    gets the whole result: (T [P,4,4], iters [P], pure_iters [P]).
    ``stats``: this rank's ``loop_steps`` and ``host_syncs``."""
    import torch.distributed as dist
    reg.check_group(pairs_group, src.device)
    n_p, i = dist.get_world_size(pairs_group), dist.get_rank(pairs_group)
    p = src.shape[0]
    c = -(-p // n_p)
    pad = c * n_p - p
    shard = [x if not pad else torch.cat(
        [x, x[-1:].expand(pad, *x.shape[1:])], 0)
        for x in (src, n_src, tgt, n_tgt)]
    out = register_arrays_points_sharded(
        *(x[i * c:(i + 1) * c] for x in shard), cfg, algorithm,
        points_group, exact_knn, stats)
    return tuple(reg.gather_rows(x, pairs_group, 0)[:p] for x in out)
