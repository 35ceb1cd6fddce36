"""Multi-process data parallelism: frame pairs sharded across processes.

Port of the JAX package's ``parallel/multihost.py`` onto
``torch.distributed``.  The reference is single-process; here the
sequence benchmarks scale past one process (one card each, on one host
or on several):

  1. every process calls :func:`initialize` (the rendezvous: NCCL with
     one card a process on the card, gloo on the CPU);
  2. each process loads only ITS slice of the pair list;
  3. :func:`register_pairs_multihost` agrees on the padded widths and
     the per-process pair count with one all_gather, registers the local
     batch on the process's own card (``parallel.pairs.register_batch``:
     no cross-pair communication), and all-gathers the results, so
     every process returns the full list.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from se3_icp_tpu_torch.models import registration as reg
from se3_icp_tpu_torch.parallel import pairs as par


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, device="cuda") -> None:
    """Join the process group: ``coordinator_address`` is ``host:port``
    (or any ``init_method`` URL, e.g. ``file://``).  On the card (the
    default) the group is NCCL with one card a process: the local rank
    (``LOCAL_RANK``, else ``process_id`` modulo the visible cards) picks
    the card, set before the rendezvous.  ``device='cpu'`` takes gloo.
    No card, or no NCCL, raises: nothing falls back to the CPU."""
    import torch.distributed as dist
    dev = reg.resolve_device(device)
    if dev.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("this torch build has no NCCL: the "
                               "multi-process route on the card needs it")
        local = int(os.environ.get("LOCAL_RANK",
                                   process_id % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        backend = "nccl"
    else:
        backend = "gloo"
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes, rank=process_id)


def global_pairs_mesh():
    """The group every process registers its pairs in: the world."""
    import torch.distributed as dist
    return dist.group.WORLD


def _local_device(group):
    """This process's device for ``group``'s collectives: its current
    card under NCCL, the CPU under gloo."""
    import torch.distributed as dist
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def register_pairs_multihost(local_pairs, algorithm: str, cfg,
                             dtype=np.float32, bucket: int = 512,
                             device="cuda", exact_knn: bool = False):
    """Register pairs distributed over all processes.

    ``local_pairs``: THIS process's list of (src, tgt) numpy clouds.
    Every process must call this collectively, with the same
    ``algorithm`` and ``cfg`` (an ``FGRConfig`` for ``'fgr'``).  The
    processes agree on each side's padded width (the ``bucket`` of the
    largest cloud anywhere) and the per-process count (the largest);
    a short process pads by repeating its last pair, and a process with
    no pairs still takes part with a dummy one.  ``device``: this
    process's device, which must match the group's backend (NCCL: its
    card; gloo: ``'cpu'``).  Returns the full result list, process-major,
    identical on every process."""
    group = global_pairs_mesh()
    dev = reg.resolve_device(device)
    reg.check_group(group, dev)
    if dev.type == "cuda":
        dev = _local_device(group)
    mine = torch.tensor(
        [[max((len(s) for s, _ in local_pairs), default=1),
          max((len(t) for _, t in local_pairs), default=1),
          len(local_pairs)]], dtype=torch.int64, device=dev)
    agreed = reg.gather_rows(mine, group, 0).cpu().numpy()  # [procs, 3]
    per_proc = int(agreed[:, 2].max())
    if per_proc == 0:
        return []
    filler = (local_pairs[-1] if local_pairs
              else (np.zeros((1, 3)), np.zeros((1, 3))))
    padded = list(local_pairs) + [filler] * (per_proc - len(local_pairs))
    sides = []
    for k in (0, 1):
        width = reg._bucket(int(agreed[:, k].max()), bucket)
        pts, counts = par.pack_clouds(
            [pair[k] for pair in padded], dtype,
            out=np.zeros((per_proc, width, 3), dtype))
        sides += [torch.as_tensor(pts, device=dev),
                  torch.as_tensor(counts, device=dev)]
    out = par.register_batch(*sides, cfg, algorithm, device=dev,
                             exact_knn=exact_knn)
    T, it, pure = (reg.gather_rows(x, group, 0).cpu() for x in out[:3])
    T = T.double().numpy()
    results = []
    for proc, real in enumerate(agreed[:, 2].tolist()):
        base = proc * per_proc
        results += [reg.RegistrationResult(T[base + i].copy(),
                                           int(it[base + i]),
                                           int(pure[base + i]))
                    for i in range(int(real))]
    return results
