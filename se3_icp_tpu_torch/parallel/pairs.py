"""Batched registration of independent frame pairs on one device.

The serving surface: a list of (source, target) numpy clouds is packed
into padded batch arrays, uploaded once, registered by the natively
batched engine (every pair iterates until the whole batch converged;
per-pair ``done`` masking keeps finished pairs idle and results exact),
and downloaded with one transfer.

``algorithm="fgr"`` runs Fast Global Registration (``models/fgr.py``)
on the same batch contract.  This is the single-GPU subset.  Sharding
pairs over several devices and asynchronous pipelining of consecutive
batches are later slices of the port.
"""

from __future__ import annotations

import numpy as np
import torch

from se3_icp_tpu_torch.models import registration as reg
from se3_icp_tpu_torch.utils.config import parse_algorithm


def register_batch(src, n_src, tgt, n_tgt, cfg, algorithm: str,
                   initial_T=None, device="cuda",
                   stats: dict | None = None, exact_knn: bool = False):
    """Register a batch of padded pairs held in tensors.

    src [P,Ns,3], n_src [P], tgt [P,Nt,3], n_tgt [P], all on ``device``:
    the card unless the caller passes ``device='cpu'``.  Tensors that lie
    elsewhere raise (nothing is moved, and nothing runs on the CPU unasked).
    ``cfg``: a ``RegistrationConfig``; for ``algorithm='fgr'`` an
    ``FGRConfig``, any other config giving the default ``FGRConfig``.
    ``initial_T`` [P,4,4] optionally warm-starts each pair (original
    coordinates; not for fgr).  ``exact_knn``: the exact sorted-kNN setup
    instead of the sort-free threshold route (ICP algorithms).  Returns
    (T [P,4,4], iters [P], pure_iters [P]) as tensors on that device.
    """
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
    if algorithm == "fgr":
        from se3_icp_tpu_torch.models import fgr
        fcfg = cfg if isinstance(cfg, fgr.FGRConfig) else fgr.FGRConfig()
        return fgr.fgr_register_arrays(src, n_src, tgt, n_tgt, fcfg,
                                       stats=stats)
    mode, variant = parse_algorithm(algorithm)
    return reg.register_arrays(src, n_src, tgt, n_tgt, cfg, mode, variant,
                               initial_T=initial_T, stats=stats,
                               exact_knn=exact_knn)


def pack_clouds(clouds, dtype=np.float32, bucket: int = 512):
    """Host-side packing of one cloud list -> ([P,N,3], counts [P]),
    N the 512-point bucket of the largest cloud.  Non-finite points are
    dropped (see ``registration.sanitize_cloud``)."""
    raw = [reg.sanitize_cloud(c) for c in clouds]
    width = reg._bucket(max(len(c) for c in raw), bucket)
    out = np.zeros((len(raw), width, 3), dtype)
    counts = np.zeros(len(raw), np.int32)
    for i, c in enumerate(raw):
        out[i, :len(c)] = c
        counts[i] = len(c)
    return out, counts


def pack_pairs(pairs, dtype=np.float32, bucket: int = 512):
    """Host-side packing: list of (src_pts, tgt_pts) -> padded batch
    arrays (src [P,Ns,3], n_src [P], tgt [P,Nt,3], n_tgt [P])."""
    src, n_src = pack_clouds([s for s, _ in pairs], dtype, bucket)
    tgt, n_tgt = pack_clouds([t for _, t in pairs], dtype, bucket)
    return src, n_src, tgt, n_tgt


def register_pairs(pairs, algorithm: str, cfg, dtype=np.float32,
                   initial_Ts=None, device="cuda",
                   stats: dict | None = None, exact_knn: bool = False):
    """High-level: list of (src, tgt) numpy clouds -> list of
    ``RegistrationResult``.  Runs on the card unless ``device='cpu'``.
    ``algorithm='fgr'`` takes an ``FGRConfig`` (or any other config for
    the default one), as ``register_batch``.

    ``initial_Ts``: optional [P,4,4] (or list of [4,4]) warm starts.
    ``stats``: optional dict that receives ``loop_steps`` and
    ``host_syncs`` of the call (for fgr: ``reciprocal`` and
    ``kept_correspondences`` per pair).  ``exact_knn``: the exact
    sorted-kNN setup instead of the threshold route."""
    dev = reg.resolve_device(device)
    src, n_src, tgt, n_tgt = pack_pairs(pairs, dtype)
    t0 = (None if initial_Ts is None
          else torch.as_tensor(np.asarray(initial_Ts, dtype), device=dev))
    T, it, pure = register_batch(
        torch.as_tensor(src, device=dev), torch.as_tensor(n_src, device=dev),
        torch.as_tensor(tgt, device=dev), torch.as_tensor(n_tgt, device=dev),
        cfg, algorithm, initial_T=t0, device=dev, stats=stats,
        exact_knn=exact_knn)
    # one device->host transfer for the whole batch
    flat = torch.cat([T.flatten(1).double(), it[:, None].double(),
                      pure[:, None].double()], dim=1).cpu().numpy()
    return [reg.RegistrationResult(row[:16].reshape(4, 4).copy(),
                                   int(row[16]), int(row[17]))
            for row in flat]
