"""Batched multi-start registration: widen the convergence basin by
running the SAME pair from a grid of rotation initializations in one
batched call and keeping the start with the lowest trimmed
nearest-neighbour mean distance.

Port of the JAX package's ``models/multistart.py``.  The reference has
no equivalent (its "difficult" synthetic protocol is single-start).  The
start axis is just more batch for the engine
(``parallel/pairs.register_batch``): a fleet of P pairs x K starts is
P*K independent registrations of one shape, scored afterwards by ONE
batched 1-NN launch (K6, ``ops/cuda_nn.py``) of every candidate
transform against its pair's target.

Starts are rotations about the source centroid: the engine's
preprocessing already centres both clouds, so translation offsets are
absorbed and the basin structure lives on SO(3).  The grid is the
24-element octahedral rotation group ordered greedily by geodesic
coverage (identity first), extended past 24 by a super-Fibonacci
low-discrepancy SO(3) spiral (Alexa, CVPR 2022).

Single device only: sharding the flat (pair, start) batch over several
GPUs comes with the port's multi-GPU slice.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from se3_icp_tpu_torch.models import registration as reg
from se3_icp_tpu_torch.ops import knn, trim
from se3_icp_tpu_torch.utils.config import RegistrationConfig

# flat registrations per engine call when the caller gives no
# ``pair_chunk``: the serving batch (64 pairs) of the main path
FLAT_BATCH = 64


def _octahedral_group() -> np.ndarray:
    """The 24 rotation matrices of the cube/octahedron group."""
    mats = []
    seen = set()
    axes = np.eye(3)

    def rot(axis, k):
        c, s = [1, 0, -1, 0][k % 4], [0, 1, 0, -1][k % 4]
        a = axes[axis]
        K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]],
                      [-a[1], a[0], 0]])
        return np.eye(3) + s * K + (1 - c) * (K @ K)
    frontier = [np.eye(3)]
    while frontier:
        nxt = []
        for M in frontier:
            key = tuple(np.round(M, 6).ravel())
            if key in seen:
                continue
            seen.add(key)
            mats.append(M)
            for ax in range(3):
                nxt.append(rot(ax, 1) @ M)
        frontier = nxt
    if len(mats) != 24:
        raise AssertionError(f"octahedral group has {len(mats)} elements")
    return np.stack(mats)


def _geo_dist(Ra, Rb):
    """Geodesic angle between rotation matrices (broadcasts)."""
    tr = np.einsum("...ij,...ij->...", Ra, Rb)
    return np.arccos(np.clip((tr - 1.0) / 2.0, -1.0, 1.0))


@functools.lru_cache(maxsize=1)
def _ordered_octahedral() -> np.ndarray:
    """Octahedral group greedily ordered for coverage, identity first:
    each next element maximizes the min geodesic distance to the ones
    already picked, so any prefix is a good SO(3) covering."""
    G = _octahedral_group()
    order = [int(np.argmin([_geo_dist(g, np.eye(3)) for g in G]))]
    rest = [i for i in range(24) if i != order[0]]
    while rest:
        dmin = [min(_geo_dist(G[i], G[j]) for j in order) for i in rest]
        pick = rest[int(np.argmax(dmin))]
        order.append(pick)
        rest.remove(pick)
    return G[np.asarray(order)]


def _quat_to_mat(q: np.ndarray) -> np.ndarray:
    """[n,4] unit quaternions (w,x,y,z) -> [n,3,3] rotation matrices."""
    w, x, y, z = q.T
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                  2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                  2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                  1 - 2 * (x * x + y * y)], -1),
    ], -2)


def super_fibonacci(n: int) -> np.ndarray:
    """[n,4] super-Fibonacci spiral quaternions (Alexa, CVPR 2022): a
    deterministic low-discrepancy covering of SO(3)."""
    phi = np.sqrt(2.0)
    psi = 1.533751168755204288118041  # positive root of x^4 = x + 4
    s = np.arange(n, dtype=np.float64) + 0.5
    t = s / n
    d = 2.0 * np.pi * s
    r, R = np.sqrt(t), np.sqrt(1.0 - t)
    a, b = d / phi, d / psi
    return np.stack([r * np.sin(a), r * np.cos(a),
                     R * np.sin(b), R * np.cos(b)], -1)


def so3_grid(n_starts: int, seed: int = 0) -> np.ndarray:
    """[n,3,3] deterministic rotation starts: identity-led greedy
    octahedral prefix; past 24, a super-Fibonacci low-discrepancy SO(3)
    spiral (composed with one seeded random rotation so distinct seeds
    give distinct-but-equally-covering fleets)."""
    G = _ordered_octahedral()
    if n_starts <= 24:
        return np.array(G[:n_starts])
    q = super_fibonacci(n_starts - 24)
    rng = np.random.default_rng(seed)
    q0 = rng.normal(size=4)
    R0 = _quat_to_mat((q0 / np.linalg.norm(q0))[None])[0]
    return np.concatenate([G, _quat_to_mat(q) @ R0], 0)


def score_transforms(T, src, n_src, tgt, n_tgt, overlap: float):
    """Trimmed-mean nearest-neighbour distance of each source under its
    candidate transform against its target -- the quantity the engine's
    stop test tracks (a mean distance, not squared), in the ORIGINAL
    frame so candidates from different starts are comparable.

    T [B,4,4], src [B,Ns,3], n_src [B], tgt [B,Nt,3], n_tgt [B], all on
    one device -> [B]: one K6 launch for the whole batch."""
    moved = src @ T[:, :3, :3].mT + T[:, None, :3, 3]
    _, d2 = knn.nn_argmin(moved, tgt, n_tgt)
    d = torch.sqrt(torch.clamp_min(d2, 0.0))
    col = torch.arange(src.shape[1], device=src.device)
    valid = col[None, :] < n_src[:, None]
    kept = trim.trim_mask(d, valid, overlap, n_src.to(d.dtype))
    return trim.masked_mean(d, kept)


@dataclass
class MultistartResult:
    best: reg.RegistrationResult
    start_index: int
    scores: np.ndarray          # [n_starts] trimmed NN mean distance
    rotations: np.ndarray       # [n_starts,3,3] start rotations


def _start_composition(rots: np.ndarray, c: np.ndarray) -> np.ndarray:
    """[K,4,4] rotation of the source about its centroid ``c`` by each
    start: the registered transform times this maps the ORIGINAL
    source."""
    M = np.zeros((len(rots), 4, 4))
    M[:, :3, :3] = rots
    M[:, :3, 3] = c - rots @ c
    M[:, 3, 3] = 1.0
    return M


def _keep_best(T_full, it, pure, scores, rots):
    k = int(np.argmin(scores))
    best = reg.RegistrationResult(transformation=T_full[k],
                                  num_iterations=int(it[k]),
                                  num_pure_se3_iterations=int(pure[k]))
    return MultistartResult(best=best, start_index=k, scores=scores,
                            rotations=rots)


def register_pair_multistart(source_points, target_points,
                             algorithm: str = "se3_pt2pl",
                             cfg: RegistrationConfig | None = None,
                             n_starts: int = 8, seed: int = 0,
                             dtype=torch.float32, device="cuda",
                             exact_knn: bool = False,
                             mesh=None) -> MultistartResult:
    """Register one pair from ``n_starts`` rotation initializations in
    one batched call; return the start with the lowest trimmed NN score
    (plus all scores for diagnostics).  Runs on the card unless
    ``device='cpu'``; ``mesh`` as ``register_pairs_multistart``."""
    return register_pairs_multistart(
        [(source_points, target_points)], algorithm, cfg, n_starts, seed,
        dtype=dtype, device=device, exact_knn=exact_knn, mesh=mesh)[0]


def register_pairs_multistart(pairs, algorithm: str = "se3_pt2pl",
                              cfg: RegistrationConfig | None = None,
                              n_starts: int = 8, seed: int = 0,
                              dtype=torch.float32,
                              pair_chunk: int | None = None, device="cuda",
                              stats: dict | None = None,
                              exact_knn: bool = False, mesh=None
                              ) -> list[MultistartResult]:
    """Multi-start registration of MANY pairs: the engine's batch is
    (pair, start) flattened -- independent registrations of one shape.
    Scores come from one batched trimmed-NN pass a chunk; each pair keeps
    its best start.

    Pairs run in chunks of ``pair_chunk`` (default: ``FLAT_BATCH``
    flat registrations a call), so the flat batch stays at serving scale
    whatever ``len(pairs)``; every chunk has one shape (cloud buckets
    from the FULL list; the tail chunk repeats its last pair).
    ``stats`` receives the engine's ``loop_steps`` and ``host_syncs``,
    summed over the chunks.

    ``mesh``: a pairs mesh (``parallel.pairs.default_mesh``) the
    flattened (pair, start) batch is sharded over, as
    ``register_pairs``: by default every card when there is more than
    one; ``mesh=False`` forces one device.  The default chunk then holds
    enough pairs that the flattened axis covers every device of the
    mesh.  Scores are taken on ``device``."""
    from se3_icp_tpu_torch.parallel import pairs as par
    dev = reg.resolve_device(device)
    mesh = par._auto_mesh(mesh, dev)
    ndev = 1 if mesh is None else len(mesh)
    cfg = cfg or RegistrationConfig()
    rots = so3_grid(n_starts, seed)
    srcs = [reg.sanitize_cloud(s) for s, _ in pairs]
    tgts = [reg.sanitize_cloud(t) for _, t in pairs]
    p_n = len(pairs)
    if pair_chunk is None:
        pair_chunk = max(1, -(-FLAT_BATCH // n_starts), -(-ndev // n_starts))
    pair_chunk = max(1, min(pair_chunk, p_n))
    ns_max = reg._bucket(max(len(s) for s in srcs))
    nt_max = reg._bucket(max(len(t) for t in tgts))

    out: list[MultistartResult] = [None] * p_n          # type: ignore
    for lo in range(0, p_n, pair_chunk):
        sel = list(range(lo, min(lo + pair_chunk, p_n)))
        idx = sel + [sel[-1]] * (pair_chunk - len(sel))  # pad the tail
        res = _multistart_chunk([srcs[i] for i in idx],
                                [tgts[i] for i in idx], rots, algorithm,
                                cfg, dtype, dev, ns_max, nt_max, stats,
                                exact_knn, mesh)
        for j, i in enumerate(sel):
            out[i] = res[j]
    return out


def _multistart_chunk(srcs, tgts, rots, algorithm, cfg, dtype, dev, ns_max,
                      nt_max, stats, exact_knn,
                      mesh=None) -> list[MultistartResult]:
    """One fixed-shape (pair, start) chunk: register, score, select."""
    from se3_icp_tpu_torch.parallel import pairs as par

    p_n, n_starts = len(srcs), len(rots)
    src_b = np.zeros((p_n, n_starts, ns_max, 3))
    src_p = np.zeros((p_n, ns_max, 3))
    tgt_b = np.zeros((p_n, nt_max, 3))
    n_src = np.zeros(p_n, np.int32)
    n_tgt = np.zeros(p_n, np.int32)
    M = np.zeros((p_n, n_starts, 4, 4))
    for i, (s, t) in enumerate(zip(srcs, tgts)):
        c = s.mean(0)
        src_b[i, :, :len(s)] = np.einsum("kij,nj->kni", rots, s - c) + c
        src_p[i, :len(s)] = s
        tgt_b[i, :len(t)] = t
        n_src[i], n_tgt[i] = len(s), len(t)
        M[i] = _start_composition(rots, c)

    def dev_t(a, dt=dtype):
        return torch.as_tensor(a, dtype=dt, device=dev)

    tgt_d = dev_t(tgt_b)
    flat_tgt = tgt_d[:, None].expand(-1, n_starts, -1, -1).reshape(
        p_n * n_starts, nt_max, 3)
    n_src_k = dev_t(np.repeat(n_src, n_starts), torch.int32)
    n_tgt_k = dev_t(np.repeat(n_tgt, n_starts), torch.int32)
    T, it, pure = par.register_batch(
        dev_t(src_b.reshape(p_n * n_starts, ns_max, 3)), n_src_k, flat_tgt,
        n_tgt_k, cfg, algorithm, device=dev, stats=stats,
        exact_knn=exact_knn, mesh=mesh)
    T_full = (T.double().cpu().numpy().reshape(p_n, n_starts, 4, 4) @ M)

    # every candidate against its pair's ORIGINAL source and target
    src_d = dev_t(src_p)
    with torch.no_grad():
        scores = score_transforms(
            dev_t(T_full.reshape(p_n * n_starts, 4, 4)),
            src_d[:, None].expand(-1, n_starts, -1, -1).reshape(
                p_n * n_starts, ns_max, 3),
            n_src_k, flat_tgt, n_tgt_k, float(cfg.estimated_overlap))
    scores = scores.double().cpu().numpy().reshape(p_n, n_starts)
    it = it.cpu().numpy().reshape(p_n, n_starts)
    pure = pure.cpu().numpy().reshape(p_n, n_starts)
    return [_keep_best(T_full[i], it[i], pure[i], scores[i], rots)
            for i in range(p_n)]
