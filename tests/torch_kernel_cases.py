"""Seed-made inputs of the port's kernel tests that need no JAX: shared by
the emulated-kernel tests on the CPU (``test_torch_kernels_emulated.py``)
and the card-only tests (``test_torch_gpu_kernels.py``), so that both
hold a kernel at the same edges."""

import numpy as np
import torch

from se3_icp_tpu_torch.ops import cuda_knn

# the tied target rows of match_edge_case: one row twice (neighbours),
# one row three times (two neighbours and one 66 rows on)
TIE2, TIE3 = (1, 2), (3, 4, 70)


def match_edge_case(nq, nt, n_tgt, p=9, seed=0, device="cpu"):
    """Inputs of the loop's match (K4) at its edges: three pairs of ``nq``
    queries against ``nt`` target rows, ``n_tgt[b]`` of them valid.  Pair
    0 is in the SE(3) phase, pair 1 in the R3 phase (its phase-B rotation
    block zero, as the engine packs it), pair 2 is done.  In every pair
    target rows ``TIE2`` are one row twice and ``TIE3`` one row three
    times; query 0 sits next to the first, query 1 next to the second
    (exact ties of 2 and 3), every other query next to a valid row of its
    own.  The rows past ``n_tgt[b]`` are copies of the queries' own rows:
    nearer than any valid one, so a kernel that reads them matches them.

    Returns (feat [3,nq,16], w [3,16,16], targets, phase [3,2],
    targets_same): ``targets_same`` packs the phase-B embedding as both
    phases, so that phase 0 runs the full 12-FMA chain on the R3 pair's
    targets."""
    rng = np.random.default_rng(seed)
    bsz = 3
    emb_a = rng.normal(size=(bsz, nt, 12))
    for b in range(bsz):
        emb_a[b, list(TIE2)] = emb_a[b, TIE2[0]]
        emb_a[b, list(TIE3)] = emb_a[b, TIE3[0]]
    emb_b = emb_a.copy()
    emb_b[..., :9] = 0.0
    m = np.eye(12) + 0.1 * rng.normal(size=(bsz, 12, 12))
    off = rng.normal(size=(bsz, 12))
    w = np.zeros((bsz, 16, 16))
    w[:, :12, :12] = m
    w[:, 12, :12] = off
    feat = np.zeros((bsz, nq, 16))
    feat[:, :, 12] = 1.0
    for b in range(bsz):
        n = n_tgt[b]
        rows = rng.integers(TIE3[1] + 1, n, size=nq)
        rows[rows == TIE3[2]] = TIE3[1] + 1
        rows[:2] = TIE2[0], TIE3[0]
        emb = emb_b if b == 1 else emb_a
        q = emb[b, rows] + 0.01 * rng.normal(size=(nq, 12))
        feat[b, :, :12] = np.linalg.solve(m[b].T, (q - off[b]).T).T
        k = min(nt - n, nq)
        emb_a[b, n:n + k] = emb[b, rows[:k]]
        emb_b[b, n:n + k] = emb_a[b, n:n + k]
        emb_b[b, n:n + k, :9] = 0.0
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32),
                                  device=device)
    pay = t(rng.normal(size=(bsz, nt, p)))
    n = torch.tensor(n_tgt, dtype=torch.int32, device=device)
    targets = cuda_knn.pack_match_targets(t(emb_a), t(emb_b), pay, n)
    same = cuda_knn.pack_match_targets(t(emb_b), t(emb_b), pay, n)
    phase = torch.tensor([[0, 0], [1, 0], [0, 1]], dtype=torch.int32,
                         device=device)
    return t(feat), t(w), targets, phase, same


def match_tie_case(nq=256, nt=300, rows=(3, 4, 200), p=5, seed=1,
                   device="cpu"):
    """Two pairs (SE(3) phase, R3 phase) whose ``nq`` queries are all one
    point, and whose target ``rows`` are that point exactly: a tie of
    three rows in two tiles, with every lane of every warp seeing the
    same distances (no other query's improvement can stand in for the
    tie's).  The other targets lie far away.  Returns (feat, w, targets,
    phase)."""
    rng = np.random.default_rng(seed)
    emb = 10.0 + rng.normal(size=(2, nt, 12))
    emb[1, :, :9] = 0.0
    x = rng.normal(size=(2, 12))
    x[1, :9] = 0.0
    emb[:, list(rows)] = x[:, None, :]
    feat = np.zeros((2, nq, 16))
    feat[:, :, :12] = x[:, None, :]
    feat[:, :, 12] = 1.0
    w = np.zeros((2, 16, 16))
    w[:, :12, :12] = np.eye(12)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32),
                                  device=device)
    targets = cuda_knn.pack_match_targets(
        t(emb), t(emb), t(rng.normal(size=(2, nt, p))),
        torch.tensor([nt, nt], dtype=torch.int32, device=device))
    phase = torch.tensor([[0, 0], [1, 0]], dtype=torch.int32, device=device)
    return t(feat), t(w), targets, phase


def hold_match(d2, mt, d2_p, mt_p, targets, tol=1e-4, flip_share=0.01):
    """K4 against its plain version on ``match_edge_case``'s live pairs
    (0 and 1): d2 within ``tol``, at most ``flip_share`` of the rows
    matched elsewhere (float32 near-ties of the in-kernel q = feat @ W),
    the others' rows equal up to the tie average's rounding; the tied
    queries 0 and 1 hold the mean of their tied rows."""
    live = slice(0, 2)
    assert not d2[live].isnan().any() and not mt[live].isnan().any()
    assert float((d2[live] - d2_p[live]).abs().max()) <= tol
    close = torch.isclose(mt[live], mt_p[live], rtol=1e-6, atol=1e-6).all(1)
    assert float((~close).float().mean()) <= flip_share
    pay = targets.payload
    for b in range(2):
        for qi, rows in enumerate((TIE2, TIE3)):
            want = pay[b, list(rows)].mean(0)
            torch.testing.assert_close(mt[b, :, qi], want, rtol=1e-6,
                                       atol=1e-6)


def threshold_edge_clouds(seed=0, n=600, n_valid=(1, 511, 513)):
    """Three Gaussian clouds of width ``n`` (not a multiple of K1's 32
    queries a block) with ``n_valid`` rows valid: one point, one short of
    a 512-target tile, one past it.  Padded rows hold points too (their
    thresholds are computed, and compared, like the others)."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(len(n_valid), n, 3)).astype(np.float32)
    return (torch.as_tensor(pts),
            torch.tensor(n_valid, dtype=torch.int32))
