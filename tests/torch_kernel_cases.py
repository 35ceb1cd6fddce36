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


# ---------------------------------------------------------------- K5

def epilogue_layout(variant, is_se3, use_cf):
    """Payload rows of the loop's epilogue (K5): (offsets, rows)."""
    off = {"tr": 3 if is_se3 else 0}
    p_rows = 3 + (3 if is_se3 else 0)
    if variant == "pt2pl":
        off["nrm"] = p_rows
        p_rows += 3
    if variant == "gicp":
        off["cov"] = p_rows
        p_rows += 6
        if use_cf:
            off["conf"] = p_rows
            p_rows += 1
    return off, p_rows


def epilogue_case(variant, is_se3, use_cf, overlap, seed=7, b=3, n=700,
                  ties=False):
    """Inputs of K5: ``b`` pairs of ``n`` points (not a multiple of the
    512 threads a pair), valid counts n, 5n/7 and n/3 + 1, phases mixed.
    ``ties``: rotation identity, no translation, integer-grid sources and
    matched points a few grid offsets away, so the trim keys take a few
    values, each many times, and the keep count falls inside a run of
    equal keys (the kept set is then decided by index).  Returns (srcT,
    matchedT, pf, cov6, conf, keyword arguments) as torch CPU tensors."""
    from se3_icp_tpu_torch.ops import cuda_loop as cl
    rng = np.random.default_rng(seed)
    off, p_rows = epilogue_layout(variant, is_se3, use_cf)
    mt = rng.normal(size=(b, p_rows, n)).astype(np.float32)
    pf = np.zeros((b, cl.PF_WIDTH), np.float32)
    if ties:
        srcT = rng.integers(-8, 9, size=(b, 3, n)).astype(np.float32)
        step = rng.integers(0, 3, size=(b, 3, n)).astype(np.float32) * 0.5
        mt[:, 0:3] = srcT + step
        if is_se3:
            mt[:, off["tr"]:off["tr"] + 3] = srcT - step
        pf[:, cl.PF_R:cl.PF_R + 9] = np.eye(3, dtype=np.float32).reshape(9)
        pf[:, cl.PF_BETA] = 1.0
    else:
        srcT = rng.normal(size=(b, 3, n)).astype(np.float32)
        for i in range(b):
            q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
            q *= np.sign(np.linalg.det(q))
            pf[i, cl.PF_R:cl.PF_R + 9] = q.reshape(9)
        pf[:, cl.PF_T:cl.PF_T + 3] = rng.normal(size=(b, 3))
        pf[:, cl.PF_BETA] = 1.25
    pf[:, cl.PF_SWITCHED] = (np.arange(b) % 2).astype(np.float32)
    ns = np.array([n, 5 * n // 7, n // 3 + 1][:b] + [n] * max(0, b - 3),
                  np.float32)
    pf[:, cl.PF_NSRC] = ns
    pf[:, cl.PF_COUNT] = np.floor(overlap * ns)
    cov6 = conf = None
    if variant == "pt2pl":
        nr = mt[:, off["nrm"]:off["nrm"] + 3]
        mt[:, off["nrm"]:off["nrm"] + 3] = (
            nr / np.linalg.norm(nr, axis=1, keepdims=True))
    if variant == "gicp":
        def spd6(a):
            return np.stack([a[:, 0] ** 2 + 0.5, a[:, 0] * a[:, 1] * .1,
                             a[:, 0] * a[:, 2] * .1, a[:, 1] ** 2 + 0.7,
                             a[:, 1] * a[:, 2] * .1, a[:, 2] ** 2 + 0.9],
                            axis=1).astype(np.float32)
        cov6 = torch.as_tensor(spd6(rng.normal(size=(b, 3, n))))
        mt[:, off["cov"]:off["cov"] + 6] = spd6(rng.normal(size=(b, 3, n)))
        if use_cf:
            conf = torch.as_tensor(
                rng.uniform(0.2, 1.0, size=(b, n)).astype(np.float32))
            mt[:, off["conf"]] = rng.uniform(0.2, 1.0, (b, n))
    kw = dict(variant=variant, is_se3=is_se3, use_cf=use_cf,
              do_trim=overlap < 1.0, off_tr=off.get("tr", 0),
              off_nrm=off.get("nrm", 0), off_cov=off.get("cov", 0),
              off_conf=off.get("conf", 0))
    return (torch.as_tensor(srcT), torch.as_tensor(mt), torch.as_tensor(pf),
            cov6, conf, kw)


def hold_epilogue(got, want, variant):
    """K5's contract against its plain version: the kept count exactly,
    A and b within 1e-5 of each pair's largest entry (gicp 1e-4), the MSE
    within 1e-5 relative."""
    A, b, st = got
    Ap, bp, stp = want
    assert torch.equal(st[:, 1], stp[:, 1])
    rel = 1e-4 if variant == "gicp" else 1e-5
    for k, p in ((A, Ap), (b, bp)):
        scale = p.abs().flatten(1).amax(1).clamp_min(1.0)
        assert float(((k - p).abs().flatten(1).amax(1) / scale).max()) <= rel
    assert float(((st[:, 0] - stp[:, 0]).abs()
                  / stp[:, 0].abs().clamp_min(1e-6)).max()) <= 1e-5


# ------------------------------------------------------- K6-K9 split

# the 1-NN split cases: four pairs of 300 queries against 333 target
# rows (three tiles of 128); valid counts past the rows (clipped to
# 333), inside a tile, at a tile (slice) boundary, and one target
SPLIT_COUNTS = (400, 200, 256, 1)
# target row TIE_HI repeats row TIE_LO in every pair, across the slice
# boundaries at 128 and 256; query 0 sits exactly on them
TIE_LO, TIE_HI = 100, 300


def split_case(d, seed=0):
    """(q [4,300,d], t [4,333,d], n [4] int32) for the split 1-NN."""
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(4, 300, d, generator=g)
    t = torch.randn(4, 333, d, generator=g)
    t[:, TIE_HI] = t[:, TIE_LO]
    t[:, 150] = t[:, 20]          # an exact tie inside pair 1's count
    q[:, 0] = t[:, TIE_LO]
    q[:, 1] = t[:, 20]
    return q, t, torch.tensor(SPLIT_COUNTS, dtype=torch.int32)


# ------------------------------------------------- K6/K7 tiled search

# exact ties planted in the targets of the tiled search (csrc/nn_argmin.cu
# nn_tiled_kernel: 4 threads share a query, each with 8 targets a step in
# two groups of 4, 32 targets a step, tiles of 256 targets at D <= 12 and
# of 64 above): inside one thread's group (1, 2) and across its two
# groups (6, 22); between two threads of a query, the lower index in the
# higher thread (13, 17) and in the lower one (5, 9); across steps of one
# thread (10, 74; 3, 35) and of two (28, 32); across tiles (20, 148,
# 276).  Query i sits exactly on the first row of tie i, so the lowest
# index is its answer.
TILED_TIES = ((1, 2), (6, 22), (13, 17), (5, 9), (10, 74), (3, 35),
              (28, 32), (20, 148, 276))
# valid counts: every row (333, no multiple of a tile or a step), none,
# inside a tile (201: the last tie reaches past it), one past a tile of
# 128 (129)
TILED_COUNTS = (333, 0, 201, 129)


def tiled_case(d, one_point=False, seed=0):
    """(q [4,300,d], t [4,333,d], n [4] int32) for the tiled 1-NN: 300
    queries (no multiple of the 128 a block).  Rows at or past a pair's
    count are copies of its queries, nearer than any valid row, so a
    search that reads them matches them.  ``one_point``: every query is
    one point and the ties' rows are that point (the others far), so every
    lane of every warp sees the same distances."""
    rng = np.random.default_rng(seed)
    nq, nt = 300, 333
    q = rng.normal(size=(4, nq, d))
    t = rng.normal(size=(4, nt, d))
    rows = [j for tie in TILED_TIES for j in tie]
    if one_point:
        t += 8.0
        x = rng.normal(size=(4, 1, d))
        q[:] = x
        t[:, rows] = x
    else:
        for i, tie in enumerate(TILED_TIES):
            t[:, list(tie)] = t[:, [tie[0]]]
            q[:, i] = t[:, tie[0]]
    for b, n in enumerate(TILED_COUNTS):
        k = min(nt - n, nq)
        t[b, n:n + k] = q[b, :k]
    return (torch.as_tensor(q.astype(np.float32)),
            torch.as_tensor(t.astype(np.float32)),
            torch.tensor(TILED_COUNTS, dtype=torch.int32))


def tiled_answers(one_point=False):
    """{(pair, query): index} the planted ties fix in ``tiled_case``."""
    out = {}
    for b, n in enumerate(TILED_COUNTS):
        if one_point:
            lo = min(j for tie in TILED_TIES for j in tie if j < n) \
                if n > 1 else None
            if lo is not None:
                out.update({(b, i): lo for i in range(300)})
            continue
        for i, tie in enumerate(TILED_TIES):
            if tie[0] < n:
                out[(b, i)] = tie[0]
    return out


# ------------------------------------------------ K8 on packed targets

# each pair's phase in packed_case: mixed, the pair with no valid target
# in the second block
PACKED_PHASES = (0, 1, 1, 0)
# rows of packed_case(nudge=True) whose given |t|^2 lies one ulp below
# the torch sum: the later row of the ties (13, 17) and (10, 74) and the
# middle one of (20, 148, 276) then wins where it is valid
NUDGED_ROWS = (17, 74, 148)


def packed_case(one_point=False, nudge=False, seed=0, device="cpu"):
    """``tiled_case(12, one_point)`` packed into two phase blocks as
    ``cuda_knn.pack_match_targets`` packs them (|t|^2 a torch sum): pair
    b's rows in block ``PACKED_PHASES[b]``, the other block the same rows
    one place on (a search of the wrong block moves every planted answer
    by one), a payload of 9 columns.  ``nudge``: the given |t|^2 of
    ``NUDGED_ROWS`` in each pair's block one ulp lower.  Returns (q
    [4,300,12], targets, phase [4] int32, {(pair, query): index} of the
    planted answers)."""
    q, t, n = tiled_case(12, one_point, seed)
    phase = torch.tensor(PACKED_PHASES, dtype=torch.int32)
    other = torch.roll(t, 1, dims=1)
    sel = phase.bool()[:, None, None]
    pay = torch.as_tensor(np.random.default_rng(seed + 1).normal(
        size=(4, t.shape[1], 9)).astype(np.float32))
    targets = cuda_knn.pack_match_targets(torch.where(sel, other, t),
                                          torch.where(sel, t, other), pay, n)
    answers = tiled_answers(one_point)
    if nudge:
        rows = list(NUDGED_ROWS)
        ar = torch.arange(4)[:, None]
        blk = phase.long()[:, None]
        targets.tn[ar, blk, rows] = torch.nextafter(
            targets.tn[ar, blk, rows], torch.tensor(-float("inf")))
        for b, cnt in enumerate(TILED_COUNTS):
            for i, tie in enumerate(TILED_TIES):
                won = [j for j in tie if j in NUDGED_ROWS and j < cnt]
                if (b, i) in answers and won:
                    answers[(b, i)] = won[0]
    to = lambda x: x.to(device)
    targets = cuda_knn.MatchTargets(emb=to(targets.emb), tn=to(targets.tn),
                                    payload=to(targets.payload),
                                    n=to(targets.n))
    return to(q), targets, to(phase), answers
