"""A pair's result does not follow its batch: the setup's centring and
scaling (G4's plain version, ``ops/cuda_prep.py``) and the maps in and
out of the preprocessed frame (``registration.to_original``,
``warm_start``), on the CPU, against the JAX package and across batch
sizes and padded widths.

  * ``center_scale_plain`` against the JAX package's
    ``_masked_centroid``, ``_largest_radius`` and scaling
    (``se3_icp_tpu/models/registration.py:85-93, 209-220``, vmapped over
    the pairs) on seed-made clouds: 1e-12 of the largest magnitude of
    each result in float64, 1e-6 in float32 (its sums run in another
    order than XLA's).
  * Its bits, pair by pair, in batches of 1, 2, 3 and 8 and at two
    padded widths with the same valid rows, in float32 and float64.
  * ``to_original`` and ``warm_start``, written component by component,
    against the JAX package's ``to_original`` (the closure at
    ``se3_icp_tpu/models/registration.py:941-950``, evaluated with jnp
    on the same arrays) and its warm start (l.617-620) to 1e-12 in
    float64, history shapes included; each the other's inverse to
    1e-12.
  * The CPU route's setup products (the centred clouds, the query
    features, the target embeddings and payload): three pairs set up
    together and one by one, bit for bit.
  * ``cuda_prep.lane_sums`` of any width: the three-column bits of G4's
    plain version, a column's bits whatever the other columns.
  * The whole CPU registration (``se3_pt2pl``, ``se3_gicp`` trimmed,
    ``se3_pt2pt``, ``pt2pl``; float32 and float64) and FGR: each pair's
    transform, counts and history bits alone and in batches of 2 and 3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se3_icp_tpu.models import registration as j_reg

from se3_icp_tpu_torch.datasets import fixtures
from se3_icp_tpu_torch.models import registration as reg
from se3_icp_tpu_torch.ops import cuda_prep
from se3_icp_tpu_torch.parallel import pairs
from se3_icp_tpu_torch.utils.config import GOLDEN

torch.set_num_threads(1)

TOL = {np.float64: 1e-12, np.float32: 1e-6}
SIZES = (300, 517, 260, 700, 333, 480, 1, 610)   # valid rows a pair


def _clouds(seed: int = 15):
    """Eight seed-made pairs of other sizes, offsets and spreads."""
    rng = np.random.default_rng(seed)
    out = []
    for i, n in enumerate(SIZES):
        src = rng.normal(size=(n, 3)) * rng.uniform(0.2, 3.0, 3) \
            + rng.normal(size=3) * 4
        tgt = rng.normal(size=(n + 11 * i, 3)) * rng.uniform(0.2, 3.0, 3) \
            - rng.normal(size=3) * 2
        out.append((src, tgt))
    return out


def _packed(pair_list, dtype):
    src, n_src, tgt, n_tgt = pairs.pack_pairs(pair_list)
    return (torch.from_numpy(src.astype(dtype)), torch.from_numpy(n_src),
            torch.from_numpy(tgt.astype(dtype)), torch.from_numpy(n_tgt))


def _jax_center_scale(src, n_src, tgt, n_tgt, scale):
    """The JAX package's preprocessing of a batch (its per-pair
    functions, vmapped)."""
    def one(s, ns, t, nt):
        sv = jnp.arange(s.shape[0]) < ns
        tv = jnp.arange(t.shape[0]) < nt
        cen_s = j_reg._masked_centroid(s, sv, ns)
        cen_t = j_reg._masked_centroid(t, tv, nt)
        r = jnp.maximum(j_reg._largest_radius(s, cen_s, sv),
                        j_reg._largest_radius(t, cen_t, tv))
        sc = scale / jnp.maximum(r, jnp.asarray(1e-30, s.dtype))
        s_c = jnp.where(sv[:, None], (s - cen_s) * sc, 0.0)
        t_c = jnp.where(tv[:, None], (t - cen_t) * sc, 0.0)
        return s_c, t_c, cen_s, cen_t, sc
    out = jax.vmap(one)(*(jnp.asarray(x.numpy()) for x in
                          (src, n_src, tgt, n_tgt)))
    return [np.asarray(x) for x in out]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_center_scale_plain_agrees_with_the_jax_package(dtype):
    src, n_src, tgt, n_tgt = _packed(_clouds()[:6], dtype)
    got = cuda_prep.center_scale_plain(src, n_src, tgt, n_tgt, 3.0)
    want = _jax_center_scale(src, n_src, tgt, n_tgt, dtype(3.0))
    tol = TOL[dtype]
    for name, a, b in zip(("src_c", "tgt_c", "cen_s", "cen_t", "scaling"),
                          got, want):
        np.testing.assert_allclose(a.numpy(), b, rtol=tol,
                                   atol=tol * float(np.abs(b).max()),
                                   err_msg=name)


def _per_pair(out):
    """The per-pair rows of center_scale's results, padded rows cut."""
    return [tuple(x[b] for x in out) for b in range(out[2].shape[0])]


def _same(a, b, n_s, n_t) -> bool:
    s_a, t_a, *rest_a = a
    s_b, t_b, *rest_b = b
    return (torch.equal(s_a[:n_s], s_b[:n_s])
            and torch.equal(t_a[:n_t], t_b[:n_t])
            and all(torch.equal(x, y) for x, y in zip(rest_a, rest_b)))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_center_scale_bits_follow_neither_batch_nor_width(dtype):
    pl = _clouds()
    whole = _per_pair(cuda_prep.center_scale_plain(
        *_packed(pl, dtype), 3.0))
    ns = [len(s) for s, _ in pl]
    nt = [len(t) for _, t in pl]
    for size in (1, 2, 3):
        for b0 in range(0, len(pl), size):
            part = _per_pair(cuda_prep.center_scale_plain(
                *_packed(pl[b0:b0 + size], dtype), 3.0))
            for i, got in enumerate(part):
                b = b0 + i
                assert _same(got, whole[b], ns[b], nt[b]), (size, b)
    # two padded widths, the same valid rows (the padding not zero)
    src, n_src, tgt, n_tgt = _packed(pl, dtype)
    wide = [torch.cat([x, torch.full((x.shape[0], 768, 3), 9.0,
                                     dtype=x.dtype)], 1) for x in (src, tgt)]
    for b, got in enumerate(_per_pair(cuda_prep.center_scale_plain(
            wide[0], n_src, wide[1], n_tgt, 3.0))):
        assert _same(got, whole[b], ns[b], nt[b]), ("width", b)
        assert float(got[0][ns[b]:].abs().max()) == 0.0


def _poses(rng, shape):
    """Rigid transforms [*shape,4,4] from seed-made rotation vectors."""
    w = rng.normal(size=shape + (3,))
    th = np.linalg.norm(w, axis=-1, keepdims=True)
    k = w / th
    K = np.zeros(shape + (3, 3))
    K[..., 0, 1], K[..., 0, 2] = -k[..., 2], k[..., 1]
    K[..., 1, 0], K[..., 1, 2] = k[..., 2], -k[..., 0]
    K[..., 2, 0], K[..., 2, 1] = -k[..., 1], k[..., 0]
    s, c = np.sin(th)[..., None], np.cos(th)[..., None]
    T = np.zeros(shape + (4, 4))
    T[..., :3, :3] = np.eye(3) + s * K + (1 - c) * (K @ K)
    T[..., :3, 3] = rng.normal(size=shape + (3,)) * 2
    T[..., 3, 3] = 1.0
    return T


def _jax_to_original(T, cen_s, cen_t, scaling):
    """The JAX package's ``to_original`` closure of one pair's
    registration, its lines evaluated with jnp."""
    Rp = T[..., :3, :3]
    tp = T[..., :3, 3]
    t_orig = (tp / scaling - jnp.einsum("...ij,j->...i", Rp, cen_s)
              + cen_t)
    out = jnp.zeros_like(T).at[..., :3, :3].set(Rp)
    out = out.at[..., :3, 3].set(t_orig)
    return out.at[..., 3, 3].set(1.0)


def _jax_warm_start(T0, cen_s, cen_t, scaling):
    """The JAX package's warm start of one pair (l.617-620)."""
    R0 = T0[:3, :3]
    tp0 = (T0[:3, 3] + R0 @ cen_s - cen_t) * scaling
    return (jnp.zeros((4, 4), T0.dtype).at[:3, :3].set(R0)
            .at[:3, 3].set(tp0).at[3, 3].set(1.0))


def test_to_original_and_warm_start_agree_with_the_jax_package():
    rng = np.random.default_rng(15)
    bsz, hlen = 5, 4
    pre = reg.Preprocess(
        cen_s=torch.from_numpy(rng.normal(size=(bsz, 3)) * 5),
        cen_t=torch.from_numpy(rng.normal(size=(bsz, 3)) * 5),
        scaling=torch.from_numpy(rng.uniform(0.05, 3.0, bsz)))
    T = _poses(rng, (bsz,))
    hist = _poses(rng, (bsz, hlen))
    got = reg.to_original(torch.from_numpy(T), pre, True).numpy()
    got_h = reg.to_original(torch.from_numpy(hist), pre, True).numpy()
    warm = reg.warm_start(torch.from_numpy(T), pre, torch.float64).numpy()
    for b in range(bsz):
        c = [pre.cen_s[b].numpy(), pre.cen_t[b].numpy(),
             float(pre.scaling[b])]
        np.testing.assert_allclose(got[b], _jax_to_original(T[b], *c),
                                   rtol=0, atol=1e-12 * np.abs(got[b]).max())
        np.testing.assert_allclose(got_h[b], _jax_to_original(hist[b], *c),
                                   rtol=0,
                                   atol=1e-12 * np.abs(got_h[b]).max())
        np.testing.assert_allclose(warm[b], _jax_warm_start(T[b], *c),
                                   rtol=0, atol=1e-12 * np.abs(warm[b]).max())
    # each the other's inverse
    back = reg.to_original(torch.from_numpy(warm), pre, True).numpy()
    np.testing.assert_allclose(back, T, rtol=0, atol=1e-12 * np.abs(T).max())
    there = reg.warm_start(torch.from_numpy(got), pre, torch.float64).numpy()
    np.testing.assert_allclose(there, T, rtol=0, atol=1e-12 * np.abs(T).max())
    # and the icp modes pass the transform through
    Tt = torch.from_numpy(T)
    assert reg.to_original(Tt, pre, False) is Tt


def test_preprocess_takes_center_scale_for_the_se3_modes():
    src, n_src, tgt, n_tgt = _packed(_clouds()[:3], np.float32)
    h = reg.hyper(reg.split_cfg(GOLDEN, torch.float32, "cpu")[0])
    src_c, tgt_c, pre = reg.preprocess(src, n_src, tgt, n_tgt, GOLDEN,
                                       True, h)
    want = cuda_prep.center_scale_plain(src, n_src, tgt, n_tgt,
                                        h.scale_preprocessing)
    for a, b in zip((src_c, tgt_c, pre.cen_s, pre.cen_t, pre.scaling), want):
        assert torch.equal(a, b)
    # icp: no centring, padded rows 0
    src_c, _, pre = reg.preprocess(src, n_src, tgt, n_tgt, GOLDEN, False, h)
    assert torch.equal(pre.scaling, torch.ones(3))
    assert torch.equal(src_c[0, :300], src[0, :300])
    assert float(src_c[0, 300:].abs().max()) == 0.0


def _setup(pair_list):
    src, n_src, tgt, n_tgt = _packed(pair_list, np.float32)
    floats, scfg = reg.split_cfg(GOLDEN, torch.float32, "cpu")
    with torch.no_grad():
        return reg.setup(src, n_src, tgt, n_tgt, scfg, "se3", "pt2pl",
                         reg.hyper(floats))


def test_cpu_setup_gives_a_pair_the_same_bits_in_any_batch():
    probs = [fixtures.golden_shape_problem(seed=s, n=260 + 30 * s)
             for s in (1, 2, 3)]
    pl = [(p.source, p.target) for p in probs]
    whole, pre = _setup(pl)
    for i, p in enumerate(pl):
        one, pre1 = _setup([p])
        for a, b in ((whole.src_cT, one.src_cT), (whole.feat16, one.feat16),
                     (whole.targets.emb, one.targets.emb),
                     (whole.targets.payload, one.targets.payload),
                     (pre.cen_s, pre1.cen_s), (pre.scaling, pre1.scaling)):
            assert torch.equal(a[i], b[0])


# ---------------------------------------------------------------------
# The CPU route's whole registration and FGR, and the fixed-order sums

def _lane_sums_3(pts, n):
    """The three-column fixed-order sum as G4's plain version wrote it
    before ``lane_sums`` took any width: slabs of 256 rows from +0,
    then the halving tree."""
    bsz, width, _ = pts.shape
    x = torch.where(cuda_prep._valid(pts, n)[..., None], pts,
                    torch.zeros_like(pts))
    x = torch.nn.functional.pad(x, (0, 0, 0, -width % 256)).view(
        bsz, -1, 256, 3)
    acc = torch.zeros((bsz, 256, 3), dtype=pts.dtype)
    for k in range(x.shape[1]):
        acc = acc + x[:, k]
    while acc.shape[1] > 1:
        h = acc.shape[1] // 2
        acc = acc[:, :h] + acc[:, h:]
    return acc[:, 0]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_lane_sums_of_any_width_keep_the_three_column_bits(dtype):
    src, n_src, _, _ = _packed(_clouds(), dtype)
    assert torch.equal(cuda_prep.lane_sums(src, n_src),
                       _lane_sums_3(src, n_src))
    # a column's bits do not depend on the other columns, nor a row's
    # sub-rows on how many there are
    rng = np.random.default_rng(16)
    wide = torch.from_numpy(rng.normal(size=src.shape[:2] + (27,))
                            .astype(dtype)) * 5.0
    sums = cuda_prep.lane_sums(wide, n_src)
    for c in (0, 13, 26):
        assert torch.equal(cuda_prep.lane_sums(wide[..., c:c + 1], n_src),
                           sums[:, c:c + 1])
    sub = wide.view(*wide.shape[:2], 3, 9)
    mask = cuda_prep._valid(wide, n_src)
    for warp in (None, 32):
        got = cuda_prep.lane_sums(sub, mask, 512, warp)
        assert torch.equal(cuda_prep.lane_sums(sub[..., 4:5], mask, 512,
                                               warp), got[:, 4:5])


def _registered(pair_list, alg, dtype, cfg):
    src, n_src, tgt, n_tgt = _packed(pair_list, dtype)
    mode, variant = reg.parse_algorithm(alg)
    with torch.no_grad():
        T, it, pure, hist = reg.register_arrays(
            src, n_src, tgt, n_tgt, cfg, mode, variant, record_history=True)
    return [(T[b], it[b], pure[b], hist[b, :int(it[b])])
            for b in range(len(pair_list))]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("alg,overlap", [
    ("se3_pt2pl", 1.0), ("se3_gicp", 0.8), ("se3_pt2pt", 1.0),
    ("pt2pl", 1.0)], ids=["se3_pt2pl", "se3_gicp_trimmed", "se3_pt2pt",
                          "pt2pl"])
def test_cpu_registration_gives_a_pair_the_same_bits_in_any_batch(
        alg, overlap, dtype):
    """Three pairs registered together and one by one on the CPU route
    (the threshold setup, K4's and K5's plain versions, the
    component-wise step): each pair's transform, counts and history, bit
    for bit."""
    kw = fixtures.SMALL_POSE if alg == "pt2pl" else {}
    pl = [(p.source, p.target) for p in (
        fixtures.golden_shape_problem(seed=s, n=200 + 20 * s, **kw)
        for s in (1, 2, 3))]
    cfg = GOLDEN.replace(estimated_overlap=overlap)
    whole = _registered(pl, alg, dtype, cfg)
    for i, p in enumerate(pl):
        one = _registered([p], alg, dtype, cfg)[0]
        for a, b in zip(whole[i], one):
            assert torch.equal(a, b), (alg, i)


def test_fgr_gives_a_pair_the_same_bits_in_any_batch():
    """FGR on three golden-shape pairs of ~450 points on the CPU: each
    pair's transform and counts alone, in a batch of 2 and in a batch of
    3, bit for bit (the centroids of G4's fixed order, the Gauss-Newton
    sums in it, the component-wise solve)."""
    from se3_icp_tpu_torch.models import fgr
    pl = [(p.source, p.target) for p in (
        fixtures.golden_shape_problem(seed=s, n=440 + 10 * s)
        for s in (1, 2, 3))]
    cfg = fgr.FGRConfig(seed=16)

    def run(batch):
        st = {}
        T, _, _ = fgr.fgr_register_arrays(*_packed(batch, np.float32), cfg,
                                          stats=st)
        return [(T[b], st["reciprocal"][b], st["kept_correspondences"][b])
                for b in range(len(batch))]
    whole = run(pl)
    for size in (1, 2):
        part = [r for b0 in range(0, 3, size) for r in run(pl[b0:b0 + size])]
        for i, (a, b) in enumerate(zip(part, whole)):
            assert torch.equal(a[0], b[0]) and a[1:] == b[1:], (size, i)
