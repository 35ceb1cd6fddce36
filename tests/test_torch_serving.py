"""The serving surface of ``parallel/pairs.py`` on the CPU: the
vectorised packing against the JAX package's numpy packing and the
cloud-by-cloud packing it replaces, the memoised upload
(``_device_clouds``), the on-device bucket padding and
``register_pairs_async`` / ``PendingBatch``, the last against the JAX
package's own ``register_pairs_async`` on its threshold route through
the callback-free interpret gate, at the tolerances of
``test_torch_registration_thr.py`` (counts within 2 a pair, transforms
within 0.05 deg and 1e-3).  The same surface on the card, with the
captured program behind it, is in ``test_torch_gpu_program.py``.
"""

import gc

import numpy as np
import pytest
import torch

import torch_port_cases as cases
from se3_icp_tpu.parallel import pairs as j_pairs
from se3_icp_tpu_torch.models import registration as reg
from se3_icp_tpu_torch.parallel import pairs
from se3_icp_tpu_torch.utils import metrics_host
from se3_icp_tpu_torch.utils.config import GOLDEN

torch.set_num_threads(1)


def _clouds(dtype, seed=5):
    """Clouds of 300-700 rows with NaN and inf rows, an empty cloud and
    one of a single row; the largest cloud has no non-finite row, so
    both packers take the same width."""
    rng = np.random.default_rng(seed)
    out = []
    for n in (517, 300, 0, 700, 1, 450):
        c = rng.normal(size=(n, 3)).astype(dtype)
        if n not in (0, 1, 700):
            c[rng.choice(n, 7, replace=False), rng.integers(0, 3, 7)] = np.nan
            c[rng.choice(n, 3, replace=False), 1] = -np.inf
        out.append(c)
    return out


def _old_pack(clouds, dtype, bucket=512):
    """The port's cloud-by-cloud packing before the vectorised one."""
    raw = [reg.sanitize_cloud(c) for c in clouds]
    width = reg._bucket(max(len(c) for c in raw), bucket)
    out = np.zeros((len(raw), width, 3), dtype)
    counts = np.zeros(len(raw), np.int32)
    for i, c in enumerate(raw):
        out[i, :len(c)] = c
        counts[i] = len(c)
    return out, counts


def _jax_numpy_pack(clouds, dtype, pad, monkeypatch):
    from se3_icp_tpu.utils import native
    monkeypatch.setattr(native, "pack_pairs_f32", lambda *a, **k: None)
    return j_pairs.pack_clouds(clouds, dtype, pad=pad)


def _same_arrays(a, b):
    assert a[0].dtype == b[0].dtype and a[0].shape == b[0].shape
    assert a[0].tobytes() == b[0].tobytes()
    np.testing.assert_array_equal(a[1], b[1])


@pytest.mark.parametrize("in_dtype", [np.float64, np.float32])
@pytest.mark.parametrize("pad", ["bucket", "max"])
@pytest.mark.parametrize("out_dtype", [np.float32, np.float64])
def test_pack_clouds_keeps_the_bits_of_both_packers(in_dtype, pad,
                                                    out_dtype, monkeypatch):
    clouds = _clouds(in_dtype)
    got = pairs.pack_clouds(clouds, out_dtype, pad=pad)
    _same_arrays(got, _jax_numpy_pack(clouds, out_dtype, pad, monkeypatch))
    if pad == "bucket":
        _same_arrays(got, _old_pack(clouds, out_dtype))
    assert got[1].tolist() == [int(np.isfinite(c).all(1).sum())
                               for c in clouds]
    assert min(got[1][[0, 1, 5]] - [517, 300, 450]) < 0    # rows dropped
    assert got[0].shape[1] == (1024 if pad == "bucket" else 700)


def test_pack_clouds_takes_the_width_before_dropping_rows(monkeypatch):
    """As the JAX package: the width comes from the clouds' row counts,
    non-finite rows included (the old port packer took it after)."""
    c = np.zeros((520, 3))
    c[:10] = np.nan
    got = pairs.pack_clouds([c, np.ones((5, 3))])
    _same_arrays(got, _jax_numpy_pack([c, np.ones((5, 3))], np.float32,
                                      "bucket", monkeypatch))
    assert got[0].shape == (2, 1024, 3) and got[1].tolist() == [510, 5]
    assert _old_pack([c, np.ones((5, 3))], np.float32)[0].shape[1] == 512


def test_device_clouds_memoise_uploads(monkeypatch):
    """A repeated side (scan-to-model serving) is the same device
    tensors, fresh arrays miss; an entry whose arrays were collected is
    dropped, and SE3_ICP_TPU_NO_CLOUD_CACHE=1 turns the memo off (JAX
    ``tests/test_parallel.py``, ``test_device_cloud_cache_reuses_uploads``)."""
    monkeypatch.delenv("SE3_ICP_TPU_NO_CLOUD_CACHE", raising=False)
    pairs._cloud_cache.clear()
    tgts = _clouds(np.float64, seed=1)[:2]
    srcs1 = _clouds(np.float64, seed=2)[:2]
    srcs2 = [s + 1e-5 for s in srcs1]
    d_t1, n_t1 = pairs._device_clouds(tgts, np.float32, "cpu")
    d_s1, _ = pairs._device_clouds(srcs1, np.float32, "cpu")
    d_t2, n_t2 = pairs._device_clouds(tgts, np.float32, "cpu")
    d_s2, _ = pairs._device_clouds(srcs2, np.float32, "cpu")
    assert d_t2 is d_t1 and n_t2 is n_t1      # identical side: a hit
    assert d_s2 is not d_s1                   # fresh arrays: a miss
    packed, counts = pairs.pack_clouds(tgts, np.float32, pad="max")
    assert torch.equal(d_t1, torch.from_numpy(packed))
    assert n_t1.dtype == torch.int32 and n_t1.tolist() == counts.tolist()
    # another batch dtype is another entry
    assert pairs._device_clouds(tgts, np.float64, "cpu")[0] is not d_t1

    # collected arrays: the entry's weakrefs die and a later lookup under
    # the same key (ids are reused) uploads afresh
    gone = [c.copy() for c in tgts]
    key = pairs._cloud_cache_key(gone, np.float32, torch.device("cpu"))
    d_g, _ = pairs._device_clouds(gone, np.float32, "cpu")
    del gone
    gc.collect()
    assert all(r() is None for r in pairs._cloud_cache[key][0])
    monkeypatch.setattr(pairs, "_cloud_cache_key", lambda *a: key)
    d_new, _ = pairs._device_clouds(tgts, np.float32, "cpu")
    assert d_new is not d_g and torch.equal(d_new, d_t1)
    monkeypatch.undo()

    monkeypatch.setenv("SE3_ICP_TPU_NO_CLOUD_CACHE", "1")
    assert pairs._device_clouds(tgts, np.float32, "cpu")[0] is not d_t1
    assert pairs._cloud_cache_key(tgts, np.float32, "cpu") is None


def test_register_batch_pads_max_padded_input_to_the_bucket():
    """JAX ``test_pad_max_upload_matches_bucket_packed``: clouds padded
    only to the batch's largest count register as bucket-packed ones."""
    probs = cases.problems("bumpy", {})
    pair_list = [(p.source, p.target) for p in probs]
    cfg = GOLDEN.replace(max_num_iterations=40)
    m = [torch.as_tensor(a) for a in pairs.pack_pairs(pair_list, pad="max")]
    b = [torch.as_tensor(a) for a in pairs.pack_pairs(pair_list)]
    assert m[0].shape[1] < b[0].shape[1] == 512
    assert torch.equal(pairs._pad_to_bucket(m[0]), b[0])
    out_m = pairs.register_batch(*m, cfg, "se3_pt2pl", device="cpu")
    out_b = pairs.register_batch(*b, cfg, "se3_pt2pl", device="cpu")
    for x, y in zip(out_m, out_b):
        assert torch.equal(x, y)


def test_register_pairs_async_holds_register_pairs_and_jax():
    probs = cases.problems("bumpy", {})
    pair_list = [(p.source, p.target) for p in probs]
    jcfg, cfg = cases.configs({}, 177)
    stats = {}
    pending = pairs.register_pairs_async(pair_list, "se3_pt2pl", cfg,
                                         device="cpu", stats=stats)
    assert isinstance(pending, pairs.PendingBatch)
    got = pending.result()
    assert pending.result() is got
    assert stats["loop_steps"] >= max(r.num_iterations for r in got)
    ref = pairs.register_pairs(pair_list, "se3_pt2pl", cfg, device="cpu")
    for a, b in zip(got, ref):
        assert np.array_equal(a.transformation, b.transformation)
        assert (a.num_iterations, a.num_pure_se3_iterations) == (
            b.num_iterations, b.num_pure_se3_iterations)
    from se3_icp_tpu.ops import knn as j_knn
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SE3_ICP_TPU_FORCE_PALLAS", "1")
        mp.setenv("SE3_ICP_TPU_PALLAS_INTERPRET", "1")
        mp.delenv("SE3_ICP_TPU_NO_THR_KNN", raising=False)
        mp.delenv("SE3_ICP_TPU_EXACT_KNN", raising=False)
        assert j_knn.use_fused_match() and j_knn.use_thr_knn()
        j_res = j_pairs.register_pairs_async(pair_list, "se3_pt2pl", jcfg,
                                             mesh=None).result()
    for p, a, b in zip(probs, j_res, got):
        assert metrics_host.success(p.T_gt, a.transformation)
        assert metrics_host.success(p.T_gt, b.transformation)
        assert abs(b.num_iterations - a.num_iterations) <= 2
        assert metrics_host.angular_error_so3(
            a.transformation[:3, :3], b.transformation[:3, :3]) < 0.05
        assert np.linalg.norm(a.transformation[:3, 3]
                              - b.transformation[:3, 3]) < 1e-3


def test_the_package_exports_the_async_surface():
    import se3_icp_tpu_torch as pkg
    assert pkg.register_pairs_async is pairs.register_pairs_async
    assert pkg.PendingBatch is pairs.PendingBatch
    assert {"register_pairs_async", "PendingBatch"} <= set(pkg.__all__)


@pytest.mark.parametrize("kind", ["overflow", "int64", "float16"])
def test_pack_clouds_rows_past_float32_and_other_input_types(kind,
                                                             monkeypatch):
    """A float64 row that the float32 cast overflows is finite, so it is
    kept (as inf), as the float64 pass keeps it; integer and float16
    clouds go through float64 as before."""
    rng = np.random.default_rng(3)
    clouds = [rng.normal(size=(40, 3)), rng.normal(size=(30, 3))]
    if kind == "overflow":
        clouds[0][3, 1] = 1e39
        clouds[1][4] = np.nan
    else:
        clouds = [(c * 1000).astype(kind) for c in clouds]
        if kind == "float16":
            clouds[1][4, 0] = np.inf
    got = pairs.pack_clouds(clouds)
    _same_arrays(got, _old_pack(clouds, np.float32))
    _same_arrays(got, _jax_numpy_pack(clouds, np.float32, "bucket",
                                      monkeypatch))
    if kind == "overflow":
        assert got[1].tolist() == [40, 29] and np.isinf(got[0][0, 3, 1])
