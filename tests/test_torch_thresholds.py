"""K1 of the PyTorch port, the sort-free neighbourhood thresholds
(``ops/cuda_moments.neighborhood_thresholds_batched``, plain version on
the CPU), against the JAX package's ``pallas_moments.
neighborhood_thresholds_batched`` run through its callback-free
interpret gate (``SE3_ICP_TPU_PALLAS_INTERPRET=1``).

The port computes its distances in plain float32 and the JAX package in
limb-packed bf16 products, so candidates differ in the last bit and
thresholds are not bit-equal (that is asked of the kernel against its
plain version, on the card).  Both must meet the count contract of
``tests/test_thr.py`` on exact float64 distances, and the per-row ball
counts of the two must agree in the median.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from se3_icp_tpu.ops import pallas_moments as pm

import torch_port_cases as cases
from se3_icp_tpu_torch.ops import cuda_moments as cm

# the suite runs several worker processes side by side: keep each
# one's torch thread pool small
torch.set_num_threads(1)

COUNTS = [20, 30, 31, 90]


def _jax_thresholds(monkeypatch, pts, nv, counts):
    monkeypatch.setenv("SE3_ICP_TPU_PALLAS_INTERPRET", "1")
    return np.asarray(pm.neighborhood_thresholds_batched(
        jnp.asarray(pts), jnp.asarray(nv), jnp.asarray(counts)))


@pytest.mark.parametrize("n,n_valid,slack", [
    (512, (512, 400), 0),
    (1536, (1536, 1300), 40),
])
def test_thresholds_meet_the_count_contract_like_jax(n, n_valid, slack,
                                                     monkeypatch):
    """min >= c-2, max <= c+slack+4, median <= c+slack+2 (slack: the
    lane-collision loss of the 512-lane fold, none at N=512); the port's
    and the JAX package's per-row counts differ by 0 in the median."""
    pts, nv = cases.normal_clouds(n, n, n_valid)
    counts = np.asarray([COUNTS] * len(nv), np.int32)
    thr = cm.neighborhood_thresholds_batched(
        torch.as_tensor(pts), torch.as_tensor(nv), torch.as_tensor(counts))
    assert thr.shape == (len(nv), len(COUNTS), n)
    assert thr.dtype == torch.float32
    jthr = _jax_thresholds(monkeypatch, pts, nv, counts)
    for b, v in enumerate(nv):
        d2 = cases.exact_d2(pts[b], v)
        for t, c in enumerate(COUNTS):
            got = (d2 <= thr[b, t, :v].double().numpy()[:, None]).sum(1)
            jgot = (d2 <= jthr[b, t, :v][:, None]).sum(1)
            for g in (got, jgot):
                assert g.min() >= c - 2, (n, c, g.min())
                assert g.max() <= c + slack + 4, (n, c, g.max())
                assert np.median(g) <= c + slack + 2, (n, c)
            assert np.median(np.abs(got - jgot)) == 0, (n, c)


def test_counts_above_n_valid_clamp_to_every_valid_point(monkeypatch):
    """count 90 > n_valid 50: the ball holds every valid point, as the
    JAX package's does."""
    pts, nv = cases.normal_clouds(3, 512, (50, 512))
    counts = np.asarray([[90, 20]] * 2, np.int32)
    thr = cm.neighborhood_thresholds_batched(
        torch.as_tensor(pts), torch.as_tensor(nv),
        torch.as_tensor(counts)).numpy()
    jthr = _jax_thresholds(monkeypatch, pts, nv, counts)
    d2 = cases.exact_d2(pts[0], 50)
    for th in (thr, jthr):
        got = (d2 <= th[0, 0, :50, None] * (1 + 1e-6)).sum(1)
        assert got.min() == 50
        assert (d2 <= th[0, 1, :50, None]).sum(1).max() < 50


def test_counts_keep_the_callers_order():
    """The wrapper sorts the counts descending for the search and puts
    the rows back in the caller's order; unsorted, repeated and sorted
    count lists give the same rows."""
    pts, nv = cases.normal_clouds(5, 512, (480,))
    t = torch.as_tensor
    ref = cm.neighborhood_thresholds_batched(
        t(pts), t(nv), t(np.asarray([[90, 31, 30, 20]], np.int32)))
    mixed = cm.neighborhood_thresholds_batched(
        t(pts), t(nv), t(np.asarray([[30, 90, 20, 31]], np.int32)))
    torch.testing.assert_close(mixed, ref[:, [2, 0, 3, 1]], rtol=0, atol=0)
    # a count that is repeated gives the same row twice
    rep = cm.neighborhood_thresholds_batched(
        t(pts), t(nv), t(np.asarray([[31, 31]], np.int32)))
    torch.testing.assert_close(rep[:, 0], rep[:, 1], rtol=0, atol=0)
    # the shared operands give the same bits as building them inside
    cloud = cm.setup_cloud(t(pts), t(nv))
    again = cm.neighborhood_thresholds_batched(
        t(pts), t(nv), t(np.asarray([[90, 31, 30, 20]], np.int32)),
        cloud=cloud)
    torch.testing.assert_close(again, ref, rtol=0, atol=0)
    with pytest.raises(ValueError):
        cm.neighborhood_thresholds_batched(
            t(pts), t(nv), t(np.arange(1, 10, dtype=np.int32)[None]))


def test_plain_version_is_the_wrapper_on_the_cpu():
    """``neighborhood_thresholds_plain`` is what the wrapper runs for CPU
    tensors (the card compares its kernel with it), including clouds
    whose width is no multiple of the 512 candidate lanes."""
    pts, nv = cases.normal_clouds(6, 700, (700, 650))
    t = torch.as_tensor
    counts = t(np.asarray([COUNTS] * 2, np.int32))
    a = cm.neighborhood_thresholds_batched(t(pts), t(nv), counts)
    b = cm.neighborhood_thresholds_plain(t(pts), t(nv), counts)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert cm.plan(4) == (16, 9, 6, 8)
