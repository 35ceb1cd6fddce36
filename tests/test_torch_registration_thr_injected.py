"""The port's threshold route with the JAX package's own K1 thresholds:
the JAX package's ``pallas_moments.neighborhood_thresholds_batched``
(interpret gate) stands in for the port's K1, and everything after it
-- K2, K3, the glue of ``ops/lrf.py``, the loop on K4/K5 -- is the
port's, on the CPU, in float32, against the JAX package's threshold
route (``SE3_ICP_TPU_FORCE_PALLAS=1 SE3_ICP_TPU_PALLAS_INTERPRET=1``).

Every pair passes the gate on both sides; iteration counts within 1 per
pair (measured: equal in 9 of the 10 pairs, 14 against 13 in the second
trimmed pair, whose stop rule, like all of them on these noiseless
clouds, compares MSEs at float32 noise level); transforms within
0.05 deg and 1e-3 (measured worst 1.6e-3 deg, 3.2e-5, in that same
pair; the others below 2e-5 deg).  Together with the K1 hold
(``test_torch_thresholds.py``) this holds the whole route; the full
route's own hold is in ``test_torch_registration_thr.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from se3_icp_tpu.ops import pallas_moments as pm

import torch_port_cases as cases
from se3_icp_tpu_torch.ops import cuda_moments
from se3_icp_tpu_torch.parallel import pairs
from se3_icp_tpu_torch.utils import metrics_host

# the suite runs several worker processes side by side: keep each
# one's torch thread pool small
torch.set_num_threads(1)


def _jax_k1(points, n_valid, counts, cloud=None, rows=None):
    assert rows is None             # the unsharded route: every row
    thr = pm.neighborhood_thresholds_batched(
        jnp.asarray(points.numpy()), jnp.asarray(n_valid.numpy(), jnp.int32),
        jnp.asarray(counts.numpy(), jnp.int32))
    return torch.as_tensor(np.array(thr))


@pytest.mark.parametrize(
    "case", [c for c in cases.CASES if c[0] in cases.F32_CASES],
    ids=cases.F32_CASES)
def test_threshold_route_on_jax_thresholds_matches_jax(case, monkeypatch):
    name, alg, ckw, kind, pkw = case
    probs = cases.problems(kind, pkw)
    pair_list = [(p.source, p.target) for p in probs]
    jcfg, cfg = cases.configs(ckw, 181 + cases.F32_CASES.index(name))
    j_res = cases.jax_threshold_route(pair_list, alg, jcfg)
    monkeypatch.setenv("SE3_ICP_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setattr(cuda_moments, "neighborhood_thresholds_batched",
                        _jax_k1)
    t_res = pairs.register_pairs(pair_list, alg, cfg, device="cpu")
    for p, a, b in zip(probs, j_res, t_res):
        assert metrics_host.success(p.T_gt, a.transformation)
        assert metrics_host.success(p.T_gt, b.transformation)
        assert abs(b.num_iterations - a.num_iterations) <= 1
        assert metrics_host.angular_error_so3(
            a.transformation[:3, :3], b.transformation[:3, :3]) < 0.05
        assert np.linalg.norm(a.transformation[:3, 3]
                              - b.transformation[:3, 3]) < 1e-3
