"""The points route (``parallel/points.py``): one registration's rows
sharded over a gloo group of 2 and of 4 CPU processes
(``tests/torch_scaleout_worker.py``, one torch thread a rank, a timeout
of its own), against the port's unsharded registration and the JAX
package's ``register_pair_model_parallel``.

Held: every rank returns the same result; on the threshold route
(float32) each of ``se3_pt2pl``, ``se3_gicp``, ``pt2pl`` and
``se3_pt2pl`` trimmed to 0.75 gives the unsharded ``register_pair``'s
bits (transform, iterations, pure iterations); on the exact route in
float64 the result equals the JAX package's points route over the same
number of virtual devices to 1e-8 with equal iteration counts, and the
port's unsharded exact route bit for bit; a padded width the group does
not divide raises, and so does a gloo group asked to serve CUDA tensors;
the captured program's body (``program._program``) with every group of
steps run on the group gives the eager points route's bits
(``se3_pt2pt``: the rotation from ``solve.kabsch3``).
"""

import numpy as np
import pytest
import torch

import torch_scaleout_worker as worker
from se3_icp_tpu_torch.models import registration as reg
from se3_icp_tpu_torch.utils import metrics_host
from se3_icp_tpu_torch.utils.config import RegistrationConfig

torch.set_num_threads(1)


@pytest.fixture(scope="module", params=[2, 4], ids=["R2", "R4"])
def ranks(request, tmp_path_factory):
    """(world, [each rank's results]) of one spawned run."""
    world = request.param
    return world, worker.spawn("points", world,
                               tmp_path_factory.mktemp("points"))


def _same(a, b):
    return (torch.equal(a[0], b[0]) and a[1] == b[1] and a[2] == b[2])


def test_every_rank_returns_the_same_result(ranks):
    _, got = ranks
    for key in got[0]:
        if key == "refused":
            continue
        for other in got[1:]:
            assert _same(other[key], got[0][key]), key


@pytest.mark.parametrize("case", worker.THR_CASES,
                         ids=[c[0] for c in worker.THR_CASES])
def test_threshold_route_gives_the_unsharded_bits(ranks, case):
    _, got = ranks
    name, alg, ckw, pkw = case
    p = worker.problem(**pkw)
    ref = reg.register_pair(p.source, p.target, alg,
                            RegistrationConfig(**{**worker.BASE, **ckw}),
                            device="cpu")
    assert _same(got[0][name], (torch.as_tensor(ref.transformation),
                                ref.num_iterations,
                                ref.num_pure_se3_iterations))


def test_exact_route_agrees_with_jax_points_route(ranks):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from se3_icp_tpu.parallel import points as j_points
    from se3_icp_tpu.utils.config import RegistrationConfig as JaxConfig
    world, got = ranks
    p = worker.problem()
    T, it, pure = got[0]["exact_f64"]
    mesh = Mesh(np.asarray(jax.devices()[:world]), ("points",))
    want = j_points.register_pair_model_parallel(
        p.source, p.target, worker.EXACT_ALGORITHM,
        JaxConfig(**worker.BASE), mesh=mesh, dtype=jnp.float64)
    np.testing.assert_allclose(T.numpy(), want.transformation, atol=1e-8)
    assert it == want.num_iterations
    assert pure == want.num_pure_se3_iterations
    assert metrics_host.success(p.T_gt, T.numpy())
    ref = reg.register_pair(p.source, p.target, worker.EXACT_ALGORITHM,
                            RegistrationConfig(**worker.BASE),
                            dtype=torch.float64, device="cpu",
                            exact_knn=True)
    assert _same((T, it, pure), (torch.as_tensor(ref.transformation),
                                 ref.num_iterations,
                                 ref.num_pure_se3_iterations))


def test_the_route_refuses_what_it_cannot_shard(ranks):
    world, got = ranks
    refused = got[0]["refused"]
    assert refused["width"] == (
        f"padded cloud size 513 must be divisible by the points group's "
        f"size {world}")
    assert "needs a nccl process group" in refused["cuda_on_gloo"]


def test_program_body_gives_the_eager_points_route_bits(ranks):
    _, got = ranks
    body, eager = got[0]["program_body"], got[0]["program_body_eager"]
    assert _same(body, eager)
    assert body[3] == max(worker.BASE["max_num_iterations"],
                          worker.BASE["max_num_se3_iterations"]) + 1
