"""Several CPU processes over gloo (``tests/torch_scaleout_worker.py``,
one torch thread a rank, a timeout of its own a run): the 2-D (pairs,
points) layout of ``parallel/points.py`` on 2 x 2 ranks and
``parallel/multihost.py`` on 2 processes.

Held: ``register_batch_2d`` gives every rank the whole batch's results;
on the threshold route (float32) they are the unsharded
``register_batch``'s bits, on the exact route (float64) they equal the
JAX package's ``register_batch_2d`` over a 2 x 2 mesh of virtual devices
to 1e-8 with equal iteration counts.  ``register_pairs_multihost`` with
uneven per-process counts (3 and 1) and with one process holding none
(2 and 0) gives both processes the same list, process-major, equal bit
for bit to a single-process ``register_pairs`` of the whole list; with
FGR (one pair a process) to a single-process call of each process's
pair; every pair through the 2 deg / 0.25 gate.
"""

import numpy as np
import pytest
import torch

import torch_scaleout_worker as worker
from se3_icp_tpu_torch.models import fgr
from se3_icp_tpu_torch.parallel import pairs
from se3_icp_tpu_torch.utils import metrics_host
from se3_icp_tpu_torch.utils.config import RegistrationConfig

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    return worker.spawn("grid", 4, tmp_path_factory.mktemp("grid"))


@pytest.fixture(scope="module")
def multihost(tmp_path_factory):
    return worker.spawn("multihost", 2, tmp_path_factory.mktemp("hosts"))


def _batch(dtype):
    pl = [(p.source, p.target) for p in worker.grid_problems()]
    return pl, [torch.as_tensor(a) for a in pairs.pack_pairs(pl, dtype)]


def test_grid_gives_every_rank_the_whole_batch(grid):
    for key in ("thr", "exact_f64"):
        for rank in grid[1:]:
            for a, b in zip(rank[key], grid[0][key]):
                assert torch.equal(a, b), key
        assert grid[0][key][0].shape == (4, 4, 4)


def test_grid_threshold_route_gives_the_unsharded_bits(grid):
    _, batch = _batch(np.float32)
    want = pairs.register_batch(*batch, RegistrationConfig(**worker.BASE),
                                "se3_pt2pl", device="cpu")
    for a, b in zip(grid[0]["thr"], want):
        assert torch.equal(a, b)


def test_grid_exact_route_agrees_with_jax(grid):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from se3_icp_tpu.parallel import pairs as j_pairs
    from se3_icp_tpu.parallel import points as j_points
    from se3_icp_tpu.utils.config import RegistrationConfig as JaxConfig
    pl, _ = _batch(np.float64)
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                ("pairs", "points"))
    T, it, pure = (np.asarray(x) for x in j_points.register_batch_2d(
        *(jnp.asarray(a) for a in j_pairs.pack_pairs(pl, np.float64)),
        JaxConfig(**worker.BASE), "se3_pt2pl", mesh))
    got = grid[0]["exact_f64"]
    np.testing.assert_allclose(got[0].numpy(), T, atol=1e-8)
    assert got[1].tolist() == it.tolist()
    assert got[2].tolist() == pure.tolist()
    for p, Ti in zip(worker.grid_problems(), got[0].numpy()):
        assert metrics_host.success(p.T_gt, Ti)


@pytest.mark.parametrize("layout,n_pairs", [("uneven", 4), ("one_empty", 2),
                                            ("fgr", 2)])
def test_multihost_gives_both_processes_the_single_process_bits(
        multihost, layout, n_pairs):
    """ICP: the single-process call on the whole list.  FGR: its float32
    rounding on the CPU depends on the batch size (B = 1 against 2 moves
    a transform by ~1e-7), so each process's pair is held against a
    single-process call of that process's batch (one pair)."""
    probs = worker.multihost_problems()[:n_pairs]
    pl = [(p.source, p.target) for p in probs]
    if layout == "fgr":
        cfg = fgr.FGRConfig(seed=107)
        want = [r for pair in pl
                for r in pairs.register_pairs([pair], "fgr", cfg,
                                              device="cpu")]
    else:
        want = pairs.register_pairs(pl, "se3_pt2pl",
                                    RegistrationConfig(**worker.BASE),
                                    device="cpu")
    a, b = multihost[0][layout], multihost[1][layout]
    assert len(a) == len(b) == n_pairs
    for p, x, y, r in zip(probs, a, b, want):
        for got in (x, y):
            assert np.array_equal(got[0].numpy(), r.transformation)
            assert got[1:] == (r.num_iterations, r.num_pure_se3_iterations)
        assert metrics_host.success(p.T_gt, r.transformation)
