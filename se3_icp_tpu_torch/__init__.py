"""se3_icp_tpu_torch: the PyTorch/CUDA port of the SE(3)-ICP
point-cloud registration engine ("A Generalization of Iterative Closest
Point Registration Algorithms using a Local Reference Frame based SE(3)
Augmentation", kenahm/se3-icp).

Plain tensor code is PyTorch, natively batched over pairs; the kernels
-- the threshold setup (``ops/cuda_moments.py``), the fused
correspondence match and loop epilogue of the iteration loop
(``ops/cuda_knn.py``, ``ops/cuda_loop.py``) and the exact 1-NN searches
of multistart scoring, FGR matching and the metrics (``ops/cuda_nn.py``)
-- are hand-written CUDA C++ for sm_90a (``csrc/``), built at first use
(``ops/_build.py``).  Entry points run on the CUDA device unless the
caller passes ``device="cpu"``, where each kernel's plain PyTorch
version runs instead (float64 allowed).

This package imports torch, numpy and scipy only; it shares no module
with the JAX package ``se3_icp_tpu`` that it was ported from.
"""

from se3_icp_tpu_torch.utils.config import GOLDEN, RegistrationConfig

__version__ = "0.1.0"


def __getattr__(name):
    # late imports so that utils/ops stay importable standalone
    if name in ("RegistrationResult", "register_pair", "register_arrays",
                "sanitize_cloud"):
        from se3_icp_tpu_torch.models import registration
        return getattr(registration, name)
    if name in ("register_pairs", "register_pairs_async", "PendingBatch",
                "register_batch", "pack_pairs", "pack_clouds",
                "default_mesh"):
        from se3_icp_tpu_torch.parallel import pairs
        return getattr(pairs, name)
    if name in ("register_pair_multistart", "register_pairs_multistart"):
        from se3_icp_tpu_torch.models import multistart
        return getattr(multistart, name)
    if name == "fgr_register":
        from se3_icp_tpu_torch.models import fgr
        return fgr.fgr_register
    if name in ("read_ply", "write_ply"):
        from se3_icp_tpu_torch.utils import ply
        return getattr(ply, name)
    raise AttributeError(name)


__all__ = [
    "RegistrationConfig", "GOLDEN",
    "RegistrationResult", "register_pair", "register_arrays",
    "sanitize_cloud",
    "register_pairs", "register_pairs_async", "PendingBatch",
    "register_batch", "pack_pairs", "pack_clouds", "default_mesh",
    "register_pair_multistart", "register_pairs_multistart",
    "fgr_register",
    "read_ply", "write_ply",
    "__version__",
]
