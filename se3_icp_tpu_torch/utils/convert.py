"""State carried across from the JAX package.

This system has no weights; what crosses from one package to the other
is the configuration and the SETUP PRODUCTS of a registration (frames,
normals, covariances).  Nothing here imports the other package: the
caller hands over plain dicts and numpy arrays, e.g.
``dataclasses.asdict`` of its config and the outputs of its
``lrf.toldi_frames_dense`` / ``normals_dense`` /
``gicp_covariances_dense``.  With the same setup on both sides, the two
loops -- and the two pairs of loop kernels -- can be held against each
other step for step.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from se3_icp_tpu_torch.models.registration import (MatchState, hyper,
                                                   pack_match_state,
                                                   split_cfg)
from se3_icp_tpu_torch.utils.config import RegistrationConfig


def config_from_dict(d: dict) -> RegistrationConfig:
    """``RegistrationConfig`` from a field dict (``dataclasses.asdict``
    of the other package's config).  Unknown keys raise: a field this
    port does not know would otherwise be dropped silently."""
    known = {f.name for f in dataclasses.fields(RegistrationConfig)}
    unknown = sorted(set(d) - known)
    if unknown:
        raise ValueError(f"unknown config fields: {unknown}")
    return RegistrationConfig(**d)


def match_state_from_numpy(src_c, tgt_c, n_src, n_tgt,
                           cfg: RegistrationConfig, mode: str, variant: str,
                           *, rot_src=None, rot_tgt=None, tgt_normals=None,
                           cov_src6=None, cov_tgt6=None, conf_src=None,
                           conf_tgt=None, dtype=torch.float32,
                           device="cpu") -> MatchState:
    """Turn numpy setup products into the loop's ``MatchState``
    (``feat16``, dual-phase targets, payload).

    All arrays are batched: src_c/tgt_c [B,N,3] centred+scaled padded
    clouds, n_src/n_tgt [B]; rot_* [B,N,3,3] TOLDI frames with columns
    x,y,z (SE(3) modes); tgt_normals [B,Nt,3] (pt2pl); cov_*6 [B,6,N]
    symmetric components xx,xy,xz,yy,yz,zz (gicp); conf_* [B,N]
    (with_cf)."""
    def t(a, dt=dtype):
        return None if a is None else torch.as_tensor(
            np.asarray(a), device=device).to(dt)

    return pack_match_state(
        t(src_c), t(tgt_c), t(n_src, torch.int32), t(n_tgt, torch.int32),
        cfg, mode, variant, h=hyper(split_cfg(cfg, dtype, device)[0]),
        rot_src=t(rot_src), rot_tgt=t(rot_tgt),
        tgt_normals=t(tgt_normals), cov_src6=t(cov_src6),
        cov_tgt6=t(cov_tgt6), conf_src=t(conf_src), conf_tgt=t(conf_tgt))
