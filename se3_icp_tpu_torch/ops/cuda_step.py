"""The loop step's glue after the epilogue, as one kernel (G3).

What the JAX package's loop body (``models/registration.py``) does
between its fused epilogue and the next step's match, inside the XLA
program its TPU runs as one: the estimator's solve (pt2pl/GICP: the 6x6
normal equations, ``jnp.linalg.solve``, and Open3D's Euler-ZYX
retraction; pt2pt: the Kabsch rotation and its translation), the
identity on failure, ``T_i @ T``, the pose change, the stop and phase
switch tests, the done-masked update of the loop state and the history
row, and the next step's match affine ``W``, flags ``ph2`` and epilogue
scalars ``pf`` (``step_inputs_plain``).  No TPU kernel: XLA
fused it there; the port ran it as ~110 small torch ops a step.

``step_update_plain`` is that step written component-wise (one
elementwise torch op a step, in a fixed order, no ``torch.linalg``,
matrix product or reduction: ``ops/solve.py`` ``solve6_c``,
``euler_zyx_c``, ``kabsch3_c``); the CPU route runs it.
``step_update`` launches ``csrc/step_update.cu`` for tensors on the card,
one thread a pair, which repeats it operation for operation with every
float32 step rounded on its own (``__fmul_rn``/``__fadd_rn``/...,
``sinf``/``cosf``, no contraction into FMAs): the same bits as the plain
version on the card.  The kernel writes the state in place; it is
latency-bound (one pair's solve is a few hundred dependent operations)
and takes the place of ~110 launches a step.

A wrapper given CUDA tensors launches the kernel or raises; it runs the
plain version only for tensors on the CPU.
"""

from __future__ import annotations

import torch

from se3_icp_tpu_torch.ops import _build, cuda_loop, solve
from se3_icp_tpu_torch.ops.cuda_knn import _check

STATE = ("T", "it", "pure_it", "mse_prev", "mse_cur", "switched", "done")
# the traced floats the step reads, in the order of its [4] vector
HV = ("alpha_rot", "beta_transl", "estimated_overlap", "mse_switch_error")


def _safe(vals: list, ok: torch.Tensor) -> torch.Tensor:
    """ok & every entry of ``vals`` finite."""
    for v in vals:
        ok = ok & torch.isfinite(v)
    return ok


def _step_transform(A, b, st, variant: str):
    """The step's transform T_i as (R [3][3], t [3]) of [B] tensors,
    the identity where the solve fails."""
    wsum = st[:, 1]
    if variant == "pt2pt":
        ok = _safe([A[:, i, j] for i in range(3) for j in range(3)],
                   wsum > 2.5)
        R = solve.kabsch3_c(A[:, :3, :3])
        mu_s = [b[:, i] for i in range(3)]
        t = [b[:, 3 + i] - ((R[i][0] * mu_s[0] + R[i][1] * mu_s[1])
                            + R[i][2] * mu_s[2]) for i in range(3)]
    else:
        xi, ok = solve.solve6_c(A, [-b[:, i] for i in range(6)])
        ok = ok & (wsum > 5.5)
        R, t = solve.euler_zyx_c(xi)
    ok = _safe([v for row in R for v in row] + t, ok)
    one, zero = torch.ones_like(wsum), torch.zeros_like(wsum)
    R = [[torch.where(ok, R[i][j], one if i == j else zero)
          for j in range(3)] for i in range(3)]
    t = [torch.where(ok, v, zero) for v in t]
    return R, t


def _rows(T: torch.Tensor) -> list:
    return [[T[:, i, j] for j in range(4)] for i in range(4)]


def _stack44(M: list) -> torch.Tensor:
    return torch.stack([torch.stack(row, -1) for row in M], -2)


def step_inputs_plain(T, switched, done, hv, n_src_f, *, is_se3: bool,
                      do_trim: bool):
    """The operands of a step's match (K4) and epilogue (K5) at pose T
    [B,4,4], the one definition of them (``registration.
    iteration_inputs`` and the loop's first step call it; G3 repeats it):

      W [B,16,16]  the affine that turns ``feat16`` into the 12-D query:
                   q = feat16 @ W, from (R, t, alpha, beta, phase);
      ph2 [B,2]    int32 [phase, done]: done pairs skip the match
                   kernel's compute, their (unspecified) outputs are
                   discarded by the done-masked state update;
      pf [B,24]    the epilogue's scalars (``cuda_loop.PF_*`` layout).

    hv [4]: ``HV``; n_src_f [B]: the valid source counts as floats.
    Every entry is one elementwise product or copy, so the kernel's
    explicitly rounded copy gives its bits."""
    dt = T.dtype
    bsz = T.shape[0]
    R = T[:, :3, :3]
    tvec = T[:, :3, 3]
    Rt = R.mT
    swf = switched.to(dt)
    W = torch.zeros((bsz, 16, 16), dtype=dt, device=T.device)
    if is_se3:
        blk = ((1.0 - swf) * hv[0])[:, None, None] * Rt
        c_s = swf + (1.0 - swf) * hv[1]
        W[:, 0:3, 0:3] = blk
        W[:, 3:6, 3:6] = blk
        W[:, 6:9, 6:9] = blk
        W[:, 9:12, 9:12] = c_s[:, None, None] * Rt
    else:
        W[:, 9:12, 9:12] = Rt
    W[:, 12, 9:12] = tvec
    ph2 = torch.stack([switched, done], 1).to(torch.int32)
    pf = torch.zeros((bsz, cuda_loop.PF_WIDTH), dtype=dt, device=T.device)
    pf[:, cuda_loop.PF_T:cuda_loop.PF_T + 3] = tvec
    pf[:, cuda_loop.PF_BETA] = hv[1]
    pf[:, cuda_loop.PF_SWITCHED] = swf
    pf[:, cuda_loop.PF_NSRC] = n_src_f
    pf[:, cuda_loop.PF_COUNT] = (torch.floor(hv[2] * n_src_f) if do_trim
                                 else n_src_f)
    pf[:, cuda_loop.PF_R:cuda_loop.PF_R + 9] = R.reshape(bsz, 9)
    return W, ph2, pf


def step_update_plain(A, b, st, s: dict, hv, stop_thresh, n_src_f, *,
                      variant: str, is_se3: bool, hybrid: bool,
                      do_trim: bool, max_iters: int,
                      max_se3_iters: int) -> dict:
    """One step's update after the epilogue, component-wise.

    A [B,6,6], b [B,8], st [B,8]: the epilogue's outputs
    (``cuda_loop.loop_epilogue_batched``).  ``s``: the state (``STATE``
    keys; ``hist`` [B,H,4,4] or None).  hv [4]: alpha, beta, overlap and
    the switch threshold (``HV``); stop_thresh [B] (mse, scaled for the
    SE(3) modes); n_src_f [B] the valid source counts as floats.

    Returns the new state (``STATE`` keys and ``hist``) and the next
    step's ``W``, ``ph2``, ``pf``."""
    T = s["T"]
    it1 = s["it"] + 1
    mse_val = st[:, 0]
    Ri, ti = _step_transform(A, b, st, variant)
    mse_rel = (mse_val - s["mse_cur"]).abs()
    # T_new = T_i @ T; T's last row is (0, 0, 0, 1)
    Tc = _rows(T)
    new = [[None] * 4 for _ in range(3)]
    for i in range(3):
        for j in range(4):
            acc = ((Ri[i][0] * Tc[0][j] + Ri[i][1] * Tc[1][j])
                   + Ri[i][2] * Tc[2][j])
            new[i][j] = acc + ti[i] if j == 3 else acc
    one, zero = torch.ones_like(mse_val), torch.zeros_like(mse_val)
    new.append([zero, zero, zero, one])
    # the pose change |T - T_new|_F, a sum of 16 squares in row order
    t2 = None
    for i in range(4):
        for j in range(4):
            d = Tc[i][j] - new[i][j]
            t2 = d * d if t2 is None else t2 + d * d
    t_change = torch.sqrt(t2)

    # --- phase switch / stopping
    sw = s["switched"]
    stop = (it1 >= max_iters) | (mse_rel < stop_thresh)
    if hybrid:
        hit = (it1 >= max_se3_iters) | (t_change < hv[3])
        new_switched = sw | hit
        new_done = sw & stop
    else:
        new_switched = sw
        new_done = stop

    # --- done-masked state update
    active = ~s["done"]
    T_out = torch.where(active[:, None, None], _stack44(new), T)
    out = dict(
        T=T_out, it=torch.where(active, it1, s["it"]),
        pure_it=torch.where(active & ~sw, s["pure_it"] + 1, s["pure_it"]),
        mse_prev=torch.where(active, s["mse_cur"], s["mse_prev"]),
        mse_cur=torch.where(active, mse_val, s["mse_cur"]),
        switched=torch.where(active, new_switched, sw),
        done=s["done"] | new_done, hist=s.get("hist"))
    if out["hist"] is not None:
        # per-iteration accumulated transform; finished pairs write
        # their final T past their own num_iterations
        hist = out["hist"]
        row = (it1 - 1).clamp(max=hist.shape[1] - 1).to(torch.int64)
        ar = torch.arange(T.shape[0], device=T.device)
        out["hist"] = hist.index_put((ar, row), T_out)
    out["W"], out["ph2"], out["pf"] = step_inputs_plain(
        T_out, out["switched"], out["done"], hv, n_src_f, is_se3=is_se3,
        do_trim=do_trim)
    return out


def step_update(A, b, st, s: dict, hv, stop_thresh, n_src_f, *,
                variant: str, is_se3: bool, hybrid: bool, do_trim: bool,
                max_iters: int, max_se3_iters: int) -> dict:
    """One step's update after the epilogue (``step_update_plain``'s
    arguments and results).  On the card the kernel writes the new state,
    the history row and the next ``W``, ``ph2``, ``pf`` IN PLACE into
    the tensors of ``s`` (which then holds ``W``, ``ph2`` and ``pf``
    too) and returns them.  ``variant``: pt2pt, pt2pl or gicp."""
    if variant not in cuda_loop._VARIANT_CODE:
        raise ValueError(f"Invalid ICP variant name: {variant!r}")
    T = s["T"]
    if not T.is_cuda:
        return step_update_plain(
            A, b, st, s, hv, stop_thresh, n_src_f, variant=variant,
            is_se3=is_se3, hybrid=hybrid, do_trim=do_trim,
            max_iters=max_iters, max_se3_iters=max_se3_iters)
    bsz = T.shape[0]
    dev, f32, i32 = T.device, torch.float32, torch.int32
    for name, x, shape, dtype in (
            ("A", A, (bsz, 6, 6), f32), ("b", b, (bsz, 8), f32),
            ("st", st, (bsz, 8), f32), ("T", T, (bsz, 4, 4), f32),
            ("it", s["it"], (bsz,), i32), ("pure_it", s["pure_it"], (bsz,),
                                           i32),
            ("mse_prev", s["mse_prev"], (bsz,), f32),
            ("mse_cur", s["mse_cur"], (bsz,), f32),
            ("switched", s["switched"], (bsz,), torch.bool),
            ("done", s["done"], (bsz,), torch.bool),
            ("W", s["W"], (bsz, 16, 16), f32),
            ("ph2", s["ph2"], (bsz, 2), i32),
            ("pf", s["pf"], (bsz, cuda_loop.PF_WIDTH), f32),
            ("hv", hv, (len(HV),), f32),
            ("stop_thresh", stop_thresh, (bsz,), f32),
            ("n_src_f", n_src_f, (bsz,), f32)):
        _check(x, name, shape, dtype, dev)
    hist = s.get("hist")
    hist_len = 0
    if hist is not None:
        hist_len = hist.shape[1]
        _check(hist, "hist", (bsz, hist_len, 4, 4), f32, dev)
    args = (A.data_ptr(), b.data_ptr(), st.data_ptr(), T.data_ptr(),
            s["it"].data_ptr(), s["pure_it"].data_ptr(),
            s["mse_prev"].data_ptr(), s["mse_cur"].data_ptr(),
            s["switched"].data_ptr(), s["done"].data_ptr(),
            None if hist is None else hist.data_ptr(), s["W"].data_ptr(),
            s["ph2"].data_ptr(), s["pf"].data_ptr(), hv.data_ptr(),
            stop_thresh.data_ptr(), n_src_f.data_ptr(), bsz, hist_len,
            int(variant == "pt2pt"), int(is_se3), int(hybrid),
            int(do_trim), int(max_iters), int(max_se3_iters))
    code = _build.launch(_build.load().se3icp_step_update, dev, *args)
    _build.check(code, "step_update")
    _build.count_launch("step_update", dev)
    return dict({k: s[k] for k in STATE}, hist=hist, W=s["W"],
                ph2=s["ph2"], pf=s["pf"])
