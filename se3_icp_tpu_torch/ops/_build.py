"""Builds and loads the hand-written CUDA kernels.

The sources under ``csrc/`` (``*.cu``, and the ``*.cuh`` headers they
include) are compiled with ``nvcc`` for ``sm_90a`` into ONE shared
library with a plain C interface, loaded with ``ctypes``; no PyTorch
header is involved, so the build takes seconds.  It happens at first
use, from the sources in the package and nothing else, into
``<package>/build/`` (git-ignored).  The library's name carries a hash
of sources, headers and flags, so an edited file rebuilds and an
unchanged one is reused, also by a second process.

A missing ``nvcc`` or a failing build raises: nothing here gives way to
a kernel's plain version.

Each exported C function that launches a kernel launches it on the
stream it is handed, allocates nothing and returns
``cudaGetLastError()``; ``check`` turns a non-zero code into an
exception.  ``se3icp_nn_tiled_smem`` launches nothing: it returns the
tiled 1-NN search's shared memory a block, for the card checks' report.

Launch counts live on the card: each kernel wrapper calls
``count_launch`` right beside its launch, which adds one to the
wrapper's slot of a small int64 vector on the launching stream.  A
captured CUDA graph holds that addition next to the launch, so every
replay counts what it ran, and a conditional body counts only when it
runs.  ``launches`` reads the counts back, ``zero_launches`` clears
them.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
# name -> argtypes; every function returns an int: the cudaError_t of its
# launch, or (``se3icp_nn_tiled_smem``) a size
SIGNATURES = {
    # feat, w, emb, tn, payload, n_tgt, phase, d2, matchedT,
    # B, Nq, Nt, P, stream
    "se3icp_match_affine": [_P] * 9 + [_I] * 4 + [_P],
    # srcT, matchedT, pf, cov6, conf, A, b, st,
    # B, N, P, variant, is_se3, use_cf, do_trim,
    # off_tr, off_nrm, off_cov, off_conf, isteps, cluster, stream
    "se3icp_loop_epilogue": [_P] * 8 + [_I] * 13 + [_P],
    # pts_t, tn, n_valid, counts, hib, out, B, N, T, stream
    "se3icp_thresholds": [_P] * 6 + [_I] * 3 + [_P],
    # pts_t, tn, n_valid, counts, hib, out, B, N, q0, nq, T, stream
    "se3icp_thresholds_rows": [_P] * 6 + [_I] * 5 + [_P],
    # pts_t, tn, n_valid, order, thr_s, out, B, N, balls, stream
    "se3icp_moments": [_P] * 6 + [_I] * 3 + [_P],
    # pts_t, tn, n_valid, order, thr_s, out, B, N, q0, nq, balls, stream
    "se3icp_moments_rows": [_P] * 6 + [_I] * 5 + [_P],
    # pts_t, tn, n_valid, order, normal_t, aux, out, B, N, stream
    "se3icp_axis": [_P] * 7 + [_I] * 2 + [_P],
    # pts_t, tn, n_valid, order, normal_t, aux, out, B, N, q0, nq, stream
    "se3icp_axis_rows": [_P] * 7 + [_I] * 4 + [_P],
    # q, t, n_tgt, idx, d2, B, Nq, Nt, D, split, stream
    "se3icp_nn_argmin": [_P] * 5 + [_I] * 5 + [_P],
    # q, t, n_tgt, idx, d2, B, Nq, Nt, D, stream
    "se3icp_nn_argmin_batched": [_P] * 5 + [_I] * 4 + [_P],
    # q, t, payload, n_tgt, idx, d2, matched, B, Nq, Nt, D, P, stream
    "se3icp_nn_match_batched": [_P] * 7 + [_I] * 5 + [_P],
    # D, packed -> dynamic shared memory bytes of a tiled-search block
    "se3icp_nn_tiled_smem": [_I] * 2,
    # q, emb, tn, payload, n_tgt, phase, idx, d2, matched,
    # B, Nq, Nt, P, stream
    "se3icp_nn_match_packed_batched": [_P] * 9 + [_I] * 4 + [_P],
    # q, emb, tn, payload, n_tgt, phase, idx, d2, matched,
    # B, Nq, Nt, P, split, stream
    "se3icp_nn_match_packed": [_P] * 9 + [_I] * 5 + [_P],
    # raw, pts, tn, thr, out0, out1, out2, B, N, C, r0, thr_bstride, mode,
    # fuse, c0, c2, c3 (float bits), stream: G1 (csrc/frames.cu)
    "se3icp_frame_inputs": [_P] * 7 + [_I] * 10 + [_P],
    # raw, pts, normal, w, fused, out_t, frames, B, N, C, r0, stream: G2
    "se3icp_frame_assembly": [_P] * 7 + [_I] * 4 + [_P],
    # A, b, st, T, it, pure_it, mse_prev, mse_cur, switched, done, hist,
    # W, ph2, pf, hv, stop_thresh, n_src_f, B, H, pt2pt, is_se3, hybrid,
    # do_trim, max_iters, max_se3_iters, stream: G3 (csrc/step_update.cu)
    "se3icp_step_update": [_P] * 17 + [_I] * 8 + [_P],
    # src, n_src, tgt, n_tgt, scale_pre, src_c, tgt_c, cen_s, cen_t,
    # scaling, B, Ns, Nt, cluster, stream: G4 (csrc/prep.cu)
    "se3icp_prep": [_P] * 10 + [_I] * 4 + [_P],
    # parent stream, child stream, pred: an "if" node (csrc/graph_cond.cu)
    "se3icp_cond_begin": [_P] * 3,
    # child stream
    "se3icp_cond_end": [_P],
}


def find_nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            cands.append(os.path.join(os.environ[var], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA "
        "kernels of se3_icp_tpu_torch cannot be built")


def sources() -> list[Path]:
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def headers() -> list[Path]:
    return sorted(CSRC.glob("*.cuh"))


def _digest(files) -> str:
    """Hash of the flags and of every file a build reads: the sources
    AND the headers they include, so an edited header rebuilds too."""
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for s in files:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def build(force: bool = False, verbose: bool = False) -> Path:
    """Compile every source (one ``nvcc`` per source, all started
    together), link, and return the library's path.  Reuses a library
    already built from the same sources and flags unless ``force``."""
    srcs = sources()
    tag = _digest(srcs + headers())
    lib = BUILD_DIR / f"libse3icp_{tag}.so"
    if lib.exists() and not force:
        return lib
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    extra = ["-Xptxas", "-v"] if verbose else []
    uniq = f"{tag}_{os.getpid()}"
    objs, procs = [], []
    for s in srcs:
        obj = BUILD_DIR / f"{s.stem}_{uniq}.o"
        objs.append(obj)
        procs.append((s, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, *extra, "-c", str(s), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for s, p in procs:
        out, _ = p.communicate()
        logs.append(out)
        if p.returncode != 0:
            failed.append(f"--- {s.name} (exit {p.returncode})\n{out}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = BUILD_DIR / f"libse3icp_{uniq}.so.tmp"
    link = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o", str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, lib)        # atomic: a concurrent loader sees all or none
    for o in objs:
        o.unlink(missing_ok=True)
    if verbose:
        print("".join(logs), flush=True)
    return lib


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The kernel library, built if need be on the first call."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {code}")


# the wrappers whose launches are counted, in their slots' order
COUNTED = ("neighborhood_thresholds_batched", "moments_batched",
           "axis_sums_batched", "nn_match_affine", "loop_epilogue_batched",
           "nn_argmin_batched", "nn_argmin_unbatched", "nn_match_batched",
           "nn_match_packed", "frame_inputs", "frame_assembly",
           "step_update", "center_scale")
_counts: dict = {}      # device index -> int64 [len(COUNTED)] on the card
_slots: dict = {}       # device index -> {name: 0-dim view of its slot}


def launch_counters(device) -> dict:
    """{name: 0-dim int64 count} on CUDA ``device``, made on first use.
    A capture must not make them (they would live in its graph's pool),
    so ``models/program.py`` asks for them before it captures."""
    import torch
    if device.index not in _slots:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("launch counters must exist before a "
                               "graph capture")
        buf = torch.zeros(len(COUNTED), dtype=torch.int64, device=device)
        _counts[device.index] = buf
        _slots[device.index] = dict(zip(COUNTED, buf.unbind(0)))
    return _slots[device.index]


def count_launch(name: str, device) -> None:
    """Add one to ``name``'s launch count on ``device``, on its current
    stream: the stream the wrapper just launched its kernel on."""
    launch_counters(device)[name].add_(1)


def launches() -> dict:
    """{name: launches} summed over the devices, read back after every
    device has finished its work."""
    import torch
    total = dict.fromkeys(COUNTED, 0)
    for index, buf in _counts.items():
        torch.cuda.synchronize(index)
        for name, n in zip(COUNTED, buf.tolist()):
            total[name] += n
    return total


def zero_launches() -> None:
    for buf in _counts.values():
        buf.zero_()


def launch(fn, device, *args) -> int:
    """Call the C entry point ``fn`` with ``args`` and the current
    stream of CUDA ``device``, inside a device context only when
    ``device`` is not the current one; returns the entry point's code."""
    import torch
    if device.index == torch.cuda.current_device():
        return fn(*args, torch.cuda.current_stream(device).cuda_stream)
    with torch.cuda.device(device):
        return fn(*args, torch.cuda.current_stream(device).cuda_stream)


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    import torch
    return torch.cuda.get_device_properties(index).multi_processor_count


def cluster_for(blocks: int, index: int, waves: int = 1,
                most: int = 8) -> int:
    """The smallest cluster size C (a power of two, at most ``most``,
    the portable size) with ``blocks * C`` at least ``waves`` times the
    SM count of device ``index``: the blocks a grid spreads one unit of
    work over when the grid alone would leave SMs idle."""
    c, sms = 1, sm_count(index)
    while c < most and blocks * c < waves * sms:
        c *= 2
    return c
