"""Frozen counts of the work two kernels' algorithms need, from shapes,
valid counts and iteration counts alone: no padding, no constant of a
kernel's tiling or search plan, so a roofline share reads the same work
whatever implements it.

K4, the correspondence match: every valid source of a live pair is
compared with every valid target in the embedding of the pair's phase,
a width-D dot product each (D = 12 in the SE(3) phase: nine frame
entries and three coordinates; D = 3 after the switch, where the frame
block is zero), a fused multiply-add per entry.  A registration's steps
in the SE(3) phase are its ``num_pure_se3_iterations`` (the step that
decides the switch still matches in 12-D), the rest of its
``num_iterations`` are in the R3 phase.  Bytes: each valid source's
query (D floats) and each valid target's embedding (D floats) read once,
and a distance and the matched point and normal (7 floats) written for
each valid source.

K1, the neighbourhood thresholds of one cloud: the squared distance of
every valid row to every valid row (three differences, three products,
two sums: 8 operations), as the brute-force search that the threshold
route runs needs them.  Bytes: the valid points read once, and one
threshold a ball size written for each valid row.
"""

from __future__ import annotations

import numpy as np

F32 = 4


def k4_work(n_src, n_tgt, iters, se3_iters) -> tuple:
    """(flops, bytes) of K4 over pairs with valid counts n_src, n_tgt
    [P], iterations and SE(3)-phase iterations [P]."""
    ns, nt = np.asarray(n_src, float), np.asarray(n_tgt, float)
    se3 = np.asarray(se3_iters, float)
    r3 = np.asarray(iters, float) - se3
    flops = float(np.sum(2.0 * ns * nt * (12 * se3 + 3 * r3)))
    nbytes = float(np.sum(F32 * (se3 * (12 * ns + 12 * nt + 7 * ns)
                                 + r3 * (3 * ns + 3 * nt + 7 * ns))))
    return flops, nbytes


def k1_work(n_valid, balls: int) -> tuple:
    """(flops, bytes) of K1 over clouds with valid counts ``n_valid``
    [C], each asked for ``balls`` ball sizes."""
    n = np.asarray(n_valid, float)
    return (float(np.sum(8.0 * n * n)),
            float(np.sum(F32 * (3 * n + balls * n))))
