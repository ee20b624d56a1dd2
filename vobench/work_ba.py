"""The yardstick's arithmetic for windowed photometric bundle adjustment:
bytes and float operations of one solve of ``m`` keyframes of (h, w)
pixels over ``iterations`` Gauss-Newton steps (``reference/ba.py`` states
the mathematics).

It describes the function, not a kernel, so that any code that computes
it is measured by the same count.  Inputs are read once and outputs
written once, whatever an implementation reads again; the operations are
those the mathematics needs: each iteration evaluates every ordered pair's
terms once (an implementation that evaluates them again for the
back-substitution does more than is counted here).
"""

from __future__ import annotations

# One host pixel against one target: back-project and move the point (26),
# project (7), one masked and three dense bilinear samples (58), residual
# and Huber weight (5), the point's image derivative (8), the host's
# Jacobian row and its rotation part (24), the target's (12), the inverse
# depth's (14).
PAIR_FLOPS = 154
# ... its weighted products into the host's and the target's camera blocks
# and their cross block (3 x 36 multiply-adds), the gradients (2 x 6), the
# coupling row (2 x 6), the depth block, its gradient and the cost.
PAIR_ACCUMULATE_FLOPS = 284
# Per pixel of the window a GN step moves its inverse depth: the
# re-linearised depth (4) and the back-substitution besides the coupling
# dot (3).
PIXEL_FLOPS = 7
# Per pixel and keyframe plane read: gray, gradients and depth (float32),
# mask and gradient mask (a byte each).
BYTES_PER_PIXEL = 4 * 4 + 2


def schur_flops(n: int) -> int:
    """One pixel's coupling row (``n`` = 6m wide) folded into the reduced
    system and gradient: the row scaled (n), its outer product added
    (2 n^2), the gradient's part (3 n)."""
    return 2 * n * n + 4 * n


def solve_flops(n: int) -> int:
    """The damped reduced system's Cholesky factorisation and two triangular
    solves."""
    return n ** 3 // 3 + 2 * n * n + n


def ba_solve(m: int, shape, iterations: int):
    """(bytes, operations) of one solve: ``m`` keyframes of ``shape`` =
    (h, w) pixels, every ordered pair of distinct keyframes, ``iterations``
    steps."""
    px = shape[0] * shape[1]
    n = 6 * m
    pairs = m * (m - 1)
    nbytes = (BYTES_PER_PIXEL * m * px + 4 * 6 * m + 4 * 9          # window, poses, K
              + 4 * m * px + 4 * 6 * m + 2 * 4 * iterations)        # depths, poses, costs, counts
    per_step = (pairs * px * (PAIR_FLOPS + PAIR_ACCUMULATE_FLOPS)
                + m * px * (schur_flops(n) + 2 * n + PIXEL_FLOPS) + solve_flops(n))
    return nbytes, iterations * per_step
