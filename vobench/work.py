"""The yardstick's arithmetic: bytes and float operations of each kernel
call, and the card's published peaks.

A frozen copy of the program's ``work()`` functions (``ops/cuda/gn_level``,
``ops/cuda/epipolar.work_fused``, ``ops/cuda/framebuild``) as of commit
4bde8663, so that a change to the program cannot move the yardstick.  Each
counts every input byte read once and every output byte written once, and
the operations that these inputs need; it describes the function a kernel
computes, not a kernel, so it holds whatever kernel computes it.
"""

from __future__ import annotations

# NVIDIA H100 SXM, published (dense, no sparsity), at its 700 W limit.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS_F32 = 67e12

# One GN linearisation: six float32 planes and three one-byte masks read per
# pixel; every pixel back-projected, moved, projected (30), split into
# bilinear corners (4) and sampled four times (12 each); a valid pixel adds
# its Jacobian row (29), residual and weight (5), and its 29 products and
# sums (63).  A step's solve and pose update: ~700.
GN_BYTES_PER_PIXEL = 6 * 4 + 3
GN_FLOPS_PER_PIXEL = 30 + 4 + 4 * 12
GN_FLOPS_PER_VALID_PIXEL = 29 + 5 + 63
GN_EPILOGUE_FLOPS = 700

# The fused epipolar update: per pixel five float32 planes and a mask byte
# read and three planes written; per ring slot in use gray, gx, gy and a
# gmask byte per pixel; a pose table of (2 + capacity) rows of 16 floats and
# four counts.  A marched sample costs 27 operations; preparing a pixel's
# fields 163, what follows the march 60.
EPI_BYTES_PER_PIXEL = 5 * 4 + 1 + 3 * 4
EPI_BYTES_PER_SLOT_PIXEL = 3 * 4 + 1
EPI_TABLE_ROW = 16
EPI_FLOPS_PER_SAMPLE = 27
EPI_FLOPS_PER_PIXEL = 60 + (3 * 32 + 9 + 4 + 4 + 50)

# The regulariser: four neighbours, each a gate (8) and a fusion (10), and
# the clamp.
REG_FLOPS_PER_PIXEL = 4 * 18 + 1


def bound_s(nbytes: float, flops: float) -> float:
    """The least time of a call: the larger of its bytes over the memory
    bandwidth and its operations over the float32 peak."""
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_FLOPS_F32)


def gn_level(shape, valid_counts, max_iterations: int):
    """(bytes, operations) of one pyramid level's GN loop at ``shape`` =
    (h, w) whose steps found ``valid_counts`` valid pixels (one entry per
    step that ran): inputs read once and outputs written once whatever the
    number of steps, the operations of every step that ran."""
    n = shape[0] * shape[1]
    outputs = (6 + 2 * max_iterations) * 4 + (max_iterations + 1) * 4
    nbytes = GN_BYTES_PER_PIXEL * n + (9 + 6) * 4 + outputs
    flops = sum(GN_FLOPS_PER_PIXEL * n + GN_FLOPS_PER_VALID_PIXEL * int(v) + GN_EPILOGUE_FLOPS
                for v in valid_counts)
    return nbytes, flops


def epipolar_fused(shape, slots_in_use: int, samples: int, capacity: int):
    """(bytes, operations) of one depth update of an (h, w) keyframe whose
    pixels refer to ``slots_in_use`` ring slots and march ``samples``
    samples in all."""
    n = shape[0] * shape[1]
    nbytes = (EPI_BYTES_PER_PIXEL * n + EPI_BYTES_PER_SLOT_PIXEL * n * int(slots_in_use)
              + 4 * EPI_TABLE_ROW * (2 + int(capacity)) + 4 * 4)
    return nbytes, EPI_FLOPS_PER_SAMPLE * int(samples) + EPI_FLOPS_PER_PIXEL * n


def level_sizes(shape, levels: int):
    """(h, w) of each pyramid level, coarsest first: ceil(n / 2**t)."""
    h0, w0 = shape
    return [(-(-h0 // 2 ** t), -(-w0 // 2 ** t)) for t in range(levels - 1, -1, -1)]


def framebuild(shape, levels: int, n_values: int):
    """(bytes, operations) of one pyramid build of ``n_values`` float32
    planes and a mask from an (h, w) base: the base read once, every level's
    values, mask, gradients and gradient mask written once, two subtractions
    a level pixel."""
    h0, w0 = shape
    total = sum(h * w for h, w in level_sizes(shape, levels))
    return 4 * n_values * (h0 * w0 + total) + h0 * w0 + 10 * total, 2 * total


def regularize_cull(shape, levels: int):
    """(bytes, operations) of the regulariser and the cull of depth and sigma
    to every level."""
    h0, w0 = shape
    total = sum(h * w for h, w in level_sizes(shape, levels))
    return 8 * (h0 * w0 + total), REG_FLOPS_PER_PIXEL * h0 * w0
