// The pyramid layout of the frame build and its cull, shared by the two
// kernels of framebuild.cu.  Each plane kind is one buffer holding all
// levels back to back, coarsest first; level t (decimation by 2^t) has
// ceil(h0 / 2^t) x ceil(w0 / 2^t) pixels, the point samples
// plane[y * 2^t, x * 2^t] (dvo_tpu/ops/image.py cull_image, reference
// frame.cpp:39-61).
//
// Both kernels run one thread per base pixel (y, x) on a 2D grid: the
// pixel is the sample of level t exactly when y and x are multiples of 2^t,
// so a thread writes level 0 and every coarser level it is a sample of
// (`top_level`), and no thread searches for its level.
#pragma once

#include "dvo_kernels.h"

namespace dvo {

constexpr int kMaxLevels = 6;   // levels a launch takes (the coarse taps are prefetched)
constexpr int kBlockX = 32;     // a warp's 32 consecutive base pixels of one row
constexpr int kBlockY = 4;      // 150 blocks at 120x160, 424 at 212x256

__device__ __forceinline__ int level_height(int h0, int t) { return (h0 + (1 << t) - 1) >> t; }
__device__ __forceinline__ int level_width(int w0, int t) { return (w0 + (1 << t) - 1) >> t; }

// The coarsest level base pixel (y, x) is a sample of.
__device__ __forceinline__ int top_level(int y, int x, int levels) {
  int top = 0;
  while (top + 1 < levels && ((y | x) & ((2 << top) - 1)) == 0) ++top;
  return top;
}

}  // namespace dvo
