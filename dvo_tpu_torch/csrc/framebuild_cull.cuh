// The pyramid layout of the frame build and its cull, shared by the two
// kernels of framebuild.cu.  Each plane kind is one buffer holding all
// levels back to back, coarsest first; level t (decimation by 2^t) has
// ceil(h0 / 2^t) x ceil(w0 / 2^t) pixels, the point samples
// plane[y * 2^t, x * 2^t] (dvo_tpu/ops/image.py cull_image, reference
// frame.cpp:39-61).
#pragma once

#include "dvo_kernels.h"

namespace dvo {

__device__ __forceinline__ int level_height(int h0, int t) { return (h0 + (1 << t) - 1) >> t; }
__device__ __forceinline__ int level_width(int w0, int t) { return (w0 + (1 << t) - 1) >> t; }

struct LevelPixel {
  int t, ht, wt;  // the level and its size
  int y, x;       // the pixel in the level
};

// The level and pixel of element p of a plane kind's buffer.
__device__ __forceinline__ LevelPixel locate(int p, int h0, int w0, int levels) {
  LevelPixel o;
  int off = 0;
  for (o.t = levels - 1; o.t >= 0; --o.t) {
    o.ht = level_height(h0, o.t);
    o.wt = level_width(w0, o.t);
    if (p < off + o.ht * o.wt) break;
    off += o.ht * o.wt;
  }
  const int q = p - off;
  o.y = q / o.wt;
  o.x = q - o.y * o.wt;
  return o;
}

// The cull as a scatter: base pixel (y, x) holding `value` goes to every
// level t with y % 2^t == 0 and x % 2^t == 0, at (y >> t, x >> t) of that
// level's part of `plane`.
__device__ __forceinline__ void cull_store(float* __restrict__ plane, float value, int y, int x,
                                           int h0, int w0, int levels) {
  int off = 0;
  for (int t = levels - 1; t >= 0; --t) {
    const int ht = level_height(h0, t);
    const int wt = level_width(w0, t);
    const int step = (1 << t) - 1;
    if ((y & step) == 0 && (x & step) == 0) plane[off + (y >> t) * wt + (x >> t)] = value;
    off += ht * wt;
  }
}

}  // namespace dvo
