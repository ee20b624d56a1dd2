// Device helpers shared by the dvo_tpu_torch kernels: index clamping and
// the reference's dense bilinear sampler (convert.cpp:77-105).
//
// Every kernel is built with -fmad=false (ops/cuda/_build.py): each
// expression below rounds exactly as the op-by-op PyTorch plain versions
// do, so keep the operation order of those versions when editing.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace dvo {

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// (int) of an already-floored (or rounded) coordinate, clamped to
// [-2, n + 1] first so that the cast is defined for any float (NaN -> -2)
// while every test the samplers make (>= 0, < n, + 1 < n, the clamped
// corner indices) comes out as it would for the exact integer.
__device__ __forceinline__ int to_index(float floored, int n) {
  return (int)fminf(fmaxf(floored, -2.0f), (float)n + 1.0f);
}

struct Corners {
  int x0c, x1c, y0c, y1c;
  float fx, fy;
  bool in0, in_x1, in_y1;
};

__device__ __forceinline__ Corners corners(float x, float y, int h, int w) {
  Corners c;
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  c.fx = x - x0f;
  c.fy = y - y0f;
  const int x0 = to_index(x0f, w);
  const int y0 = to_index(y0f, h);
  c.in0 = x0 >= 0 && x0 < w && y0 >= 0 && y0 < h;
  c.in_x1 = x0 + 1 < w;
  c.in_y1 = y0 + 1 < h;
  c.x0c = clampi(x0, 0, w - 1);
  c.x1c = clampi(x0 + 1, 0, w - 1);
  c.y0c = clampi(y0, 0, h - 1);
  c.y1c = clampi(y0 + 1, 0, h - 1);
  return c;
}

__device__ __forceinline__ float lerp2(float g00, float g10, float g01, float g11,
                                       float fx, float fy) {
  const float top = g00 * (1.0f - fx) + g10 * fx;
  const float bot = g01 * (1.0f - fx) + g11 * fx;
  return top * (1.0f - fy) + bot * fy;
}

// getSubpixelFromDense: an out-of-range +1 corner falls back to the base
// corner (not clamp-to-edge).  Validity (c.in0) is left to the caller.
template <typename T>
__device__ __forceinline__ float sample_dense(const T* __restrict__ img, int w,
                                              const Corners& c) {
  const float g00 = (float)img[c.y0c * w + c.x0c];
  const float g10 = c.in_x1 ? (float)img[c.y0c * w + c.x1c] : g00;
  const float g01 = c.in_y1 ? (float)img[c.y1c * w + c.x0c] : g00;
  const float g11 = (c.in_x1 && c.in_y1) ? (float)img[c.y1c * w + c.x1c] : g00;
  return lerp2(g00, g10, g01, g11, c.fx, c.fy);
}

}  // namespace dvo
