// The depth regulariser's per-pixel arithmetic, shared by regularize.cu and
// the regularize-and-cull launch of framebuild.cu: one definition, so both
// round alike (and like ops/cuda/regularize.regularize_plain; -fmad=false).
#pragma once

#include "dvo_kernels.h"

namespace dvo {

// The neighbours the regulariser fuses, in its order: left, right, down, up.
__device__ __forceinline__ int tap_x(int k) { return k == 0 ? -1 : (k == 1 ? 1 : 0); }
__device__ __forceinline__ int tap_y(int k) { return k == 2 ? 1 : (k == 3 ? -1 : 0); }

// Fuse the four taps (nd, ns: the neighbours' depth and sigma; in: the
// neighbour lies in the image) into (mu, sg) in that order with the
// compatibility-gated Gaussian (no reset), then clamp to max_depth
// (dvo_tpu/models/mapper.py:regularize, reference implement.cpp:156-180).
__device__ __forceinline__ float fuse_taps(float mu, float sg, const float (&nd)[4],
                                           const float (&ns)[4], const bool (&in)[4],
                                           float gain_ramp, float max_depth) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (!in[k]) continue;
    // gaussian.cpp:19-21 compatibility gate
    const float diff = fabsf(nd[k] - mu);
    const float m = fminf(nd[k], diff);
    const float gain = m < gain_ramp ? 0.5f + m / gain_ramp * 0.5f : 1.0f;
    if (!(diff <= gain * fmaxf(sg, ns[k]))) continue;
    // gaussian.cpp:27-28 fusion
    const float v1 = sg * sg;
    const float v2 = ns[k] * ns[k];
    const float v = v1 + v2;
    const float safe_v = v < 1e-12f ? 1.0f : v;
    mu = (v2 * mu + v1 * nd[k]) / safe_v;
    sg = sqrtf(v1 * v2 / safe_v);
  }
  return fminf(mu, max_depth);
}

// The regularised depth of pixel (y, x) of an (h, w) map, reading neighbours
// from the ORIGINAL maps.  All ten loads are issued before the gate chain
// (a neighbour outside the image reads a clamped, unused address), so a
// thread waits for memory once.
__device__ __forceinline__ float regularize_pixel(const float* __restrict__ depth,
                                                  const float* __restrict__ sigma, int y, int x,
                                                  int h, int w, float gain_ramp,
                                                  float max_depth) {
  float nd[4], ns[4];
  bool in[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int qx = x + tap_x(k);
    const int qy = y + tap_y(k);
    in[k] = qx >= 0 && qx < w && qy >= 0 && qy < h;
    const int q = clampi(qy, 0, h - 1) * w + clampi(qx, 0, w - 1);
    nd[k] = __ldg(depth + q);
    ns[k] = __ldg(sigma + q);
  }
  return fuse_taps(__ldg(depth + y * w + x), __ldg(sigma + y * w + x), nd, ns, in, gain_ramp,
                   max_depth);
}

}  // namespace dvo
