// The depth regulariser's per-pixel arithmetic, shared by regularize.cu and
// the regularize-and-cull launch of framebuild.cu: one definition, so both
// round alike (and like ops/cuda/regularize.regularize_plain; -fmad=false).
#pragma once

#include "dvo_kernels.h"

namespace dvo {

// The regularised depth of pixel (y, x) (dvo_tpu/models/mapper.py:regularize,
// reference implement.cpp:156-180): fuse the left, right, down and up
// neighbours in that order with the compatibility-gated Gaussian (no reset),
// reading neighbours from the ORIGINAL maps, then clamp to max_depth.
__device__ __forceinline__ float regularize_pixel(const float* __restrict__ depth,
                                                  const float* __restrict__ sigma, int y, int x,
                                                  int h, int w, float gain_ramp,
                                                  float max_depth) {
  float mu = depth[y * w + x];
  float sg = sigma[y * w + x];
  const int dxs[4] = {-1, 1, 0, 0};
  const int dys[4] = {0, 0, 1, -1};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int qx = x + dxs[k];
    const int qy = y + dys[k];
    if (qx < 0 || qx >= w || qy < 0 || qy >= h) continue;
    const float nd = depth[qy * w + qx];
    const float ns = sigma[qy * w + qx];
    // gaussian.cpp:19-21 compatibility gate
    const float diff = fabsf(nd - mu);
    const float m = fminf(nd, diff);
    const float gain = m < gain_ramp ? 0.5f + m / gain_ramp * 0.5f : 1.0f;
    if (!(diff <= gain * fmaxf(sg, ns))) continue;
    // gaussian.cpp:27-28 fusion
    const float v1 = sg * sg;
    const float v2 = ns * ns;
    const float v = v1 + v2;
    const float safe_v = v < 1e-12f ? 1.0f : v;
    mu = (v2 * mu + v1 * nd) / safe_v;
    sg = sqrtf(v1 * v2 / safe_v);
  }
  return fminf(mu, max_depth);
}

}  // namespace dvo
