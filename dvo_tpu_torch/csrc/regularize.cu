// 4-neighbour depth regulariser, one thread per pixel.
//
// Replaces the Pallas kernel dvo_tpu/ops/pallas/regularize.py:
// _regularize_kernel (reached through regularize_pallas) and follows the
// XLA twin dvo_tpu/models/mapper.py:regularize (reference
// implement.cpp:156-180): fuse the left, right, down and up neighbours in
// that order with the compatibility-gated Gaussian (no reset), reading
// neighbours from the ORIGINAL maps, then clamp to max_depth.
//
// What bounds it on the card: 8 bytes read and 4 written per pixel for
// ~60 flops — at 120x160 (77 KB in, 77 KB out) it is bound by launch
// latency, not by bandwidth.  Design: one fused pass, neighbours read
// straight from device memory (L1/L2 serve the 5-point stencil's reuse),
// the running mean/sigma kept in registers; nothing intermediate is
// written.

#include "dvo_kernels.h"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
regularize_kernel(const float* __restrict__ depth, const float* __restrict__ sigma,
                  float* __restrict__ out, int h, int w, float gain_ramp, float max_depth) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= h * w) return;
  const int y = p / w;
  const int x = p - y * w;
  float mu = depth[p];
  float sg = sigma[p];
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
  out[p] = fminf(mu, max_depth);
}

}  // namespace

extern "C" int dvo_regularize(const float* depth, const float* sigma, float* out, int h,
                              int w, float gain_ramp, float max_depth, void* stream) {
  const int blocks = (h * w + kThreads - 1) / kThreads;
  regularize_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(depth, sigma, out, h, w,
                                                                     gain_ramp, max_depth);
  return (int)cudaGetLastError();
}
