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
// written.  The per-pixel arithmetic is regularize_pixel.cuh, which the
// regularize-and-cull launch of framebuild.cu shares.

#include "regularize_pixel.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
regularize_kernel(const float* __restrict__ depth, const float* __restrict__ sigma,
                  float* __restrict__ out, int h, int w, float gain_ramp, float max_depth) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= h * w) return;
  const int y = p / w;
  const int x = p - y * w;
  out[p] = dvo::regularize_pixel(depth, sigma, y, x, h, w, gain_ramp, max_depth);
}

}  // namespace

extern "C" int dvo_regularize(const float* depth, const float* sigma, float* out, int h,
                              int w, float gain_ramp, float max_depth, void* stream) {
  const int blocks = (h * w + kThreads - 1) / kThreads;
  regularize_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(depth, sigma, out, h, w,
                                                                     gain_ramp, max_depth);
  return (int)cudaGetLastError();
}
