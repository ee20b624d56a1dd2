// Photometric Gauss-Newton linearisation, one thread per object pixel: one
// launch per linearisation.  The tracker's path runs gn_level.cu, which
// takes a level's whole GN loop into one launch; this kernel stays as the
// single-step entry point (tracker.gn_terms) and as the stepwise yardstick.
// The per-pixel arithmetic both share is gn_pixel.cuh.  The tile-sharded
// tracker (parallel/tracking.py) launches it once per GN step on its rank's
// row block: h x w pixels starting at image row y_offset of a full_h x
// full_w image whose gather planes it reads whole; the block's 44 sums are
// then all-reduced over the ranks.
//
// Replaces the Pallas kernel dvo_tpu/ops/pallas/gn.py:_gn_kernel (reached
// through gn_terms_pallas).  Its arithmetic follows the XLA twin
// dvo_tpu/models/tracker.py:gn_terms, not the Pallas kernel: gray and mask
// are sampled with bilinear_masked's cyclic-predecessor fill, gx/gy/gmask
// with bilinear_dense's base-corner fallback, and gmask is tested as a
// float against 0.9999.
//
// What bounds it on the card: at the main path's sizes (30x40 .. 120x160
// pixels) the pass reads ~40 bytes per pixel and does ~200 flops, so it is
// bound by memory latency and, above all, by launch overhead (up to 45
// launches per frame).  Design: real gathers (the TPU's one-hot matmul
// sampling and 8-row lane packing have no purpose here), one pass with no
// intermediate planes in device memory, and a deterministic reduction —
// each thread keeps its 44 terms (36 H + 6 g + r^2 + count) in registers,
// warps reduce them with shuffles, and each block writes one row of a
// (n_blocks, 44) buffer that the wrapper sums.  No float atomics, so a run
// repeats exactly.

#include "gn_pixel.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTerms = 44;

__global__ void __launch_bounds__(kThreads)
gn_terms_kernel(dvo::GNPlanes planes,
                const float* __restrict__ params,  // T_inv (4x4 row-major) | fx fy cx cy
                float* __restrict__ partials, dvo::GNScalars s) {
  __shared__ float warp_sums[kWarps][kTerms];
  float t[kTerms];
#pragma unroll
  for (int k = 0; k < kTerms; ++k) t[k] = 0.0f;

  const int n = s.h * s.w;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p < n) {
    float J[6], r, weight;
    if (dvo::gn_pixel(planes, s, params, params[16], params[17], params[18], params[19], p,
                      J, &r, &weight)) {
      const float rw = r * weight;
#pragma unroll
      for (int a = 0; a < 6; ++a) {
        const float ja = s.weight_b_only ? J[a] : J[a] * weight;
#pragma unroll
        for (int b = 0; b < 6; ++b) t[a * 6 + b] = ja * J[b];
        t[36 + a] = J[a] * rw;
      }
      t[42] = r * r;
      t[43] = 1.0f;
    }
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kTerms; ++k) {
    float v = t[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) warp_sums[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x < kTerms) {
    float v = 0.0f;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) v += warp_sums[wi][threadIdx.x];
    partials[blockIdx.x * kTerms + threadIdx.x] = v;
  }
}

}  // namespace

extern "C" int dvo_gn_num_blocks(int n) { return (n + kThreads - 1) / kThreads; }

extern "C" int dvo_gn_terms(const float* obj_gray, const uint8_t* obj_mask,
                            const float* ref_depth, const float* ref_sigma,
                            const float* ref_gray, const uint8_t* ref_mask,
                            const float* ref_gx, const float* ref_gy,
                            const uint8_t* ref_gmask, const float* params, float* partials,
                            int h, int w, int y_offset, int full_h, int full_w, float step,
                            float min_depth, float sigma_lo, float sigma_hi, int weight_b_only,
                            int crop, int crop_x0, int crop_x1, int crop_y0, int crop_y1,
                            void* stream) {
  const dvo::GNPlanes planes{obj_gray, obj_mask, ref_depth, ref_sigma, ref_gray,
                             ref_mask,  ref_gx,   ref_gy,    ref_gmask};
  const dvo::GNScalars s{h, w, step, min_depth, sigma_lo, sigma_hi,
                         weight_b_only, crop, crop_x0, crop_x1, crop_y0, crop_y1,
                         y_offset, full_h, full_w};
  gn_terms_kernel<<<dvo_gn_num_blocks(h * w), kThreads, 0, (cudaStream_t)stream>>>(
      planes, params, partials, s);
  return (int)cudaGetLastError();
}
