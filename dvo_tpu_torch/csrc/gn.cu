// Photometric Gauss-Newton linearisation, one thread per object pixel.
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

#include "dvo_kernels.h"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTerms = 44;

struct GNScalars {
  int h, w;
  float step, min_depth, sigma_lo, sigma_hi;
  int weight_b_only, crop, crop_x0, crop_x1, crop_y0, crop_y1;
};

// bilinear_masked (convert.cpp:128-177): invalid corners take the nearest
// valid corner in cyclic order; valid iff any corner is.
__device__ __forceinline__ float sample_masked(const float* __restrict__ img,
                                               const uint8_t* __restrict__ mask,
                                               int w, const dvo::Corners& c,
                                               bool* valid) {
  const int i00 = c.y0c * w + c.x0c;
  const int i10 = c.y0c * w + c.x1c;
  const int i01 = c.y1c * w + c.x0c;
  const int i11 = c.y1c * w + c.x1c;
  const bool in3 = c.in_x1 && c.in_y1;
  const float g00 = img[i00];
  const bool m00 = mask[i00] != 0;
  float g[4] = {g00, c.in_x1 ? img[i10] : g00, c.in_y1 ? img[i01] : g00,
                in3 ? img[i11] : g00};
  bool v[4] = {c.in0 && m00, c.in0 && (c.in_x1 ? mask[i10] != 0 : m00),
               c.in0 && (c.in_y1 ? mask[i01] != 0 : m00),
               c.in0 && (in3 ? mask[i11] != 0 : m00)};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!v[i]) g[i] = 0.0f;
  }
#pragma unroll
  for (int sweep = 0; sweep < 2; ++sweep) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = (i + 3) & 3;
      if (!v[i] && v[p]) {
        g[i] = g[p];
        v[i] = true;
      }
    }
  }
  *valid = v[0] || v[1] || v[2] || v[3];
  return dvo::lerp2(g[0], g[1], g[2], g[3], c.fx, c.fy);
}

__global__ void __launch_bounds__(kThreads)
gn_terms_kernel(const float* __restrict__ obj_gray, const uint8_t* __restrict__ obj_mask,
                const float* __restrict__ ref_depth, const float* __restrict__ ref_sigma,
                const float* __restrict__ ref_gray, const uint8_t* __restrict__ ref_mask,
                const float* __restrict__ ref_gx, const float* __restrict__ ref_gy,
                const uint8_t* __restrict__ ref_gmask,
                const float* __restrict__ params,  // T_inv (4x4 row-major) | fx fy cx cy
                float* __restrict__ partials, GNScalars s) {
  __shared__ float warp_sums[kWarps][kTerms];
  float t[kTerms];
#pragma unroll
  for (int k = 0; k < kTerms; ++k) t[k] = 0.0f;

  const int n = s.h * s.w;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p < n) {
    const int yi = p / s.w;
    const int xi = p - yi * s.w;
    const float xs = (float)xi;
    const float ys = (float)yi;
    const float* T = params;
    const float fx = params[16], fy = params[17], cx = params[18], cy = params[19];

    // warp_points(T_inv, xy, depth, K) (optimize.cpp:51)
    const float depth = ref_depth[p];
    const float X = depth * (xs - cx) / fx;
    const float Y = depth * (ys - cy) / fy;
    const float Z = depth;
    const float Xj = T[0] * X + T[1] * Y + T[2] * Z + T[3];
    const float Yj = T[4] * X + T[5] * Y + T[6] * Z + T[7];
    const float Zj = T[8] * X + T[9] * Y + T[10] * Z + T[11];
    const bool in_front = Zj > 1e-6f;
    const float sz = fabsf(Zj) < 1e-6f ? 1.0f : Zj;
    const float wx = Xj * fx / sz + cx;
    const float wy = Yj * fy / sz + cy;

    const dvo::Corners c = dvo::corners(wx, wy, s.h, s.w);
    bool i2_valid;
    const float i2 = sample_masked(ref_gray, ref_mask, s.w, c, &i2_valid);
    const float gx = dvo::sample_dense(ref_gx, s.w, c);
    const float gy = dvo::sample_dense(ref_gy, s.w, c);
    const float gm = dvo::sample_dense(ref_gmask, s.w, c);

    // gates (optimize.cpp:33-63)
    bool valid = depth >= s.min_depth && obj_mask[p] != 0 && i2_valid;
    valid = valid && wx >= 0.0f && wx < (float)s.w && wy >= 0.0f && wy < (float)s.h;
    valid = valid && in_front && gm > 0.9999f;
    if (s.crop) {
      valid = valid && xi >= s.crop_x0 && xi <= s.crop_x1 && yi >= s.crop_y0 &&
              yi <= s.crop_y1;
    }

    if (valid) {
      // Jacobian (optimize.cpp:67-77), residual and weight (:79-89)
      const float z = fabsf(Z) < 1e-6f ? 1e-6f : Z;
      const float fgx = fx * gx;
      const float fgy = fy * gy;
      const float xz = X / z;
      const float yz = Y / z;
      float J[6];
      J[0] = fgx / z;
      J[1] = fgy / z;
      J[2] = -(fgx * X + fgy * Y) / (z * z);
      J[3] = -fgx * xz * yz - fgy * (1.0f + yz * yz);
      J[4] = fgx * (1.0f + xz * xz) + fgy * xz * yz;
      J[5] = -fgx * yz + fgy * xz;
      const float r = i2 - obj_gray[p];
      const float weight = s.step / fminf(fmaxf(ref_sigma[p], s.sigma_lo), s.sigma_hi);
      const float hw = s.weight_b_only ? 1.0f : weight;
      const float rw = r * weight;
#pragma unroll
      for (int a = 0; a < 6; ++a) {
        const float ja = s.weight_b_only ? J[a] : J[a] * hw;
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
                            int h, int w, float step, float min_depth, float sigma_lo,
                            float sigma_hi, int weight_b_only, int crop, int crop_x0,
                            int crop_x1, int crop_y0, int crop_y1, void* stream) {
  const GNScalars s{h, w, step, min_depth, sigma_lo, sigma_hi,
                    weight_b_only, crop, crop_x0, crop_x1, crop_y0, crop_y1};
  gn_terms_kernel<<<dvo_gn_num_blocks(h * w), kThreads, 0, (cudaStream_t)stream>>>(
      obj_gray, obj_mask, ref_depth, ref_sigma, ref_gray, ref_mask, ref_gx, ref_gy,
      ref_gmask, params, partials, s);
  return (int)cudaGetLastError();
}
