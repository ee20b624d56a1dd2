// The per-pixel arithmetic of the photometric Gauss-Newton linearisation
// (optimize.cpp:28-90), shared by gn.cu (one linearisation per launch) and
// gn_level.cu (a level's whole GN loop per launch): warp the pixel, sample
// the reference planes, apply the gates, and give the Jacobian row, the
// residual and the weight; and the warp's reduce-scatter of the sums.  It follows the XLA twin
// dvo_tpu/models/tracker.py:gn_terms and the port's gn_terms_plain
// operation by operation (see dvo_kernels.h on -fmad=false).
//
// A launch may cover a row block of the image (the tile-sharded tracker,
// dvo_tpu_torch/parallel/tracking.py): pixel p of the (h, w) block lies on
// image row p / w + y_offset of the (full_h, full_w) image.  The object
// planes and the reference depth and sigma are the block's, indexed by p;
// the gather targets (reference gray, mask, gx, gy, gmask), the in-image
// test, the corner clamps and the crop gate are the full image's.  A whole
// image is the block with y_offset 0 and full_h, full_w = h, w.
#pragma once

#include "dvo_kernels.h"

namespace dvo {

struct GNPlanes {
  const float* obj_gray;
  const uint8_t* obj_mask;
  const float* ref_depth;
  const float* ref_sigma;
  const float* ref_gray;
  const uint8_t* ref_mask;
  const float* ref_gx;
  const float* ref_gy;
  const uint8_t* ref_gmask;
};

struct GNScalars {
  int h, w;  // the block
  float step, min_depth, sigma_lo, sigma_hi;
  int weight_b_only, crop, crop_x0, crop_x1, crop_y0, crop_y1;
  int y_offset, full_h, full_w;  // the block's first row in the full image
};

// bilinear_masked (convert.cpp:128-177): invalid corners take the nearest
// valid corner in cyclic order; valid iff any corner is.
__device__ __forceinline__ float sample_masked(const float* __restrict__ img,
                                               const uint8_t* __restrict__ mask,
                                               int w, const Corners& c, bool* valid) {
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
  return lerp2(g[0], g[1], g[2], g[3], c.fx, c.fy);
}

// Pixel p under the transform T (rows 0-2 of a 4x4, row-major) and the
// intrinsics fx fy cx cy.  Returns whether the pixel passes every gate; if
// so J, r and weight are its Jacobian row, residual and weight.
__device__ __forceinline__ bool gn_pixel(const GNPlanes& P, const GNScalars& s,
                                         const float* T, float fx, float fy, float cx,
                                         float cy, int p, float J[6], float* r,
                                         float* weight) {
  const int yb = p / s.w;
  const int xi = p - yb * s.w;
  const int yi = yb + s.y_offset;
  const float xs = (float)xi;
  const float ys = (float)yi;

  // warp_points(T_inv, xy, depth, K) (optimize.cpp:51)
  const float depth = P.ref_depth[p];
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

  const Corners c = corners(wx, wy, s.full_h, s.full_w);
  bool i2_valid;
  const float i2 = sample_masked(P.ref_gray, P.ref_mask, s.full_w, c, &i2_valid);
  const float gx = sample_dense(P.ref_gx, s.full_w, c);
  const float gy = sample_dense(P.ref_gy, s.full_w, c);
  const float gm = sample_dense(P.ref_gmask, s.full_w, c);

  // gates (optimize.cpp:33-63)
  bool valid = depth >= s.min_depth && P.obj_mask[p] != 0 && i2_valid;
  valid = valid && wx >= 0.0f && wx < (float)s.full_w && wy >= 0.0f && wy < (float)s.full_h;
  valid = valid && in_front && gm > 0.9999f;
  if (s.crop) {
    valid = valid && xi >= s.crop_x0 && xi <= s.crop_x1 && yi >= s.crop_y0 &&
            yi <= s.crop_y1;
  }
  if (!valid) return false;

  // Jacobian (optimize.cpp:67-77), residual and weight (:79-89)
  const float z = fabsf(Z) < 1e-6f ? 1e-6f : Z;
  const float fgx = fx * gx;
  const float fgy = fy * gy;
  const float xz = X / z;
  const float yz = Y / z;
  J[0] = fgx / z;
  J[1] = fgy / z;
  J[2] = -(fgx * X + fgy * Y) / (z * z);
  J[3] = -fgx * xz * yz - fgy * (1.0f + yz * yz);
  J[4] = fgx * (1.0f + xz * xz) + fgy * xz * yz;
  J[5] = -fgx * yz + fgy * xz;
  *r = i2 - P.obj_gray[p];
  *weight = s.step / fminf(fmaxf(P.ref_sigma[p], s.sigma_lo), s.sigma_hi);
  return true;
}

// One step of a warp's reduce-scatter over 2 O values a lane: the lane
// keeps the half its bit O selects, adds its partner's (lane ^ O) copy of
// that half, and sends the other.
template <int O>
__device__ __forceinline__ void fold(float (&t)[32], int lane) {
  const bool upper = (lane & O) != 0;
#pragma unroll
  for (int i = 0; i < O; ++i) {
    const float send = upper ? t[i] : t[i + O];
    const float keep = upper ? t[i + O] : t[i];
    t[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
}

// After O = 16, 8, 4, 2, 1, lane l holds in t[0] the warp's sum of value l:
// 31 shuffles for 32 sums, where a shuffle tree for each would take 160.
// The order of every addition is fixed, so a run repeats bit for bit.
__device__ __forceinline__ void reduce_scatter(float (&t)[32], int lane) {
  fold<16>(t, lane);
  fold<8>(t, lane);
  fold<4>(t, lane);
  fold<2>(t, lane);
  fold<1>(t, lane);
}

}  // namespace dvo
