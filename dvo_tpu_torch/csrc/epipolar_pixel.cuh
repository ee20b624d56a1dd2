// Per-pixel device code of the epipolar depth update, shared by the two
// entries of epipolar.cu (as gn_pixel.cuh serves gn.cu and gn_level.cu):
//   * Pixel       — what the march and the arithmetic after it read for one
//                   reference pixel;
//   * load_fields — a Pixel from the 24 prepared planes (the fields entry);
//   * prepare     — a Pixel computed in registers from the raw maps and the
//                   pose table (the fused entry); term by term the arithmetic
//                   of models/mapper.epipolar_fields, whose 3x3 products are
//                   explicit sums in the order written here;
//   * march       — the masked 3-tap SSD march of one pixel by a group of
//                   kLanes lanes through a shared-memory row of the pixel's
//                   samples, first strict minimum;
//   * finish      — match gates, gradient sample, triangulation, sigma model,
//                   acceptance gates and the Gaussian fusion with reset.
//
// A launch may cover a row block of the reference keyframe (the tile-sharded
// mapper, dvo_tpu_torch/parallel/mapping.py): pixel p of the block lies on
// image row p / w + y_offset.  The block's planes (reference depth, sigma,
// age, reset depth, the 24 field planes, the outputs) are indexed by p; the
// object frame and the ring are full h x w images, and every bound, clamp,
// gather and the crop gate use the full image and the global row.  A whole
// image is the block with bh = h and y_offset 0.
//
// Everything is built with -fmad=false, IEEE division and sqrtf, so every
// expression rounds as the op-by-op PyTorch plain version does: keep the
// operation order of ops/cuda/epipolar.epipolar_update_plain and
// models/mapper.epipolar_fields when editing either side
// (tests/test_torch_epipolar_fused.py holds scalar transcriptions of both).
#pragma once

#include "dvo_kernels.h"

#ifndef DVO_EPI_LANES
#define DVO_EPI_LANES 16     // lanes that march one pixel: 2, 4, 8, 16 or 32
#endif
#ifndef DVO_EPI_THREADS
#define DVO_EPI_THREADS 512  // threads of a block
#endif
#ifndef DVO_EPI_PIXELS
#define DVO_EPI_PIXELS 64    // reference pixels a block owns
#endif

namespace dvo {
namespace epi {

constexpr int kLanes = DVO_EPI_LANES;
constexpr int kThreads = DVO_EPI_THREADS;
constexpr int kPixels = DVO_EPI_PIXELS;
constexpr int kGroups = kThreads / kLanes;
constexpr int kUnroll = 4;           // offsets a lane gathers before it uses the first
constexpr float kEps = 1e-6f;       // config.EPSILON
constexpr int kTableRow = 16;       // floats per row of the pose table

static_assert(kLanes >= 2 && kLanes <= 32 && (kLanes & (kLanes - 1)) == 0,
              "a marching group is a power-of-two part of a warp");
static_assert(kThreads % 32 == 0 && kThreads <= 1024, "whole warps");
static_assert(kPixels % 32 == 0 && kPixels <= kThreads, "whole warps own the pixels");

enum Field {
  F_START_X, F_START_Y, F_DIR_X, F_DIR_Y, F_LENGTH, F_OBJ_VAL, F_SLOT,
  F_PRIOR_D, F_PRIOR_S, F_DMIN, F_DMAX,
  F_R3Q, F_KRQ0, F_KRQ1, F_KRQ2, F_TTZ, F_KT0, F_KT1, F_KT2,
  F_REF_DEPTH, F_REF_SIGMA, F_REF_AGE, F_BASE_OK, F_RESET_D,
  N_FIELDS
};

struct Scalars {
  int h, w;             // the full image: the object frame and the ring
  int bh, y_offset;     // the block: bh rows from image row y_offset
  int capacity, steps;  // steps = S: windows 0..S-1 over offsets 0..S+1
  float match_thresh, big_ssd, epi_sigma2, lum_2sigma2;
  float accept_d_lo, accept_d_hi, accept_s_lo, accept_s_hi;
  float gain_ramp, reset_sigma;
};

struct Pixel {
  float sx, sy, dx, dy, length, obj_v;
  int slot;
  float prior_d, prior_s, dmin, dmax;
  float r3q, krq0, krq1, krq2, ttz, kt0, kt1, kt2;
  float ref_depth, ref_sigma, reset_d;
  int ref_age;
  bool base_ok;
};

__device__ __forceinline__ Pixel load_fields(const float* __restrict__ fields, int p, int n,
                                             int capacity) {
  const float* f = fields + p;
#define DVO_FIELD(k) f[(size_t)(k) * n]
  Pixel px;
  px.sx = DVO_FIELD(F_START_X);
  px.sy = DVO_FIELD(F_START_Y);
  px.dx = DVO_FIELD(F_DIR_X);
  px.dy = DVO_FIELD(F_DIR_Y);
  px.length = DVO_FIELD(F_LENGTH);
  px.obj_v = DVO_FIELD(F_OBJ_VAL);
  px.slot = clampi((int)DVO_FIELD(F_SLOT), 0, capacity - 1);
  px.prior_d = DVO_FIELD(F_PRIOR_D);
  px.prior_s = DVO_FIELD(F_PRIOR_S);
  px.dmin = DVO_FIELD(F_DMIN);
  px.dmax = DVO_FIELD(F_DMAX);
  px.r3q = DVO_FIELD(F_R3Q);
  px.krq0 = DVO_FIELD(F_KRQ0);
  px.krq1 = DVO_FIELD(F_KRQ1);
  px.krq2 = DVO_FIELD(F_KRQ2);
  px.ttz = DVO_FIELD(F_TTZ);
  px.kt0 = DVO_FIELD(F_KT0);
  px.kt1 = DVO_FIELD(F_KT1);
  px.kt2 = DVO_FIELD(F_KT2);
  px.ref_depth = DVO_FIELD(F_REF_DEPTH);
  px.ref_sigma = DVO_FIELD(F_REF_SIGMA);
  px.ref_age = (int)DVO_FIELD(F_REF_AGE);
  px.base_ok = DVO_FIELD(F_BASE_OK) > 0.5f;
  px.reset_d = DVO_FIELD(F_RESET_D);
#undef DVO_FIELD
  return px;
}

// The raw inputs of the fused entry.  table is the (2 + capacity, 16) pose
// table of models/mapper.pose_table: row 0 K (row-major 9), row 1 T_rel
// (R row-major 9, t 3) and rel_xi[2], row 2 + c the ring slot's T_es (R 9,
// t 3) and t_tw (3).
struct Raw {
  const float* obj_gray;
  const uint8_t* obj_mask;
  const float* ref_depth;
  const float* ref_sigma;
  const int32_t* ref_age;
  const float* reset_depth;
  const float* table;
  const int32_t* head;   // the ring's newest slot and live keyframes, () int32
  const int32_t* count;  // on the device: no host read before the launch
  int crop_x0, crop_x1, crop_y0, crop_y1;
  float min_search_depth;
};

struct Projected {
  float u, v;
  bool in_front;
};

// project(K, R back_project(K, (x, y), d) + t), every product an explicit
// sum, left to right (mapper._warp_point).  T: R row-major at 0..8, t at 9..11.
__device__ __forceinline__ Projected warp_point(const float* K, const float* T, float x, float y,
                                                float d) {
  const float fx = K[0], cx = K[2], fy = K[4], cy = K[5];
  const float X = d * (x - cx) / fx;
  const float Y = d * (y - cy) / fy;
  const float px = T[0] * X + T[1] * Y + T[2] * d + T[9];
  const float py = T[3] * X + T[4] * Y + T[5] * d + T[10];
  const float pz = T[6] * X + T[7] * Y + T[8] * d + T[11];
  const float safe = fabsf(pz) < kEps ? 1.0f : pz;
  Projected out;
  out.u = px * fx / safe + cx;
  out.v = py * fy / safe + cy;
  out.in_front = pz > kEps;
  return out;
}

// Steps 1-4a and the triangulation coefficients of
// dvo_tpu.models.mapper.depth_update for pixel p = (y - y_offset) * w + x of
// the block, on image row y of the h x w image;
// *aged_out: the pixel lies in the crop and its born keyframe left the ring.
__device__ __forceinline__ Pixel prepare(const Raw& in, int p, int h, int w, int y_offset,
                                         int capacity, bool* aged_out) {
  const int yb = p / w;
  const int x = p - yb * w;
  const int y = yb + y_offset;
  float K[9], T[13];
#pragma unroll
  for (int i = 0; i < 9; ++i) K[i] = __ldg(in.table + i);
#pragma unroll
  for (int i = 0; i < 13; ++i) T[i] = __ldg(in.table + kTableRow + i);

  Pixel px;
  px.ref_depth = in.ref_depth[p];
  px.ref_sigma = in.ref_sigma[p];
  px.ref_age = in.ref_age[p];
  px.reset_d = in.reset_depth[p];
  const bool crop = x >= in.crop_x0 && x <= in.crop_x1 && y >= in.crop_y0 && y <= in.crop_y1;
  if (!crop) {  // no observation and no count: nothing else of the pixel is read
    px.base_ok = false;
    *aged_out = false;
    return px;
  }

  // 1. ref pixel -> obj pixel, rounded half to even (mapper.cpp:94)
  const Projected o = warp_point(K, T, (float)x, (float)y, px.ref_depth);
  const int ox = to_index(rintf(o.u), w);
  const int oy = to_index(rintf(o.v), h);
  const bool in_obj = ox >= 0 && ox < w && oy >= 0 && oy < h;
  const int oxc = clampi(ox, 0, w - 1);
  const int oyc = clampi(oy, 0, h - 1);
  px.obj_v = in.obj_gray[oyc * w + oxc];
  const bool obj_ok = in.obj_mask[oyc * w + oxc] != 0;
  const int head = __ldg(in.head);
  const int count = __ldg(in.count);
  const bool aged_ok = px.ref_age < count;
  *aged_out = crop && !aged_ok;
  const bool pix_ok = crop && in_obj && o.in_front && obj_ok && aged_ok;

  // 2. born keyframe: slot = (head - clamp(age)) mod capacity (history.born_slot)
  const int age = clampi(px.ref_age, 0, count > 1 ? count - 1 : 0);
  px.slot = (((head - age) % capacity) + capacity) % capacity;
  float E[15];
#pragma unroll
  for (int i = 0; i < 15; ++i) E[i] = __ldg(in.table + (2 + px.slot) * kTableRow + i);

  // 3. prior; 4a. epipolar segment in the born image (implement.cpp:23-47)
  px.prior_d = px.ref_depth - T[12];  // rel_xi[2] (mapper.cpp:104)
  px.prior_s = px.ref_sigma;
  const float oxf = (float)oxc, oyf = (float)oyc;
  px.dmin = fmaxf(px.prior_d - px.prior_s, in.min_search_depth);
  px.dmax = px.prior_d + px.prior_s;
  const Projected s0 = warp_point(K, E, oxf, oyf, px.dmax);
  const Projected s1 = warp_point(K, E, oxf, oyf, px.dmin);
  const float segx = s1.u - s0.u;
  const float segy = s1.v - s0.v;
  px.length = sqrtf(segx * segx + segy * segy + 1e-20f);
  const bool seg_ok = px.length > 1e-6f && s0.in_front && s1.in_front && px.dmax > px.dmin;
  px.sx = s0.u;
  px.sy = s0.v;
  px.dx = segx / px.length;
  px.dy = segy / px.length;

  // triangulation coefficients (implement.cpp:49-71)
  const float q0 = (oxf - K[2]) / K[0];
  const float q1 = (oyf - K[5]) / K[4];
  px.r3q = E[6] * q0 + E[7] * q1 + E[8];
  const float r0 = E[0] * q0 + E[1] * q1 + E[2];
  const float r1 = E[3] * q0 + E[4] * q1 + E[5];
  const float r2 = px.r3q;
  px.krq0 = K[0] * r0 + K[1] * r1 + K[2] * r2;
  px.krq1 = K[3] * r0 + K[4] * r1 + K[5] * r2;
  px.krq2 = K[6] * r0 + K[7] * r1 + K[8] * r2;
  const float t0 = E[12], t1 = E[13], t2 = E[14];
  px.ttz = t2;
  px.kt0 = K[0] * t0 + K[1] * t1 + K[2] * t2;
  px.kt1 = K[3] * t0 + K[4] * t1 + K[5] * t2;
  px.kt2 = K[6] * t0 + K[7] * t1 + K[8] * t2;
  px.base_ok = pix_ok && seg_ok;
  return px;
}

struct Match {
  float min_ssd;
  int best_s;  // window index i: offsets i, i + 1, i + 2; the match at i + 1
};

// One marched sample: the squared difference at offset o and whether its
// base corner lies in the image (getSubpixelFromDense's validity).
__device__ __forceinline__ void sample(const float* __restrict__ gray, const Pixel& px, int o,
                                       int h, int w, float* d2, bool* ok) {
  const float of = (float)o;
  const Corners c = corners(px.sx + of * px.dx, px.sy + of * px.dy, h, w);
  const float v = sample_dense(gray, w, c);
  const float d = v - px.obj_v;
  *d2 = d * d;
  *ok = c.in0;
}

// The masked SSD march (implement.cpp:106-152) of one pixel by the kLanes
// lanes of a group, all of which call with the same px and the group's row
// of shared memory (at least s.steps + 2 floats); every lane returns the
// result.  Pass 1 deals the offsets o = 0 .. n_off - 1 to the lanes (lane l
// takes o = l, l + kLanes, ...): each sample is taken once and its squared
// difference stored at row[o], -1 where the sample's base corner lies
// outside the image.  No lane waits for another there, so the gathers of
// several offsets are in flight at once.  Pass 2 deals the windows the same
// way: window i reads row[i], row[i + 1], row[i + 2] and applies the weights
// in the order of the plain version (w0 * d2[i] + w1 * d2[i+1] + w2 *
// d2[i+2]), so each window's SSD has the plain version's bits.  A lane keeps
// the first strict minimum of its own windows (their indices rise); the
// group's result is the butterfly minimum over (ssd, index), the smaller
// index on equal ssd: the sequential loop's first strict minimum,
// (big_ssd, 0) when no window is valid.  The butterfly's shuffles also keep
// any lane from overwriting the row while another still reads it.
// (Measured and dropped: the windows taken from the neighbouring lanes'
// registers by shuffle instead of the row — a lane then stalls on its own
// gathers once per chunk before it can hand them on; PERF.md section 6.)
__device__ __forceinline__ Match march(const float* __restrict__ gray, const Pixel& px,
                                       const Scalars& s, int lane, unsigned group_mask,
                                       float* __restrict__ row) {
  const float w0 = (float)(1.0 / 3.0), w1 = (float)(2.0 / 3.0), w2 = 1.0f;
  const int n_off = (int)fminf(ceilf(px.length) + 4.0f, (float)(s.steps + 2));
#pragma unroll kUnroll
  for (int o = lane; o < n_off; o += kLanes) {
    float d2;
    bool ok;
    sample(gray, px, o, s.h, s.w, &d2, &ok);
    row[o] = ok ? d2 : -1.0f;  // d2 is a square: never negative
  }
  __syncwarp(group_mask);
  Match m{s.big_ssd, 0};
  for (int i = lane; i + 2 < n_off; i += kLanes) {
    const float d2 = row[i], d2p1 = row[i + 1], d2p2 = row[i + 2];
    const bool win_ok = d2 >= 0.0f && d2p1 >= 0.0f && d2p2 >= 0.0f && (float)i < px.length;
    const float ssd = win_ok ? w0 * d2 + w1 * d2p1 + w2 * d2p2 : s.big_ssd;
    if (ssd < m.min_ssd) {
      m.min_ssd = ssd;
      m.best_s = i;
    }
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) {
    const float o_ssd = __shfl_xor_sync(group_mask, m.min_ssd, off, kLanes);
    const int o_s = __shfl_xor_sync(group_mask, m.best_s, off, kLanes);
    if (o_ssd < m.min_ssd || (o_ssd == m.min_ssd && o_s < m.best_s)) {
      m.min_ssd = o_ssd;
      m.best_s = o_s;
    }
  }
  return m;
}

struct Ring {
  const float* gray;
  const float* gx;
  const float* gy;
  const uint8_t* gmask;
};

struct Flags {
  bool observed, accepted, rejected;
};

// Everything after the march, one thread per pixel: writes the pixel's
// depth, sigma and age and returns its three counts' flags.
__device__ __forceinline__ Flags finish(const Pixel& px, Match m, const Ring& ring,
                                        const Scalars& s, int p, float* __restrict__ depth_out,
                                        float* __restrict__ sigma_out,
                                        int32_t* __restrict__ age_out) {
  Flags fl{false, false, false};
  if (!px.base_ok) {  // no observation: the maps keep their values
    depth_out[p] = px.ref_depth;
    sigma_out[p] = px.ref_sigma;
    age_out[p] = px.ref_age;
    return fl;
  }
  const size_t plane = (size_t)px.slot * s.h * s.w;
  bool match_ok = m.min_ssd <= s.match_thresh;
  const float best_o = (float)m.best_s + 1.0f;
  const float mx = px.sx + best_o * px.dx;
  const float my = px.sy + best_o * px.dy;
  // bounds gate on the match, inclusive (implement.cpp:186-190)
  match_ok = match_ok && mx >= 0.0f && my >= 0.0f && mx <= (float)s.w && my <= (float)s.h;

  // ---- nearest gradient sample at the match ----
  const int bxi = to_index(rintf(mx), s.w);
  const int byi = to_index(rintf(my), s.h);
  const bool g_in = bxi >= 0 && bxi < s.w && byi >= 0 && byi < s.h;
  const size_t gi = plane + (size_t)clampi(byi, 0, s.h - 1) * s.w + clampi(bxi, 0, s.w - 1);
  const float gxv = ring.gx[gi];
  const float gyv = ring.gy[gi];
  const bool g_ok = g_in && ring.gmask[gi] != 0;

  // ---- triangulation (depthEstimate, implement.cpp:49-71) ----
  const float a0 = px.r3q * mx - px.krq0;
  const float a1 = px.r3q * my - px.krq1;
  const float a2 = px.r3q - px.krq2;
  const float b0 = px.ttz * mx - px.kt0;
  const float b1 = px.ttz * my - px.kt1;
  const float b2 = px.ttz - px.kt2;
  const float a_dot_a = a0 * a0 + a1 * a1 + a2 * a2;
  const float a_dot_b = a0 * b0 + a1 * b1 + a2 * b2;
  const float new_depth = -a_dot_b / (a_dot_a < 1e-20f ? 1.0f : a_dot_a);

  // ---- sigma model (sigmaEstimate, implement.cpp:73-104) ----
  const float g_dot_l = fabsf(gxv * (-px.dx) + gyv * (-px.dy));
  const float gp2 = g_dot_l / px.length;
  const float epi = s.epi_sigma2 / fmaxf(g_dot_l * g_dot_l, 1e-6f);
  const float lum = s.lum_2sigma2 / fmaxf(gp2, 1e-6f);
  const float alpha = (px.dmax - px.dmin) / px.length;
  const float new_sigma = alpha * sqrtf(epi + lum);

  // ---- observation gates (mapper.cpp:122) ----
  fl.observed = match_ok && g_ok && new_depth > s.accept_d_lo && new_depth < s.accept_d_hi &&
                new_sigma > s.accept_s_lo && new_sigma < s.accept_s_hi;

  // ---- Gaussian update with reset (gaussian.cpp:12-31) ----
  const float mu = px.prior_d;
  const float sg = px.prior_s;
  const float diff = fabsf(new_depth - mu);
  const float mm = fminf(new_depth, diff);
  const float gain = mm < s.gain_ramp ? 0.5f + mm / s.gain_ramp * 0.5f : 1.0f;
  const bool gate_ok = diff <= gain * fmaxf(sg, new_sigma);
  fl.accepted = gate_ok && fl.observed;
  fl.rejected = !gate_ok && fl.observed;
  const float v1 = sg * sg;
  const float v2 = new_sigma * new_sigma;
  const float v = v1 + v2;
  const float safe_v = v < 1e-12f ? 1.0f : v;
  const float mu_new = (v2 * mu + v1 * new_depth) / safe_v;
  const float sigma_new = sqrtf(v1 * v2 / safe_v);

  depth_out[p] = fl.accepted ? mu_new : (fl.rejected ? px.reset_d : px.ref_depth);
  sigma_out[p] = fl.accepted ? sigma_new : (fl.rejected ? s.reset_sigma : px.ref_sigma);
  age_out[p] = fl.rejected ? 0 : px.ref_age;
  return fl;
}

}  // namespace epi
}  // namespace dvo
