// Epipolar depth observation fused with the Gaussian depth filter, one
// thread per reference pixel.
//
// Replaces the Pallas kernel dvo_tpu/ops/pallas/epipolar.py:
// _epipolar_kernel (reached through epipolar_update_pallas) and follows the
// XLA twin dvo_tpu/models/mapper.py:depth_update, which is exact: each
// pixel samples its born keyframe from the FULL ring in float32 (no
// gather_slots, gather_window or bf16 stacks — those only shrink the TPU's
// one-hot matmul gathers).  Per pixel (reference implement.cpp:49-152,
// mapper.cpp:122-131, gaussian.cpp:12-31):
//   * march 1-px samples along the segment start + o * dir, o = 0, 1, ...,
//     up to min(ceil(length) + 4, S + 2) offsets — exactly the XLA twin's
//     S windows, since windows with (s - 1) >= length are masked there;
//   * 3-tap weighted SSD (1/3, 2/3, 1) over offsets (s-1, s, s+1), first
//     strict minimum (jnp.argmin);
//   * match and bounds gates, nearest gradient sample at the match (rint,
//     half to even), triangulation, Engel13 sigma model, acceptance gates;
//   * gated Gaussian fusion with the pre-drawn reset depth on rejection.
// The 24 per-pixel input planes are prepared in plain PyTorch
// (models/mapper.depth_update), as depth_update_pallas prepares them in
// XLA; the plane order is that of dvo_tpu/ops/pallas/epipolar.py.
//
// What bounds it on the card: the march — up to 104 dependent bilinear
// gathers (4 loads each) per pixel from a per-pixel keyframe slot, with
// lengths that vary across a warp.  Design: real gathers from the f32 ring
// (L1/L2-resident: 8 x 120 x 160 x 4 B = 614 KB per plane), the march stops
// at each pixel's own segment length, the SSD window slides in registers
// (each sample is taken once), and everything after the march is
// per-thread register math; only the three maps and a per-block row of
// three counts are written (the wrapper sums the rows — no atomics).

#include "dvo_kernels.h"

namespace {

constexpr int kThreads = 128;

enum Field {
  F_START_X, F_START_Y, F_DIR_X, F_DIR_Y, F_LENGTH, F_OBJ_VAL, F_SLOT,
  F_PRIOR_D, F_PRIOR_S, F_DMIN, F_DMAX,
  F_R3Q, F_KRQ0, F_KRQ1, F_KRQ2, F_TTZ, F_KT0, F_KT1, F_KT2,
  F_REF_DEPTH, F_REF_SIGMA, F_REF_AGE, F_BASE_OK, F_RESET_D,
  N_FIELDS
};

struct EpiScalars {
  int h, w, capacity, steps;  // steps = S: windows 1..S, samples 0..S+1
  float match_thresh, big_ssd, epi_sigma2, lum_2sigma2;
  float accept_d_lo, accept_d_hi, accept_s_lo, accept_s_hi;
  float gain_ramp, reset_sigma;
};

__global__ void __launch_bounds__(kThreads)
epipolar_kernel(const float* __restrict__ fields, const float* __restrict__ born_gray,
                const float* __restrict__ born_gx, const float* __restrict__ born_gy,
                const uint8_t* __restrict__ born_gmask, float* __restrict__ depth_out,
                float* __restrict__ sigma_out, int32_t* __restrict__ age_out,
                int32_t* __restrict__ stats, EpiScalars s) {
  __shared__ int32_t warp_counts[kThreads / 32][3];
  const int n = s.h * s.w;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  bool obs_ok = false, ok = false, rejected = false;

  if (p < n) {
    const float* f = fields + p;
#define FIELD(k) f[(size_t)(k) * n]
    const bool base_ok = FIELD(F_BASE_OK) > 0.5f;
    const float sx = FIELD(F_START_X), sy = FIELD(F_START_Y);
    const float dx = FIELD(F_DIR_X), dy = FIELD(F_DIR_Y);
    const float length = FIELD(F_LENGTH);
    const float obj_v = FIELD(F_OBJ_VAL);
    const int slot = dvo::clampi((int)FIELD(F_SLOT), 0, s.capacity - 1);
    const size_t plane = (size_t)slot * n;
    const float* gray = born_gray + plane;

    // ---- masked SSD march (implement.cpp:106-152) ----
    const float w0 = (float)(1.0 / 3.0), w1 = (float)(2.0 / 3.0), w2 = 1.0f;
    float min_ssd = s.big_ssd;
    int best_s = 0;  // window index i: offsets i, i+1, i+2; match at i+1
    if (base_ok) {
      const int n_off = (int)fminf(ceilf(length) + 4.0f, (float)(s.steps + 2));
      float d2p2 = 0.0f, d2p1 = 0.0f;
      bool okp2 = false, okp1 = false;
      for (int o = 0; o < n_off; ++o) {
        const float of = (float)o;
        const dvo::Corners c = dvo::corners(sx + of * dx, sy + of * dy, s.h, s.w);
        const float v = dvo::sample_dense(gray, s.w, c);
        const float d = v - obj_v;
        const float d2 = d * d;
        if (o >= 2) {
          const bool win_ok = okp2 && okp1 && c.in0 && (of - 2.0f) < length;
          const float ssd = win_ok ? w0 * d2p2 + w1 * d2p1 + w2 * d2 : s.big_ssd;
          if (ssd < min_ssd) {
            min_ssd = ssd;
            best_s = o - 2;
          }
        }
        d2p2 = d2p1;
        d2p1 = d2;
        okp2 = okp1;
        okp1 = c.in0;
      }
    }
    bool match_ok = min_ssd <= s.match_thresh;
    const float best_o = (float)best_s + 1.0f;
    const float mx = sx + best_o * dx;
    const float my = sy + best_o * dy;
    // bounds gate on the match, inclusive (implement.cpp:186-190)
    match_ok = match_ok && mx >= 0.0f && my >= 0.0f && mx <= (float)s.w && my <= (float)s.h;

    // ---- nearest gradient sample at the match ----
    const int bxi = dvo::to_index(rintf(mx), s.w);
    const int byi = dvo::to_index(rintf(my), s.h);
    const bool g_in = bxi >= 0 && bxi < s.w && byi >= 0 && byi < s.h;
    const size_t gi = plane + (size_t)dvo::clampi(byi, 0, s.h - 1) * s.w +
                      dvo::clampi(bxi, 0, s.w - 1);
    const float gxv = born_gx[gi];
    const float gyv = born_gy[gi];
    const bool g_ok = g_in && born_gmask[gi] != 0;

    // ---- triangulation (depthEstimate, implement.cpp:49-71) ----
    const float r3q = FIELD(F_R3Q);
    const float a0 = r3q * mx - FIELD(F_KRQ0);
    const float a1 = r3q * my - FIELD(F_KRQ1);
    const float a2 = r3q - FIELD(F_KRQ2);
    const float ttz = FIELD(F_TTZ);
    const float b0 = ttz * mx - FIELD(F_KT0);
    const float b1 = ttz * my - FIELD(F_KT1);
    const float b2 = ttz - FIELD(F_KT2);
    const float a_dot_a = a0 * a0 + a1 * a1 + a2 * a2;
    const float a_dot_b = a0 * b0 + a1 * b1 + a2 * b2;
    const float new_depth = -a_dot_b / (a_dot_a < 1e-20f ? 1.0f : a_dot_a);

    // ---- sigma model (sigmaEstimate, implement.cpp:73-104) ----
    const float g_dot_l = fabsf(gxv * (-dx) + gyv * (-dy));
    const float gp2 = g_dot_l / length;
    const float epi = s.epi_sigma2 / fmaxf(g_dot_l * g_dot_l, 1e-6f);
    const float lum = s.lum_2sigma2 / fmaxf(gp2, 1e-6f);
    const float alpha = (FIELD(F_DMAX) - FIELD(F_DMIN)) / length;
    const float new_sigma = alpha * sqrtf(epi + lum);

    // ---- observation gates (mapper.cpp:122) ----
    obs_ok = base_ok && match_ok && g_ok && new_depth > s.accept_d_lo &&
             new_depth < s.accept_d_hi && new_sigma > s.accept_s_lo &&
             new_sigma < s.accept_s_hi;

    // ---- Gaussian update with reset (gaussian.cpp:12-31) ----
    const float mu = FIELD(F_PRIOR_D);
    const float sg = FIELD(F_PRIOR_S);
    const float diff = fabsf(new_depth - mu);
    const float m = fminf(new_depth, diff);
    const float gain = m < s.gain_ramp ? 0.5f + m / s.gain_ramp * 0.5f : 1.0f;
    const bool gate_ok = diff <= gain * fmaxf(sg, new_sigma);
    ok = gate_ok && obs_ok;
    rejected = !gate_ok && obs_ok;
    const float v1 = sg * sg;
    const float v2 = new_sigma * new_sigma;
    const float v = v1 + v2;
    const float safe_v = v < 1e-12f ? 1.0f : v;
    const float mu_new = (v2 * mu + v1 * new_depth) / safe_v;
    const float sigma_new = sqrtf(v1 * v2 / safe_v);

    depth_out[p] = ok ? mu_new : (rejected ? FIELD(F_RESET_D) : FIELD(F_REF_DEPTH));
    sigma_out[p] = ok ? sigma_new : (rejected ? s.reset_sigma : FIELD(F_REF_SIGMA));
    age_out[p] = rejected ? 0 : (int32_t)FIELD(F_REF_AGE);
#undef FIELD
  }

  // Per-block (observed, accepted, rejected) counts; fixed order, no atomics.
  const unsigned full = 0xffffffffu;
  const int c_obs = __popc(__ballot_sync(full, obs_ok));
  const int c_ok = __popc(__ballot_sync(full, ok));
  const int c_rej = __popc(__ballot_sync(full, rejected));
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    warp_counts[warp][0] = c_obs;
    warp_counts[warp][1] = c_ok;
    warp_counts[warp][2] = c_rej;
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    int32_t total = 0;
#pragma unroll
    for (int wi = 0; wi < kThreads / 32; ++wi) total += warp_counts[wi][threadIdx.x];
    stats[blockIdx.x * 3 + threadIdx.x] = total;
  }
}

}  // namespace

extern "C" int dvo_epipolar_num_blocks(int n) { return (n + kThreads - 1) / kThreads; }

extern "C" int dvo_epipolar(const float* fields, const float* born_gray, const float* born_gx,
                            const float* born_gy, const uint8_t* born_gmask, float* depth_out,
                            float* sigma_out, int32_t* age_out, int32_t* stats, int h, int w,
                            int capacity, int steps, float match_thresh, float big_ssd,
                            float epi_sigma2, float lum_2sigma2, float accept_d_lo,
                            float accept_d_hi, float accept_s_lo, float accept_s_hi,
                            float gain_ramp, float reset_sigma, void* stream) {
  const EpiScalars s{h, w, capacity, steps, match_thresh, big_ssd, epi_sigma2, lum_2sigma2,
                     accept_d_lo, accept_d_hi, accept_s_lo, accept_s_hi, gain_ramp,
                     reset_sigma};
  epipolar_kernel<<<dvo_epipolar_num_blocks(h * w), kThreads, 0, (cudaStream_t)stream>>>(
      fields, born_gray, born_gx, born_gy, born_gmask, depth_out, sigma_out, age_out, stats,
      s);
  return (int)cudaGetLastError();
}
