// The step's pose algebra: each region of the graphed step's `pose` stage
// (models/odometry.py, models/mapper.pose_table) in one launch.
//
// Replaces no TPU kernel: dvo_tpu leaves this algebra (dvo_tpu/lie.py as
// the step calls it) to XLA, which fuses it under jit into a few fusions.
// Eager on the card, the same algebra was one launch an op: 761 a monocular
// frame, 308 an RGB-D frame, each ~1.2 us against an empty launch's 0.87.
//
// What bounds it on the card.  A region reads and writes well under a
// kilobyte and computes a few thousand float operations (3x3 products,
// sines, an arccosine): nanoseconds at the card's rates.  So the launch and
// one thread's chain of dependent trigonometry bound each launch.
//
// Design.  One launch a region, one warp a launch; the lanes take the
// region's independent jobs (the table: one lane a row, so one a ring
// slot).  Each job is lie.py's chain with its branches and constants (the
// small-angle Taylor terms, so3_log's clamp at -1 + 1e-7, the zero w below
// 1e-6), on gn_step.cuh's Mat3, hat and eye_plus.  Its products and sums
// are not gn_step.cuh's: they round as the library rounds lie.py's on this
// card, so that an entry gives the plain version's bits.  The monocular
// mapper follows float noise (an ulp in a pose moves rint'ed coordinates
// and gated observations), so a kernel a few ulps off the plain version
// left 10% of the keyframe's pixels off the benchmark's reference after a
// chunk, against none before.  Measured on an H100 with torch 2.11 and CUDA
// 12.8 (every one of 4,096 random draws a form):
//   * a 3x3 product of one matrix, and every product with a vector:
//     fma(a1, b1, a0 b0) + a2 b2;
//   * a batched 3x3 product, and (4, 4) @ (C, 4, 4): the fma chain
//     fma(a2, b2, fma(a1, b1, a0 b0)) (and fma(a3, b3, .) for 4 terms);
//   * a 4x4 product of one matrix: fma(a1, b1, a0 b0) + fma(a3, b3, a2 b2);
//   * sum(w * w) over 3: (w0^2 + w2^2) + w1^2.
// The step's twists are single (kOne); the table's are batched (kBatch) in
// the plain version.  compose(a, b) is se3_log of the 4x4 product of the
// exponentials, the homogeneous row's 0s and 1 included.  -fmad=false keeps
// every other operation rounded on its own, as the plain version's ops
// are.  A kernel writes every element of its outputs, the zeros and the
// final 1 of a 4x4 included, so no fill is left.
//
// Entries (ops/cuda/pose.py holds the plain version of each: the lie.py
// call sequence it replaces):
//   * dvo_pose_warm  — xi0 = where(|x| < max_norm, x, 0), x = a (b null) or
//     compose(a, b): the warm start (RGB-D: a = vel; mono: prev_rel, vel);
//   * dvo_pose_track — frame_xi = compose(ref_xi, rel_xi); with prev_rel,
//     vel = compose(-prev_rel, rel_xi) (mono); with T_world,
//     T_world = exp(frame_xi) (RGB-D);
//   * dvo_pose_table — models/mapper.pose_table's (2 + C, 16) table;
//   * dvo_pose_emit  — T_world = exp(need_kf ? ref_xi : frame_xi) and
//     prev_rel = need_kf ? 0 : rel_xi (mono, after the mapper).

#include "gn_step.cuh"

namespace {

using dvo::Mat3;

constexpr int kTableRow = 16;  // ops/cuda/epipolar.TABLE_ROW
constexpr bool kOne = false;   // the products of one twist (torch.mm)
constexpr bool kBatch = true;  // the products of a batch of twists (torch.bmm)

__device__ __forceinline__ void load6(const float* src, float x[6], bool negate = false) {
#pragma unroll
  for (int i = 0; i < 6; ++i) x[i] = negate ? -src[i] : src[i];
}

// a0 b0 + a1 b1 + a2 b2 as the library sums it (header note)
template <bool kBatched>
__device__ __forceinline__ float dot3(float a0, float b0, float a1, float b1, float a2,
                                      float b2) {
  return kBatched ? __fmaf_rn(a2, b2, __fmaf_rn(a1, b1, a0 * b0))
                  : __fmaf_rn(a1, b1, a0 * b0) + a2 * b2;
}

__device__ __forceinline__ float theta(const float w[3]) {
  return sqrtf((w[0] * w[0] + w[2] * w[2]) + w[1] * w[1] + 1e-24f);
}

template <bool kBatched>
__device__ __forceinline__ Mat3 square(const Mat3& W) {
  Mat3 C;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      C.m[i][j] = dot3<kBatched>(W.m[i][0], W.m[0][j], W.m[i][1], W.m[1][j], W.m[i][2],
                                 W.m[2][j]);
    }
  }
  return C;
}

__device__ __forceinline__ void apply(const Mat3& A, const float x[3], float y[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) y[i] = dot3<kOne>(A.m[i][0], x[0], A.m[i][1], x[1], A.m[i][2], x[2]);
}

// lie.py se3_exp: R = so3_exp(w), t = V v
template <bool kBatched>
__device__ void se3_exp(const float xi[6], Mat3* R, float t[3]) {
  const float* v = xi;
  const float* w = xi + 3;
  const float th = theta(w);
  const Mat3 W = dvo::hat(w);
  const Mat3 W2 = square<kBatched>(W);
  const bool small = th < dvo::kSmall;
  const float ths = small ? 1.0f : th;
  float sn, cs;  // sincosf: sinf's and cosf's bits, one argument reduction
  sincosf(ths, &sn, &cs);
  const float a = small ? 1.0f - th * th / 6.0f : sn / ths;
  const float b = small ? 0.5f - th * th / 24.0f : (1.0f - cs) / (ths * ths);
  const float c = small ? 1.0f / 6.0f - th * th / 120.0f : (ths - sn) / (ths * ths * ths);
  *R = dvo::eye_plus(a, W, b, W2);
  const Mat3 V = dvo::eye_plus(b, W, c, W2);
  apply(V, v, t);
}

// lie.py se3_log (with so3_log)
template <bool kBatched>
__device__ void se3_log(const Mat3& R, const float t[3], float xi[6]) {
  const float trace = (R.m[0][0] + R.m[1][1]) + R.m[2][2];
  const float cos_th = fminf(fmaxf((trace - 1.0f) * 0.5f, -0.9999999f), 1.0f);
  const float th0 = acosf(cos_th);
  const float vee[3] = {R.m[2][1] - R.m[1][2], R.m[0][2] - R.m[2][0],
                        R.m[1][0] - R.m[0][1]};
  const bool small0 = th0 < dvo::kSmall;
  const float ths0 = small0 ? 1.0f : th0;
  const float scale = small0 ? 0.5f : ths0 / (2.0f * sinf(ths0));
  float w[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) w[i] = small0 ? 0.0f : scale * vee[i];

  const float th = theta(w);
  const Mat3 W = dvo::hat(w);
  const Mat3 W2 = square<kBatched>(W);
  const bool small = th < dvo::kSmall;
  const float half = th * 0.5f;
  float hs, hc;
  sincosf(half, &hs, &hc);
  const float cot_term =
      small ? 1.0f / 12.0f + th * th / 720.0f : (1.0f - half * hc / hs) / (th * th);
  const Mat3 V_inv = dvo::eye_plus(-0.5f, W, cot_term, W2);
  apply(V_inv, t, xi);
#pragma unroll
  for (int i = 0; i < 3; ++i) xi[3 + i] = w[i];
}

// lie.compose: se3_log(se3_exp(a) @ se3_exp(b)), the 4x4 product with the
// homogeneous row (0, 0, 0, 1) of b as the library rounds it.
template <bool kBatched>
__device__ void compose(const float a[6], const float b[6], float out[6]) {
  Mat3 Ra, Rb, R;
  float ta[3], tb[3], t[3];
  se3_exp<kBatched>(a, &Ra, ta);
  se3_exp<kBatched>(b, &Rb, tb);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float b0 = j < 3 ? Rb.m[0][j] : tb[0];
      const float b1 = j < 3 ? Rb.m[1][j] : tb[1];
      const float b2 = j < 3 ? Rb.m[2][j] : tb[2];
      const float b3 = j < 3 ? 0.0f : 1.0f;
      const float front = __fmaf_rn(Ra.m[i][1], b1, Ra.m[i][0] * b0);
      const float v = kBatched ? __fmaf_rn(ta[i], b3, __fmaf_rn(Ra.m[i][2], b2, front))
                               : front + __fmaf_rn(ta[i], b3, Ra.m[i][2] * b2);
      if (j < 3) {
        R.m[i][j] = v;
      } else {
        t[i] = v;
      }
    }
  }
  se3_log<kBatched>(R, t, out);
}

// lie.se3_exp of one twist into a row-major 4x4, every element written
__device__ void exp4(const float xi[6], float* T) {
  Mat3 R;
  float t[3];
  se3_exp<kOne>(xi, &R, t);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) T[4 * i + j] = R.m[i][j];
    T[4 * i + 3] = t[i];
  }
  T[12] = 0.0f;
  T[13] = 0.0f;
  T[14] = 0.0f;
  T[15] = 1.0f;
}

__global__ void __launch_bounds__(32)
warm_kernel(const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ xi0,
            float max_norm) {
  if (threadIdx.x != 0) return;
  float x[6];
  if (b != nullptr) {
    float p[6], q[6];
    load6(a, p);
    load6(b, q);
    compose<kOne>(p, q, x);
  } else {
    load6(a, x);
  }
  float sq = 0.0f;  // torch.linalg.vector_norm
#pragma unroll
  for (int i = 0; i < 6; ++i) sq = sq + x[i] * x[i];
  const bool keep = sqrtf(sq) < max_norm;
#pragma unroll
  for (int i = 0; i < 6; ++i) xi0[i] = keep ? x[i] : 0.0f;
}

// Lane 0: the frame's world twist (and T_world); lane 1: the velocity.
__global__ void __launch_bounds__(32)
track_kernel(const float* __restrict__ ref_xi, const float* __restrict__ rel_xi,
             const float* __restrict__ prev_rel, float* __restrict__ frame_xi,
             float* __restrict__ vel, float* __restrict__ T_world) {
  float rel[6], x[6], out[6];
  load6(rel_xi, rel);
  if (threadIdx.x == 0) {
    load6(ref_xi, x);
    compose<kOne>(x, rel, out);
#pragma unroll
    for (int i = 0; i < 6; ++i) frame_xi[i] = out[i];
    if (T_world != nullptr) exp4(out, T_world);
  } else if (threadIdx.x == 1 && vel != nullptr) {
    load6(prev_rel, x, true);
    compose<kOne>(x, rel, out);
#pragma unroll
    for (int i = 0; i < 6; ++i) vel[i] = out[i];
  }
}

// Row r of the table in lane r (rows past 32 in lane r % 32): row 0 K, row
// 1 exp(rel_xi) and rel_xi[2], row 2 + c ring slot c's T_es = exp(-r_xi)
// with r_xi = compose(obj_xi_w, -hist_xi[c]), and t_tw = -r_xi[:3].
__global__ void __launch_bounds__(32)
table_kernel(const float* __restrict__ K, const float* __restrict__ obj_xi_w,
             const float* __restrict__ rel_xi, const float* __restrict__ hist_xi,
             float* __restrict__ table, int capacity) {
  for (int r = threadIdx.x; r < 2 + capacity; r += blockDim.x) {
    float T[12];                               // columns 0-11: K, or R row-major and t
    float tail[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // columns 12-15
    if (r == 0) {
#pragma unroll
      for (int i = 0; i < 9; ++i) T[i] = K[i];
      T[9] = 0.0f;
      T[10] = 0.0f;
      T[11] = 0.0f;
    } else {
      float xi[6];
      if (r == 1) {
        load6(rel_xi, xi);
        tail[0] = xi[2];
      } else {
        float obj[6], inv[6], r_xi[6];
        load6(obj_xi_w, obj);
        load6(hist_xi + 6 * (r - 2), inv, true);
        compose<kBatch>(obj, inv, r_xi);
#pragma unroll
        for (int i = 0; i < 6; ++i) xi[i] = -r_xi[i];
#pragma unroll
        for (int i = 0; i < 3; ++i) tail[i] = xi[i];
      }
      Mat3 R;
      float t[3];
      se3_exp<kBatch>(xi, &R, t);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
#pragma unroll
        for (int j = 0; j < 3; ++j) T[3 * i + j] = R.m[i][j];
        T[9 + i] = t[i];
      }
    }
    float* row = table + r * kTableRow;
#pragma unroll
    for (int i = 0; i < 12; ++i) row[i] = T[i];
#pragma unroll
    for (int i = 0; i < 4; ++i) row[12 + i] = tail[i];
  }
}

__global__ void __launch_bounds__(32)
emit_kernel(const bool* __restrict__ need_kf, const float* __restrict__ ref_xi,
            const float* __restrict__ frame_xi, const float* __restrict__ rel_xi,
            float* __restrict__ T_world, float* __restrict__ prev_rel) {
  if (threadIdx.x != 0) return;
  const bool kf = *need_kf;
  float x[6];
  load6(kf ? ref_xi : frame_xi, x);
  exp4(x, T_world);
#pragma unroll
  for (int i = 0; i < 6; ++i) prev_rel[i] = kf ? 0.0f : rel_xi[i];
}

}  // namespace

// Every pointer is device memory of float32 (need_kf: one bool); twists are
// 6 values, T_world 16 (row-major 4x4).  One block of 32 threads each.

// b: null for the RGB-D form (x = a).
extern "C" int dvo_pose_warm(const float* a, const float* b, float* xi0, float max_norm,
                             void* stream) {
  warm_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(a, b, xi0, max_norm);
  return (int)cudaGetLastError();
}

// prev_rel and vel: both or neither (RGB-D); T_world: null unless asked.
extern "C" int dvo_pose_track(const float* ref_xi, const float* rel_xi, const float* prev_rel,
                              float* frame_xi, float* vel, float* T_world, void* stream) {
  if ((prev_rel == nullptr) != (vel == nullptr)) return (int)cudaErrorInvalidValue;
  track_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(ref_xi, rel_xi, prev_rel, frame_xi, vel,
                                                    T_world);
  return (int)cudaGetLastError();
}

// K: 9 values (row-major 3x3); hist_xi: (capacity, 6); table: (2 + capacity, 16).
extern "C" int dvo_pose_table(const float* K, const float* obj_xi_w, const float* rel_xi,
                              const float* hist_xi, float* table, int capacity, void* stream) {
  if (capacity < 1) return (int)cudaErrorInvalidValue;
  table_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(K, obj_xi_w, rel_xi, hist_xi, table,
                                                    capacity);
  return (int)cudaGetLastError();
}

extern "C" int dvo_pose_emit(const bool* need_kf, const float* ref_xi, const float* frame_xi,
                             const float* rel_xi, float* T_world, float* prev_rel,
                             void* stream) {
  emit_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(need_kf, ref_xi, frame_xi, rel_xi, T_world,
                                                   prev_rel);
  return (int)cudaGetLastError();
}
