// One Gauss-Newton step's solve and pose update on the device, from a
// level's 29 sums (21 lower-triangle H, 6 g, r^2, count): a float32 6x6
// Cholesky solve, SE(3) exp/log composition with the branches and constants
// of dvo_tpu_torch/lie.py, the NaN guard and the convergence test
// (tracker.py: gn_solve, lie.compose, optimize.cpp:93-94, tracker.cpp:47-73).
// Shared by gn_level.cu (a level's whole loop in one launch) and gn.cu's
// step kernel (one launch per step of the tile-sharded loop, after the sums'
// all-reduce).  The solve and the step run on a whole warp (solve6, gn_step):
// the lanes share the work, and every element keeps the operation order of
// the one-thread code they replace, bit for bit.
// tests/test_torch_gn_level.py transcribes it scalar by scalar and lane by
// lane: keep the two, and lie.py's operation order, together.
#pragma once

#include "dvo_kernels.h"

// A build may mark the step's stages (gn_level.cu with DVO_GN_LEVEL_STAMPS).
#ifndef DVO_STEP_MARK
#define DVO_STEP_MARK(k)
#endif

namespace dvo {

constexpr int kGNSums = 29;   // 21 lower-triangle H + 6 g + r^2 + count
constexpr int kGNState = 19;  // T_inv rows 0-2 (12) | xi (6) | done
constexpr float kSmall = 1e-6f;  // lie.py _SMALL

struct Mat3 {
  float m[3][3];
};

__device__ __forceinline__ float theta(const float w[3]) {
  return sqrtf((w[0] * w[0] + w[1] * w[1]) + w[2] * w[2] + 1e-24f);
}

__device__ __forceinline__ Mat3 hat(const float w[3]) {
  Mat3 W;
  W.m[0][0] = 0.0f;  W.m[0][1] = -w[2]; W.m[0][2] = w[1];
  W.m[1][0] = w[2];  W.m[1][1] = 0.0f;  W.m[1][2] = -w[0];
  W.m[2][0] = -w[1]; W.m[2][1] = w[0];  W.m[2][2] = 0.0f;
  return W;
}

__device__ __forceinline__ Mat3 matmul(const Mat3& A, const Mat3& B) {
  Mat3 C;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      C.m[i][j] = (A.m[i][0] * B.m[0][j] + A.m[i][1] * B.m[1][j]) + A.m[i][2] * B.m[2][j];
    }
  }
  return C;
}

// I + a W + b W2 (lie.py so3_exp, se3_exp's V, se3_log's V_inv)
__device__ __forceinline__ Mat3 eye_plus(float a, const Mat3& W, float b, const Mat3& W2) {
  Mat3 R;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      R.m[i][j] = ((i == j ? 1.0f : 0.0f) + a * W.m[i][j]) + b * W2.m[i][j];
    }
  }
  return R;
}

__device__ __forceinline__ void matvec(const Mat3& A, const float x[3], float y[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    y[i] = (A.m[i][0] * x[0] + A.m[i][1] * x[1]) + A.m[i][2] * x[2];
  }
}

// lie.py se3_exp: R = so3_exp(w), t = V v
__device__ inline void se3_exp(const float xi[6], Mat3* R, float t[3]) {
  const float* v = xi;
  const float* w = xi + 3;
  const float th = theta(w);
  const Mat3 W = hat(w);
  const Mat3 W2 = matmul(W, W);
  const bool small = th < kSmall;
  const float ths = small ? 1.0f : th;
  float sn, cs;  // sincosf: sinf's and cosf's bits, one argument reduction
  sincosf(ths, &sn, &cs);
  const float a = small ? 1.0f - th * th / 6.0f : sn / ths;
  const float b = small ? 0.5f - th * th / 24.0f : (1.0f - cs) / (ths * ths);
  const float c = small ? 1.0f / 6.0f - th * th / 120.0f : (ths - sn) / (ths * ths * ths);
  *R = eye_plus(a, W, b, W2);
  const Mat3 V = eye_plus(b, W, c, W2);
  matvec(V, v, t);
}

// lie.py se3_log (with so3_log)
__device__ inline void se3_log(const Mat3& R, const float t[3], float xi[6]) {
  const float trace = (R.m[0][0] + R.m[1][1]) + R.m[2][2];
  const float cos_th = fminf(fmaxf((trace - 1.0f) * 0.5f, -0.9999999f), 1.0f);
  const float th0 = acosf(cos_th);
  const float vee[3] = {R.m[2][1] - R.m[1][2], R.m[0][2] - R.m[2][0],
                        R.m[1][0] - R.m[0][1]};
  const bool small0 = th0 < kSmall;
  const float ths0 = small0 ? 1.0f : th0;
  const float scale = small0 ? 0.5f : ths0 / (2.0f * sinf(ths0));
  float w[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) w[i] = small0 ? 0.0f : scale * vee[i];

  const float th = theta(w);
  const Mat3 W = hat(w);
  const Mat3 W2 = matmul(W, W);
  const bool small = th < kSmall;
  const float half = th * 0.5f;
  float hs, hc;
  sincosf(half, &hs, &hc);
  const float cot_term =
      small ? 1.0f / 12.0f + th * th / 720.0f : (1.0f - half * hc / hs) / (th * th);
  const Mat3 V_inv = eye_plus(-0.5f, W, cot_term, W2);
  matvec(V_inv, t, xi);
#pragma unroll
  for (int i = 0; i < 3; ++i) xi[3 + i] = w[i];
}

// delta = (H + damping I)^-1 g by Cholesky, from the lower triangle of H
// (acc[a (a + 1) / 2 + b], b <= a); NaN where a pivot is not > 0.  Called
// by all 32 lanes of a warp, which all get delta.  Lane r (lanes past 5 as
// lane 5) keeps row r of L: for column j every lane forms the pivot, lane
// i > j its entry L[i][j] (one division in all lanes at once), and the
// column is broadcast, so every lane holds the rows (Lf) the next columns
// read.  The forward substitution goes column by column (lane k divides,
// y[k] is broadcast, lanes below subtract), the back substitution runs in
// every lane as one chain.  Every element takes the operations of the
// one-thread factorisation in the same order (k ascending), so delta is
// the same bits.
__device__ inline void solve6(const float* acc, float damping, float delta[6]) {
  constexpr unsigned kAll = 0xffffffffu;
  const int r = min((int)(threadIdx.x & 31), 5);
  const int base = r * (r + 1) / 2;
  float diag[6], arow[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    diag[j] = acc[j * (j + 1) / 2 + j];
    arow[j] = acc[base + j];  // H[r][j] for j <= r (past the row: not read)
  }
  const float g_r = acc[21 + r];
  float Lf[6][6];  // rows of L broadcast so far: Lf[i][j], j <= i
  float row[6];    // this lane's row r of L
  bool ok = true;
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float s = diag[j] + damping;
#pragma unroll
    for (int k = 0; k < j; ++k) s -= Lf[j][k] * Lf[j][k];
    ok = ok && s > 0.0f;
    const float d = sqrtf(s);
    float v = arow[j];
#pragma unroll
    for (int k = 0; k < j; ++k) v -= row[k] * Lf[j][k];
    row[j] = r == j ? d : v / d;
#pragma unroll
    for (int i = j; i < 6; ++i) Lf[i][j] = __shfl_sync(kAll, row[j], i);
  }
  float y[6];
  float v = g_r;  // lane r: g[r] less the terms of the y[k] broadcast so far
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    y[k] = __shfl_sync(kAll, v / Lf[k][k], k);
    v -= row[k] * y[k];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float x = y[i];
#pragma unroll
    for (int k = i + 1; k < 6; ++k) x -= Lf[k][i] * delta[k];
    delta[i] = x / Lf[i][i];
  }
  if (!ok) {
#pragma unroll
    for (int i = 0; i < 6; ++i) delta[i] = nanf("");
  }
}

// state <- T_inv = se3_exp(-xi) rows 0-2, xi, done
__device__ inline void write_state(float* state, const float xi[6], bool done) {
  float neg[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) neg[i] = -xi[i];
  Mat3 R;
  float t[3];
  se3_exp(neg, &R, t);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) state[4 * i + j] = R.m[i][j];
    state[4 * i + 3] = t[i];
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) state[12 + i] = xi[i];
  state[18] = done ? 1.0f : 0.0f;
}

// What one step gives: the guarded new twist and the step's statistics.
struct GNStep {
  float xi[6];
  float mean_res;
  float upd;
  int count;
  bool converged;
};

// One GN step at twist xi_in from the level's sums (tracker.py: gn_solve,
// lie.compose, the NaN guard and the post-update convergence test).  Called
// by all 32 lanes of a warp with the same acc and xi_in; every lane gets the
// result.  The compose's two exponentials are one SIMT pass: lane 0 takes
// exp(xi), lane 1 exp(delta), and each lane reads both back by shuffles.
__device__ inline GNStep gn_step(const float* acc, const float xi_in[6], float damping,
                                 float min_update_norm, float min_residual) {
  constexpr unsigned kAll = 0xffffffffu;
  DVO_STEP_MARK(0);
  GNStep out;
  float* xi = out.xi;
#pragma unroll
  for (int i = 0; i < 6; ++i) xi[i] = xi_in[i];
  const float rsum = acc[27];
  const int count = (int)acc[28];

  float delta[6];
  solve6(acc, damping, delta);
  if (count <= 0) {
#pragma unroll
    for (int i = 0; i < 6; ++i) delta[i] = 0.0f;
  }
  DVO_STEP_MARK(1);

  // compose(xi, delta) = se3_log(se3_exp(xi) se3_exp(delta))
  const bool second = (threadIdx.x & 31) == 1;
  float e[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) e[i] = second ? delta[i] : xi[i];
  Mat3 Re, R0, R1;
  float te[3], t0[3], t1[3];
  se3_exp(e, &Re, te);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      R0.m[i][j] = __shfl_sync(kAll, Re.m[i][j], 0);
      R1.m[i][j] = __shfl_sync(kAll, Re.m[i][j], 1);
    }
    t0[i] = __shfl_sync(kAll, te[i], 0);
    t1[i] = __shfl_sync(kAll, te[i], 1);
  }
  DVO_STEP_MARK(2);
  const Mat3 R = matmul(R0, R1);
  float t[3];
  matvec(R0, t1, t);
#pragma unroll
  for (int i = 0; i < 3; ++i) t[i] = t[i] + t0[i];
  float new_xi[6];
  se3_log(R, t, new_xi);
  DVO_STEP_MARK(3);

  bool finite = true;
#pragma unroll
  for (int i = 0; i < 6; ++i) finite = finite && isfinite(new_xi[i]);
  if (finite) {
#pragma unroll
    for (int i = 0; i < 6; ++i) xi[i] = new_xi[i];
  }

  const float mean_res = count > 0 ? rsum / (float)count : -1.0f;
  float sq = 0.0f;
#pragma unroll
  for (int i = 0; i < 6; ++i) sq += delta[i] * delta[i];
  const float upd = sqrtf(sq);
  out.mean_res = mean_res;
  out.upd = upd;
  out.count = count;
  out.converged = upd < min_update_norm || mean_res < min_residual || count == 0;
  DVO_STEP_MARK(4);
  return out;
}

}  // namespace dvo
