// One pyramid level of photometric Gauss-Newton tracking in ONE launch: the
// linearisation, the 44-term reduction, the 6x6 solve, the SE(3) update and
// the convergence test of every iteration run on the device, and the loop
// ends there when the level has converged.
//
// Replaces the Pallas kernel dvo_tpu/ops/pallas/gn.py:_gn_kernel together
// with the loop that XLA compiles around it in the JAX package (the
// lax.scan / lax.while_loop of dvo_tpu/models/tracker.py:track_level).  In
// PyTorch that loop was ~250 host-issued ops per iteration around gn.cu's
// launch, 15 iterations per level, whatever the convergence.
//
// What bounds it on the card.  One linearisation reads 27 bytes per pixel
// (0.52 MB at 120x160, 1.5 MB at 212x256) and does ~250 flops per pixel;
// against 3.35 TB/s and 67 TFLOP/s that is a fraction of a microsecond,
// bytes first, and from the second iteration on the planes come from L2.
// No launch can come near that, so the bound that matters is latency: the
// launch itself, the gathers' round trips, and two barriers and one serial
// 6x6 solve per iteration.
//
// Design.
//  * One thread block cluster of 8 blocks (the portable maximum) runs the
//    whole loop; a launch costs once per level and not once per iteration.
//    The blocks meet twice per iteration at cluster.sync(), a hardware
//    barrier: once when their partial sums are ready, once when the new
//    pose is.  (A cooperative grid launch with grid.sync() would spread the
//    pixels over more blocks but pays a barrier through device memory
//    twice per iteration; it was not built, so no time is stated for it.)
//    Measured on an H100 (700 W): 18.8 us of device time for one step at
//    120x160, against 7.1 ms in 5,288 launches for the stepwise loop's 15
//    steps (chip_smoke.py); per step 18.5k SM cycles at 27x32 (solve 8.7k,
//    block sums 4.0k, pixels 3.8k, the two barriers 1.7k) and 73.6k at
//    212x256 (pixels 56.5k) (tools/gn_level_stamps.py).
//  * 512 threads a block (120 registers, no spills).  Measured on an H100
//    (700 W), SM cycles per step with 256 / 512 / 1024 threads: 16.8k /
//    18.7k / 25.8k at 27x32, 21.6k / 19.4k / 27.7k at 53x64, 40.0k / 30.5k /
//    34.2k at 106x128, 122.4k / 73.1k / 68.2k at 212x256
//    (tools/gn_level_stamps.py); at 1024 the 64-register cap spills.
//  * Pixels go to threads in a cluster-stride loop; each thread keeps 29
//    sums in registers: the lower triangle of H (21: the Cholesky
//    factorisation reads nothing else), g (6), r^2 and the count.
//  * Deterministic reduction, no float atomics: a thread adds its pixels in
//    index order, a warp reduces with a shuffle tree, a block adds its
//    warps in order, and block 0 adds the blocks in rank order, reading
//    their sums through distributed shared memory (map_shared_rank).
//  * Lane 0 of block 0's first warp solves (H + damping I) delta = g by a
//    float32 Cholesky factorisation (a pivot that is not > 0 gives NaN, no
//    valid pixel gives a zero update), composes xi <- log(exp(xi)
//    exp(delta)) with the branches and constants of dvo_tpu_torch/lie.py,
//    keeps the old xi when the new one is not finite, writes the step's
//    statistics and the transform of the next linearisation into its shared
//    memory; after the second barrier every block copies that state.
//  * The statistics past the last active step are 0 and `iterations` counts
//    the active steps: the contract of the fixed-length masked loop
//    (gn_level_plain), without its inactive linearisations and with no
//    host sync.
//  * Scalar loads only: pyramid planes are views into one buffer at an
//    offset that need not be 16-byte aligned.
// Built with -fmad=false like every kernel here (gn_pixel.cuh).

#include <cooperative_groups.h>

#include "gn_pixel.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;
#ifndef DVO_GN_LEVEL_THREADS
#define DVO_GN_LEVEL_THREADS 512  // tools/gn_level_stamps.py also builds 256 and 1024
#endif
constexpr int kThreads = DVO_GN_LEVEL_THREADS;
constexpr int kWarps = kThreads / 32;
constexpr int kTerms = 29;    // 21 lower-triangle H + 6 g + r^2 + count
constexpr int kState = 19;    // T_inv rows 0-2 (12) | xi (6) | done
constexpr float kSmall = 1e-6f;  // lie.py _SMALL

struct LevelOut {
  float* xi;            // (6,)
  float* residuals;     // (n,)
  float* update_norms;  // (n,)
  int* valid_counts;    // (n,)
  int* iterations;      // ()
  long long* stamps;    // (n, 6) clock64() of block 0's thread 0; only with the flag below
};

// Built with -DDVO_GN_LEVEL_STAMPS (tools/gn_level_stamps.py), the solver
// thread stamps six points of every step: loop top, pixels done, block sum
// done, past the first barrier, solve done, past the second barrier.
#ifdef DVO_GN_LEVEL_STAMPS
#define DVO_STAMP(k) if (solver) out.stamps[it * 6 + (k)] = clock64()
#else
#define DVO_STAMP(k)
#endif

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
__device__ void se3_exp(const float xi[6], Mat3* R, float t[3]) {
  const float* v = xi;
  const float* w = xi + 3;
  const float th = theta(w);
  const Mat3 W = hat(w);
  const Mat3 W2 = matmul(W, W);
  const bool small = th < kSmall;
  const float ths = small ? 1.0f : th;
  const float a = small ? 1.0f - th * th / 6.0f : sinf(ths) / ths;
  const float b = small ? 0.5f - th * th / 24.0f : (1.0f - cosf(ths)) / (ths * ths);
  const float c = small ? 1.0f / 6.0f - th * th / 120.0f
                        : (ths - sinf(ths)) / (ths * ths * ths);
  *R = eye_plus(a, W, b, W2);
  const Mat3 V = eye_plus(b, W, c, W2);
  matvec(V, v, t);
}

// lie.py se3_log (with so3_log)
__device__ void se3_log(const Mat3& R, const float t[3], float xi[6]) {
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
  const float cot_term =
      small ? 1.0f / 12.0f + th * th / 720.0f
            : (1.0f - half * cosf(half) / sinf(half)) / (th * th);
  const Mat3 V_inv = eye_plus(-0.5f, W, cot_term, W2);
  matvec(V_inv, t, xi);
#pragma unroll
  for (int i = 0; i < 3; ++i) xi[3 + i] = w[i];
}

// delta = (H + damping I)^-1 g by Cholesky, from the lower triangle of H
// (acc[a (a + 1) / 2 + b], b <= a).  NaN where a pivot is not > 0.
__device__ void solve6(const float* acc, float damping, float delta[6]) {
  float L[6][6];
  bool ok = true;
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float s = acc[j * (j + 1) / 2 + j] + damping;
#pragma unroll
    for (int k = 0; k < j; ++k) s -= L[j][k] * L[j][k];
    ok = ok && s > 0.0f;
    const float d = sqrtf(s);
    L[j][j] = d;
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      float v = acc[i * (i + 1) / 2 + j];
#pragma unroll
      for (int k = 0; k < j; ++k) v -= L[i][k] * L[j][k];
      L[i][j] = v / d;
    }
  }
  float y[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float v = acc[21 + i];
#pragma unroll
    for (int k = 0; k < i; ++k) v -= L[i][k] * y[k];
    y[i] = v / L[i][i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float v = y[i];
#pragma unroll
    for (int k = i + 1; k < 6; ++k) v -= L[k][i] * delta[k];
    delta[i] = v / L[i][i];
  }
  if (!ok) {
#pragma unroll
    for (int i = 0; i < 6; ++i) delta[i] = nanf("");
  }
}

// state <- T_inv = se3_exp(-xi) rows 0-2, xi, done
__device__ void write_state(float* state, const float xi[6], bool done) {
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

// One GN step from the level's sums (tracker.py: gn_solve, lie.compose,
// the NaN guard and the post-update convergence test).  Writes the step's
// statistics at slot `it` and the next state; returns nothing else.
__device__ void gn_step(const float* acc, float* state, const LevelOut& out, int it,
                        float damping, float min_update_norm, float min_residual) {
  float xi[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) xi[i] = state[12 + i];
  const float rsum = acc[27];
  const int count = (int)acc[28];

  float delta[6];
  solve6(acc, damping, delta);
  if (count <= 0) {
#pragma unroll
    for (int i = 0; i < 6; ++i) delta[i] = 0.0f;
  }

  // compose(xi, delta) = se3_log(se3_exp(xi) se3_exp(delta))
  Mat3 R0, R1;
  float t0[3], t1[3];
  se3_exp(xi, &R0, t0);
  se3_exp(delta, &R1, t1);
  const Mat3 R = matmul(R0, R1);
  float t[3];
  matvec(R0, t1, t);
#pragma unroll
  for (int i = 0; i < 3; ++i) t[i] = t[i] + t0[i];
  float new_xi[6];
  se3_log(R, t, new_xi);

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
  const bool converged = upd < min_update_norm || mean_res < min_residual || count == 0;

  out.residuals[it] = mean_res;
  out.update_norms[it] = upd;
  out.valid_counts[it] = count;
  write_state(state, xi, converged);
}

__global__ void __launch_bounds__(kThreads)
gn_level_kernel(dvo::GNPlanes planes, const float* __restrict__ K,
                const float* __restrict__ xi0, LevelOut out, dvo::GNScalars s,
                int max_iterations, float damping, float min_update_norm,
                float min_residual) {
  __shared__ float warp_sums[kWarps][kTerms];
  __shared__ float block_sums[kTerms];  // read by block 0 across the cluster
  __shared__ float acc[kTerms];         // block 0: the level's sums
  __shared__ float state[kState];       // block 0: written by the solver
  __shared__ float local_state[kState];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool solver = rank == 0 && tid == 0;
  const float* state0 = cluster.map_shared_rank(state, 0);

  const float fx = K[0], fy = K[4], cx = K[2], cy = K[5];
  const int n = s.h * s.w;
  const int stride = kCluster * kThreads;

  if (solver) {
    float xi[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) xi[i] = xi0[i];
    write_state(state, xi, false);
  }
  cluster.sync();

  int it = 0;
  for (; it < max_iterations; ++it) {
    DVO_STAMP(0);
    // every block takes the pose of this step from block 0
    if (tid < kState) local_state[tid] = state0[tid];
    __syncthreads();
    if (local_state[18] != 0.0f) break;  // converged: the same in every block

    float t[kTerms];
#pragma unroll
    for (int k = 0; k < kTerms; ++k) t[k] = 0.0f;
    for (int p = rank * kThreads + tid; p < n; p += stride) {
      float J[6], r, weight;
      if (dvo::gn_pixel(planes, s, local_state, fx, fy, cx, cy, p, J, &r, &weight)) {
        const float rw = r * weight;
#pragma unroll
        for (int a = 0; a < 6; ++a) {
          const float ja = s.weight_b_only ? J[a] : J[a] * weight;
#pragma unroll
          for (int b = 0; b <= a; ++b) t[a * (a + 1) / 2 + b] += ja * J[b];
          t[21 + a] += J[a] * rw;
        }
        t[27] += r * r;
        t[28] += 1.0f;
      }
    }

    DVO_STAMP(1);
#pragma unroll
    for (int k = 0; k < kTerms; ++k) {
      float v = t[k];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0) warp_sums[warp][k] = v;
    }
    __syncthreads();
    if (tid < kTerms) {
      float v = 0.0f;
#pragma unroll
      for (int wi = 0; wi < kWarps; ++wi) v += warp_sums[wi][tid];
      block_sums[tid] = v;
    }
    DVO_STAMP(2);
    cluster.sync();  // every block's sums are in its shared memory
    DVO_STAMP(3);

    if (rank == 0 && warp == 0) {
      if (lane < kTerms) {
        float v = 0.0f;
#pragma unroll
        for (int b = 0; b < kCluster; ++b) v += cluster.map_shared_rank(block_sums, b)[lane];
        acc[lane] = v;
      }
      __syncwarp();
      if (lane == 0) {
        gn_step(acc, state, out, it, damping, min_update_norm, min_residual);
      }
    }
    DVO_STAMP(4);
    cluster.sync();  // the new pose is in block 0's shared memory
    DVO_STAMP(5);
  }

  if (solver) {
    // `it` active steps ran; state holds the last pose (block 0's own memory)
#pragma unroll
    for (int i = 0; i < 6; ++i) out.xi[i] = state[12 + i];
    *out.iterations = it;
    for (int k = it; k < max_iterations; ++k) {
      out.residuals[k] = 0.0f;
      out.update_norms[k] = 0.0f;
      out.valid_counts[k] = 0;
    }
  }
  // no block leaves while another may still read its shared memory
  cluster.sync();
}

}  // namespace

// The level's GN loop on `stream`; `stamps` may be null unless the library
// was built with DVO_GN_LEVEL_STAMPS.  Returns the launch's error code.
extern "C" int dvo_gn_level(const float* obj_gray, const uint8_t* obj_mask,
                            const float* ref_depth, const float* ref_sigma,
                            const float* ref_gray, const uint8_t* ref_mask,
                            const float* ref_gx, const float* ref_gy,
                            const uint8_t* ref_gmask, const float* K, const float* xi0,
                            float* xi, float* residuals, float* update_norms,
                            int* valid_counts, int* iterations, long long* stamps, int h, int w,
                            float step,
                            float min_depth, float sigma_lo, float sigma_hi,
                            int weight_b_only, int crop, int crop_x0, int crop_x1,
                            int crop_y0, int crop_y1, int max_iterations, float damping,
                            float min_update_norm, float min_residual, void* stream) {
  const dvo::GNPlanes planes{obj_gray, obj_mask, ref_depth, ref_sigma, ref_gray,
                             ref_mask,  ref_gx,   ref_gy,    ref_gmask};
  // The whole image: the block is the image, no row offset.
  const dvo::GNScalars s{h, w, step, min_depth, sigma_lo, sigma_hi,
                         weight_b_only, crop, crop_x0, crop_x1, crop_y0, crop_y1,
                         0, h, w};
  const LevelOut out{xi, residuals, update_norms, valid_counts, iterations, stamps};

  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(kCluster, 1, 1);
  config.blockDim = dim3(kThreads, 1, 1);
  config.dynamicSmemBytes = 0;
  config.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&config, gn_level_kernel, planes, K, xi0, out, s, max_iterations,
                         damping, min_update_norm, min_residual);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}
