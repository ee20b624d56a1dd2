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
//    memory; after the second barrier every block copies that state.  That
//    step code is gn_step.cuh, which gn.cu's step kernel (the tile-sharded
//    loop's solve and pose update) shares.
//  * The statistics past the last active step are 0 and `iterations` counts
//    the active steps: the contract of the fixed-length masked loop
//    (gn_level_plain), without its inactive linearisations and with no
//    host sync.
//  * Scalar loads only: pyramid planes are views into one buffer at an
//    offset that need not be 16-byte aligned.
// Built with -fmad=false like every kernel here (gn_pixel.cuh).

#include <cooperative_groups.h>

#include "gn_pixel.cuh"
#include "gn_step.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;
#ifndef DVO_GN_LEVEL_THREADS
#define DVO_GN_LEVEL_THREADS 512  // tools/gn_level_stamps.py also builds 256 and 1024
#endif
constexpr int kThreads = DVO_GN_LEVEL_THREADS;
constexpr int kWarps = kThreads / 32;
constexpr int kTerms = dvo::kGNSums;   // 21 lower-triangle H + 6 g + r^2 + count
constexpr int kState = dvo::kGNState;  // T_inv rows 0-2 (12) | xi (6) | done

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

// One GN step of the level (gn_step.cuh) from its sums: the step's
// statistics at slot `it`, the next state.
__device__ void level_step(const float* acc, float* state, const LevelOut& out, int it,
                           float damping, float min_update_norm, float min_residual) {
  const dvo::GNStep s = dvo::gn_step(acc, state + 12, damping, min_update_norm, min_residual);
  out.residuals[it] = s.mean_res;
  out.update_norms[it] = s.upd;
  out.valid_counts[it] = s.count;
  dvo::write_state(state, s.xi, s.converged);
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
    dvo::write_state(state, xi, false);
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
        level_step(acc, state, out, it, damping, min_update_norm, min_residual);
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
