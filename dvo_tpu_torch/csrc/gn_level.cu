// One pyramid level of photometric Gauss-Newton tracking in ONE launch: the
// linearisation, the 29-term reduction, the 6x6 solve, the SE(3) update and
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
// (0.52 MB at 120x160, 1.5 MB at 212x256) and does ~180 flops per pixel;
// against 3.35 TB/s and 67 TFLOP/s that is a fraction of a microsecond,
// bytes first, and from the second iteration on the planes come from L2.
// No launch can come near that, so the bound that matters is latency: the
// launch itself, the gathers' round trips, the barriers, the reduction's
// depth and the solve's dependent chain, once per iteration.  Most steps
// run at the coarse levels (an RGB-D frame: ~15 steps at 27x32, a few at
// 53x64, one or two at the finer two).
//
// Design.
//  * A launch shape chosen per level from (h, w) alone (level_shape, the
//    same function as gn_level.launch_shape in Python), among the shapes
//    the kernel template takes: one block, which runs the loop with
//    __syncthreads() only and its state in its own shared memory (built
//    for tools/gn_level_stamps.py; slower at every level), or a thread
//    block cluster (8 blocks, the portable maximum, or 16 through
//    cudaFuncAttributeNonPortableClusterSizeAllowed), which meets twice per
//    iteration at cluster.sync(), a hardware barrier: once when the blocks'
//    sums are ready, once when the new pose is; every block copies the pose
//    from block 0 through distributed shared memory.  A launch the card
//    refuses raises in the wrapper; no other shape is tried.
//  * Pixels go to threads in a stride loop over the launch; each thread
//    adds its pixels in index order into 29 sums in registers: the lower
//    triangle of H (21: the Cholesky factorisation reads nothing else), g
//    (6), r^2 and the count.
//  * Deterministic reduction, no float atomics: a warp reduce-scatters its
//    29 sums (gn_pixel.cuh reduce_scatter: 31 shuffles, lane l ends with sum
//    l), warp 0 adds the block's warps in order, and in a cluster block 0
//    adds the blocks in rank order, reading their sums through distributed
//    shared memory (map_shared_rank).  Two launches repeat bit for bit.
//    The reduce-scatter adds in the same butterfly pairs as a shuffle tree
//    per sum (float addition commutes), so at 8 blocks of 512 the level's
//    outputs are the earlier design's bits; other shapes group the pixels
//    otherwise, within float noise of gn_level_plain.
//  * Warp 0 of block 0 runs the step (gn_step.cuh): the 6x6 solve and the
//    compose spread over its lanes, the NaN guard and the convergence test;
//    lane 0 writes the step's statistics and the transform of the next
//    linearisation into the block's shared memory.
//  * Measured on an H100 80GB HBM3 at 700 W (tools/gn_level_stamps.py), SM
//    cycles per step, this design / the earlier one (8 blocks of 512 at
//    every level, a shuffle tree per sum, the solve and the compose in one
//    thread), in turns: 14.7k / 18.6k at 27x32, 15.1k / 18.4k at 30x40,
//    15.9k / 19.3k at 53x64, 18.4k / 20.8k at 60x80, 27.1k / 30.1k at
//    106x128, 29.0k / 31.5k at 120x160, 44.7-45.0k / 71.6-71.8k at 212x256.
//    A 27x32 step: the step on warp 0 7.2k (the solve 3.7k, the
//    exponentials 0.9k, the logarithm 0.9k: a chain of dependent IEEE
//    divisions, square roots and trigonometry that spreading over lanes
//    shortened by 1.0k), the pixel 3.5k, the sums 2.2k, the two cluster
//    barriers 1.1k and 0.8k.  One block of 512 threads took 15.6k at 27x32
//    and 36.4k at 53x64 (two or more pixels a thread, in turn); 16 blocks of
//    1024 (64 registers, spilled) 44.8k at 212x256 against 47.5k for 16 of
//    512.  The shapes of level_shape against 8 blocks of 512 at every level
//    up to 32,768 pixels, in turns (tools/gn_level_stamps.py --turns, same
//    card): 14.35k / 15.1k at 30x40, 14.32k / 14.74k at 27x32, 16.03k /
//    18.4k at 60x80, 21.85k / 27.1k at 106x128, 23.3k / 28.8k at 120x160;
//    gn_level 144 / 151 us a graphed mono frame, 178 / 190 an RGB-D one.
//  * The statistics past the last active step are 0 and `iterations` counts
//    the active steps: the contract of the fixed-length masked loop
//    (gn_level_plain), without its inactive linearisations and with no
//    host sync.
//  * Scalar loads only: pyramid planes are views into one buffer at an
//    offset that need not be 16-byte aligned.
// Built with -fmad=false like every kernel here (gn_pixel.cuh).

#include <cooperative_groups.h>

// Built with -DDVO_GN_LEVEL_STAMPS (tools/gn_level_stamps.py), the solver
// also marks five stages of the step: its start, the solve, the compose's
// exponentials, the logarithm, its end.
#ifdef DVO_GN_LEVEL_STAMPS
#define DVO_GN_LEVEL_SHAPES
__shared__ long long dvo_step_marks[5];
#define DVO_STEP_MARK(k) if (threadIdx.x == 0) dvo_step_marks[k] = clock64()
#endif

#include "gn_pixel.cuh"
#include "gn_step.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kTerms = dvo::kGNSums;   // 21 lower-triangle H + 6 g + r^2 + count
constexpr int kState = dvo::kGNState;  // T_inv rows 0-2 (12) | xi (6) | done

struct LevelOut {
  float* xi;            // (6,)
  float* residuals;     // (n,)
  float* update_norms;  // (n,)
  int* valid_counts;    // (n,)
  int* iterations;      // ()
  long long* stamps;    // (n, 6 + 5) clock64() of block 0's thread 0; only with the flag below
  int steps;            // n
};

// Built with -DDVO_GN_LEVEL_STAMPS (tools/gn_level_stamps.py), the solver
// thread stamps the points of every step: 0 loop top, 1 pixels done, 2 block
// sums done, 3 past the first cluster barrier (a cluster only), 4 the step
// solved, 5 past the barrier after it; the step's five marks follow the n x 6
// points.
#ifdef DVO_GN_LEVEL_STAMPS
#define DVO_STAMP(k) if (solver) out.stamps[it * 6 + (k)] = clock64()
#else
#define DVO_STAMP(k)
#endif

// A launch shape: blocks a launch (1, or a cluster of 8 or 16) and threads
// a block.
struct Shape {
  int blocks, threads;
};

// The shape of a level of h x w pixels (mirrored by gn_level.launch_shape):
// the least SM cycles a step in tools/gn_level_stamps.py's sweep of this
// kernel at the rigs' seven level sizes (PERF.md): a cluster of 8 blocks of
// 256 threads up to 1,200 pixels, of 8 of 512 up to 4,096, of 16 of 512 up
// to 32,768, of 16 of 1024 above.  One block was slower at every level: a
// pixel is a ~3k-cycle dependent chain, and 512 threads take two or more of
// them in turn where a cluster takes one.  Each shape groups the pixels'
// sums otherwise: its bits differ from another's by float noise, which
// chip_smoke.py's gates hold step by step (the monocular trajectory follows
// float noise; ROADMAP queue C, v).
Shape level_shape(int h, int w) {
  const int n = h * w;
  if (n <= 1200) return {8, 256};
  if (n <= 4096) return {8, 512};
  if (n <= 32768) return {16, 512};
  return {16, 1024};
}

// One GN step of the level (gn_step.cuh) from its sums, on the whole warp:
// the step's statistics at slot `it`, the next state (lane 0 writes).
__device__ void level_step(const float* acc, float* state, const LevelOut& out, int it,
                           float damping, float min_update_norm, float min_residual) {
  float xi[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) xi[i] = state[12 + i];
  const dvo::GNStep s = dvo::gn_step(acc, xi, damping, min_update_norm, min_residual);
  __syncwarp();  // every lane has read the state before lane 0 rewrites it
  if ((threadIdx.x & 31) == 0) {
    out.residuals[it] = s.mean_res;
    out.update_norms[it] = s.upd;
    out.valid_counts[it] = s.count;
    dvo::write_state(state, s.xi, s.converged);
#ifdef DVO_GN_LEVEL_STAMPS
    if (threadIdx.x == 0) {
      for (int k = 0; k < 5; ++k) out.stamps[out.steps * 6 + it * 5 + k] = dvo_step_marks[k];
    }
#endif
  }
}

template <int kBlocks, int kThreads>
__global__ void __launch_bounds__(kThreads)
gn_level_kernel(dvo::GNPlanes planes, const float* __restrict__ K,
                const float* __restrict__ xi0, LevelOut out, dvo::GNScalars s,
                int max_iterations, float damping, float min_update_norm,
                float min_residual) {
  constexpr bool kCluster = kBlocks > 1;
  constexpr int kWarps = kThreads / 32;
  __shared__ float warp_sums[kWarps][kTerms];
  __shared__ float block_sums[kTerms];  // a cluster: read by block 0
  __shared__ float acc[kTerms];         // block 0 of a cluster: the level's sums
  __shared__ float state[kState];       // block 0: the solver's; else a copy

  const int rank = kCluster ? (int)cg::this_cluster().block_rank() : 0;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool solver = rank == 0 && tid == 0;

  const float fx = K[0], fy = K[4], cx = K[2], cy = K[5];
  const int n = s.h * s.w;

  if (solver) {
    float xi[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) xi[i] = xi0[i];
    dvo::write_state(state, xi, false);
  }
  if constexpr (kCluster) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }

  int it = 0;
  for (; it < max_iterations; ++it) {
    DVO_STAMP(0);
    if constexpr (kCluster) {
      // every block takes the pose of this step from block 0
      if (rank != 0 && tid < kState) {
        state[tid] = cg::this_cluster().map_shared_rank(state, 0)[tid];
      }
      __syncthreads();
    }
    if (state[18] != 0.0f) break;  // converged: the same in every block

    float t[32];  // the 29 sums, then 3 zeros for the reduce-scatter
#pragma unroll
    for (int k = 0; k < 32; ++k) t[k] = 0.0f;
    for (int p = rank * kThreads + tid; p < n; p += kBlocks * kThreads) {
      float J[6], r, weight;
      if (dvo::gn_pixel(planes, s, state, fx, fy, cx, cy, p, J, &r, &weight)) {
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
    dvo::reduce_scatter(t, lane);
    if (lane < kTerms) warp_sums[warp][lane] = t[0];
    __syncthreads();
    if (warp == 0 && lane < kTerms) {
      float v = 0.0f;
#pragma unroll
      for (int wi = 0; wi < kWarps; ++wi) v += warp_sums[wi][lane];
      block_sums[lane] = v;
    }
    DVO_STAMP(2);
    if constexpr (kCluster) {
      cg::cluster_group cluster = cg::this_cluster();
      cluster.sync();  // every block's sums are in its shared memory
      DVO_STAMP(3);
      if (rank == 0 && warp == 0) {
        if (lane < kTerms) {
          float v = 0.0f;
#pragma unroll
          for (int b = 0; b < kBlocks; ++b) v += cluster.map_shared_rank(block_sums, b)[lane];
          acc[lane] = v;
        }
        __syncwarp();
        level_step(acc, state, out, it, damping, min_update_norm, min_residual);
      }
      DVO_STAMP(4);
      cluster.sync();  // the new pose is in block 0's shared memory
    } else {
      if (warp == 0) {
        __syncwarp();
        level_step(block_sums, state, out, it, damping, min_update_norm, min_residual);
      }
      DVO_STAMP(4);
      __syncthreads();  // the new pose is in the block's shared memory
    }
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
  // no block of a cluster leaves while another may still read its shared memory
  if constexpr (kCluster) cg::this_cluster().sync();
}

template <int kBlocks, int kThreads>
cudaError_t launch_level(const dvo::GNPlanes& planes, const float* K, const float* xi0,
                         const LevelOut& out, const dvo::GNScalars& s, int max_iterations,
                         float damping, float min_update_norm, float min_residual,
                         cudaStream_t stream) {
  auto kernel = gn_level_kernel<kBlocks, kThreads>;
  if constexpr (kBlocks == 1) {
    kernel<<<1, kThreads, 0, stream>>>(planes, K, xi0, out, s, max_iterations, damping,
                                       min_update_norm, min_residual);
    return cudaGetLastError();
  } else {
    if constexpr (kBlocks > 8) {
      static const cudaError_t allowed =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (allowed != cudaSuccess) return allowed;
    }
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(kBlocks, 1, 1);
    config.blockDim = dim3(kThreads, 1, 1);
    config.dynamicSmemBytes = 0;
    config.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kBlocks;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    config.attrs = attr;
    config.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(&config, kernel, planes, K, xi0, out, s,
                                               max_iterations, damping, min_update_norm,
                                               min_residual);
    return err != cudaSuccess ? err : cudaGetLastError();
  }
}

// The level kernel at `shape`: one of the shapes instantiated here, else
// cudaErrorInvalidConfiguration.
cudaError_t launch_shaped(Shape shape, const dvo::GNPlanes& planes, const float* K,
                          const float* xi0, const LevelOut& out, const dvo::GNScalars& s,
                          int max_iterations, float damping, float min_update_norm,
                          float min_residual, cudaStream_t stream) {
#define DVO_SHAPE(B, T)                                                                  \
  if (shape.blocks == B && shape.threads == T)                                           \
    return launch_level<B, T>(planes, K, xi0, out, s, max_iterations, damping,           \
                              min_update_norm, min_residual, stream);
  DVO_SHAPE(8, 256)
  DVO_SHAPE(8, 512)
  DVO_SHAPE(16, 512)
  DVO_SHAPE(16, 1024)
#ifdef DVO_GN_LEVEL_SHAPES  // every candidate of tools/gn_level_stamps.py
  DVO_SHAPE(1, 256)
  DVO_SHAPE(1, 512)
  DVO_SHAPE(1, 1024)
  DVO_SHAPE(8, 1024)
  DVO_SHAPE(16, 256)
#endif
#undef DVO_SHAPE
  return cudaErrorInvalidConfiguration;
}

int level_call(Shape shape, const float* obj_gray, const uint8_t* obj_mask,
               const float* ref_depth, const float* ref_sigma, const float* ref_gray,
               const uint8_t* ref_mask, const float* ref_gx, const float* ref_gy,
               const uint8_t* ref_gmask, const float* K, const float* xi0, float* xi,
               float* residuals, float* update_norms, int* valid_counts, int* iterations,
               long long* stamps, int h, int w, float step, float min_depth, float sigma_lo,
               float sigma_hi, int weight_b_only, int crop, int crop_x0, int crop_x1,
               int crop_y0, int crop_y1, int max_iterations, float damping,
               float min_update_norm, float min_residual, void* stream) {
  const dvo::GNPlanes planes{obj_gray, obj_mask, ref_depth, ref_sigma, ref_gray,
                             ref_mask,  ref_gx,   ref_gy,    ref_gmask};
  // The whole image: the block is the image, no row offset.
  const dvo::GNScalars s{h, w, step, min_depth, sigma_lo, sigma_hi,
                         weight_b_only, crop, crop_x0, crop_x1, crop_y0, crop_y1,
                         0, h, w};
  const LevelOut out{xi, residuals, update_norms, valid_counts, iterations, stamps,
                     max_iterations};
  return (int)launch_shaped(shape, planes, K, xi0, out, s, max_iterations, damping,
                            min_update_norm, min_residual, (cudaStream_t)stream);
}

}  // namespace

// The launch shape of a level of h x w pixels: blocks a launch and threads
// a block (gn_level.launch_shape holds its mirror against these).
extern "C" int dvo_gn_level_blocks(int h, int w) { return level_shape(h, w).blocks; }
extern "C" int dvo_gn_level_threads(int h, int w) { return level_shape(h, w).threads; }

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
  return level_call(level_shape(h, w), obj_gray, obj_mask, ref_depth, ref_sigma, ref_gray,
                    ref_mask, ref_gx, ref_gy, ref_gmask, K, xi0, xi, residuals, update_norms,
                    valid_counts, iterations, stamps, h, w, step, min_depth, sigma_lo,
                    sigma_hi, weight_b_only, crop, crop_x0, crop_x1, crop_y0, crop_y1,
                    max_iterations, damping, min_update_norm, min_residual, stream);
}

#ifdef DVO_GN_LEVEL_SHAPES
// dvo_gn_level at a given shape (tools/gn_level_stamps.py's candidates).
// Built with -DDVO_GN_LEVEL_SHAPES alone (no stamps; `stamps` may be null),
// chip_smoke.py runs the monocular path with every level at another shape
// than level_shape's: whether a rig's trajectory follows float noise.
extern "C" int dvo_gn_level_shaped(int blocks, int threads, const float* obj_gray,
                                   const uint8_t* obj_mask, const float* ref_depth,
                                   const float* ref_sigma, const float* ref_gray,
                                   const uint8_t* ref_mask, const float* ref_gx,
                                   const float* ref_gy, const uint8_t* ref_gmask,
                                   const float* K, const float* xi0, float* xi,
                                   float* residuals, float* update_norms, int* valid_counts,
                                   int* iterations, long long* stamps, int h, int w,
                                   float step, float min_depth, float sigma_lo,
                                   float sigma_hi, int weight_b_only, int crop, int crop_x0,
                                   int crop_x1, int crop_y0, int crop_y1, int max_iterations,
                                   float damping, float min_update_norm, float min_residual,
                                   void* stream) {
  return level_call(Shape{blocks, threads}, obj_gray, obj_mask, ref_depth, ref_sigma,
                    ref_gray, ref_mask, ref_gx, ref_gy, ref_gmask, K, xi0, xi, residuals,
                    update_norms, valid_counts, iterations, stamps, h, w, step, min_depth,
                    sigma_lo, sigma_hi, weight_b_only, crop, crop_x0, crop_x1, crop_y0,
                    crop_y1, max_iterations, damping, min_update_norm, min_residual, stream);
}
#endif
