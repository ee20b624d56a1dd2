// Photometric Gauss-Newton linearisation, one launch per linearisation with
// its sums reduced on the card, and the step kernel that solves and updates
// the pose from those sums: the tile-sharded tracker's GN step
// (parallel/tracking.py) is one gn_terms_kernel launch on the rank's row
// block, one in-place all-reduce of the 29 sums, one gn_step_kernel launch.
// The tracker's single-card path runs gn_level.cu, which takes a level's
// whole loop into one launch; gn_terms_kernel is also the single-step entry
// point (tracker.gn_terms) and the stepwise yardstick.  The per-pixel
// arithmetic is gn_pixel.cuh, the step's gn_step.cuh; gn_level.cu shares
// both.  A launch covers h x w pixels starting at image row y_offset of a
// full_h x full_w image whose gather planes it reads whole.
//
// Replaces the Pallas kernel dvo_tpu/ops/pallas/gn.py:_gn_kernel (reached
// through gn_terms_pallas), and with the step kernel the body of the
// sharded scan XLA compiles around it (dvo_tpu/parallel/tracking.py:83-95:
// gn_solve, lie.compose, the NaN guard, the freeze).  The arithmetic follows
// the XLA twin dvo_tpu/models/tracker.py:gn_terms, not the Pallas kernel:
// gray and mask are sampled with bilinear_masked's cyclic-predecessor fill,
// gx/gy/gmask with bilinear_dense's base-corner fallback, and gmask is
// tested as a float against 0.9999.
//
// What bounds it on the card: one linearisation reads 27 bytes per pixel
// and does ~180 flops per valid pixel; at a 30x160 row block that is 0.04
// us of bytes, at 106x256 0.2 us.  No launch comes near that: the launch,
// the gathers' round trips and the reduction's depth set the time.  The
// sharded step around it was the larger cost: ~250 eager ops a step (the
// partials sum, the params cat, the 44-float cat, the solve and compose in
// PyTorch) against 3 device ops now.
//
// Design.
//  * One thread per pixel, 256 threads a block, blocks over the whole card
//    (a 106x256 block is 106 of them: the pixel pass, which is three
//    quarters of gn_level's step at 212x256 on its 8 SMs, spreads).
//  * Each thread keeps 29 sums in registers: the lower triangle of H (21:
//    the Cholesky factorisation reads nothing else), g (6), r^2, the count.
//  * Deterministic reduction, no float atomics: a warp reduce-scatters
//    its 29 sums (31 shuffles, lane l ends with sum l, gn_pixel.cuh's
//    reduce_scatter), a block
//    adds its warps in order and writes its 29 sums to its partials slot;
//    after a __threadfence() one thread takes an atomic ticket, and the
//    block that takes the last one adds the slots in block order (lane l of
//    warp k adds slots l, l + 32, ... of term k, then a shuffle tree),
//    writes the 29 sums and resets the ticket.  The order of
//    every addition is fixed, whichever block comes last: a run repeats bit
//    for bit.  The ticket is allocated zeroed once (one per device and
//    stream) and every launch leaves it at 0, so no launch needs a memset.
//  * The pose comes from device memory: the rows of T_inv (a 4x4, or the
//    step kernel's state, which the step kernel seeds from a level's xi0
//    before its first step).  The intrinsics come from K.  No per-step host
//    tensor op remains.
//  * The step kernel is one warp that runs gn_step.cuh's step (the solve and
//    the compose spread over its lanes); lane 0 then applies dvo_tpu's
//    scan: xi_out = where(done, xi, new_xi), done |= converged; the step's
//    statistics go to slot `it` whether or not the level has
//    converged (the scan records them all), the next state to the buffer
//    the next linearisation reads.  At it = -1 it writes the level's first
//    state from xi0 (write_state: T_inv rows, xi, done = 0) and nothing else.
//    Measured on an H100 80GB HBM3 at 700 W, device us of one step in turns
//    (tools/gn_level_stamps.py --turns): 4.20 on the warp, 4.91-5.05 with
//    the solve and the compose in one thread; the launch floor is ~0.87.
//  * Measured against gn_level's layout for one step (one 8-block cluster
//    of 512 threads, the blocks' sums added through distributed shared
//    memory), in turns on an H100 80GB HBM3 at 700 W, and dropped: device us
//    per launch, this design / the cluster, 4.96-4.98 / 8.94-8.96 at a
//    30x160 row block, 5.91 / 16.14 at 120x160, 6.71 / 22.31-22.33 at a
//    106x256 row block, 8.22 / 39.76-39.80 at 212x256.  The cluster's 8 SMs
//    take the pixels of a large block serially, and its launch costs more at
//    the small one.  In the same call this design with one shuffle tree per
//    sum in place of the reduce-scatter took 6.12, 7.20-7.22, 8.66-8.67 and
//    10.05-10.09 us.
// Built with -fmad=false like every kernel here (gn_pixel.cuh).

#include "gn_pixel.cuh"
#include "gn_step.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = dvo::kGNSums;
constexpr int kState = dvo::kGNState;

__global__ void __launch_bounds__(kThreads)
gn_terms_kernel(dvo::GNPlanes planes, const float* __restrict__ K,
                const float* __restrict__ T,  // T_inv rows 0-2 (12 floats)
                float* __restrict__ sums, float* __restrict__ partials,
                unsigned int* __restrict__ ticket, dvo::GNScalars s) {
  __shared__ float warp_sums[kWarps][kSums];
  __shared__ bool last;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  float t[32];  // the 29 sums, then 3 zeros for the reduce-scatter
#pragma unroll
  for (int k = 0; k < 32; ++k) t[k] = 0.0f;
  const int n = s.h * s.w;
  const int p = blockIdx.x * kThreads + tid;
  if (p < n) {
    float J[6], r, weight;
    if (dvo::gn_pixel(planes, s, T, K[0], K[4], K[2], K[5], p, J, &r, &weight)) {
      const float rw = r * weight;
#pragma unroll
      for (int a = 0; a < 6; ++a) {
        const float ja = s.weight_b_only ? J[a] : J[a] * weight;
#pragma unroll
        for (int b = 0; b <= a; ++b) t[a * (a + 1) / 2 + b] = ja * J[b];
        t[21 + a] = J[a] * rw;
      }
      t[27] = r * r;
      t[28] = 1.0f;
    }
  }

  dvo::reduce_scatter(t, lane);
  if (lane < kSums) warp_sums[warp][lane] = t[0];
  __syncthreads();
  if (tid < kSums) {
    float v = 0.0f;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) v += warp_sums[wi][tid];
    partials[blockIdx.x * kSums + tid] = v;
    __threadfence();  // this block's slot is visible before its ticket
  }
  __syncthreads();
  if (tid == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;

  // The last block: every slot is written.  Term k to warp k mod kWarps;
  // lane l adds slots l, l + 32, ... (a warp's loads of one slot row
  // together), then a shuffle tree.
  constexpr int kPerWarp = (kSums + kWarps - 1) / kWarps;
  const int blocks = (int)gridDim.x;
  float v[kPerWarp];
#pragma unroll
  for (int j = 0; j < kPerWarp; ++j) v[j] = 0.0f;
  for (int b = lane; b < blocks; b += 32) {
#pragma unroll
    for (int j = 0; j < kPerWarp; ++j) {
      const int k = warp + j * kWarps;
      if (k < kSums) v[j] += __ldcg(&partials[b * kSums + k]);
    }
  }
#pragma unroll
  for (int j = 0; j < kPerWarp; ++j) {
    float x = v[j];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
    const int k = warp + j * kWarps;
    if (lane == 0 && k < kSums) sums[k] = x;
  }
  if (tid == 0) *ticket = 0u;
}

__global__ void __launch_bounds__(32)
gn_step_kernel(const float* __restrict__ sums, const float* __restrict__ xi0,
               float* __restrict__ state, float* __restrict__ residuals,
               float* __restrict__ update_norms, int* __restrict__ valid_counts, int it,
               float damping, float min_update_norm, float min_residual) {
  const bool lead = threadIdx.x == 0;
  if (it < 0) {  // the level's first state
    if (lead) {
      float xi[6];
#pragma unroll
      for (int i = 0; i < 6; ++i) xi[i] = xi0[i];
      dvo::write_state(state, xi, false);
    }
    return;
  }
  const bool done = state[18] != 0.0f;
  float xi[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) xi[i] = state[12 + i];

  const dvo::GNStep st = dvo::gn_step(sums, xi, damping, min_update_norm, min_residual);
  __syncwarp();  // every lane has read the state before lane 0 rewrites it
  if (!lead) return;
  residuals[it] = st.mean_res;
  update_norms[it] = st.upd;
  valid_counts[it] = st.count;
  float out[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) out[i] = done ? xi[i] : st.xi[i];
  dvo::write_state(state, out, done || st.converged);
}

}  // namespace

extern "C" int dvo_gn_num_blocks(int n) { return (n + kThreads - 1) / kThreads; }

// One linearisation of the (h, w) block on `stream` at the pose whose T_inv
// rows 0-2 are the 12 floats at `T_inv`: the 29 sums to `sums` (21
// lower-triangle H, 6 g, r^2, count).  `partials` holds
// dvo_gn_num_blocks(h * w) x 29 floats; `ticket` is one zeroed unsigned int
// that no other launch uses at the same time, and is left at 0.
extern "C" int dvo_gn_terms(const float* obj_gray, const uint8_t* obj_mask,
                            const float* ref_depth, const float* ref_sigma,
                            const float* ref_gray, const uint8_t* ref_mask,
                            const float* ref_gx, const float* ref_gy,
                            const uint8_t* ref_gmask, const float* K, const float* T_inv,
                            float* sums, float* partials, unsigned int* ticket,
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
      planes, K, T_inv, sums, partials, ticket, s);
  return (int)cudaGetLastError();
}

// Step `it` of a level from its 29 (all-reduced) sums on `stream`: reads
// the state's xi and done, writes the step's statistics at slot `it` and
// the next state (T_inv rows 0-2, xi, done).  At it = -1 it writes the
// level's first state from xi0 and nothing else.
extern "C" int dvo_gn_step(const float* sums, const float* xi0, float* state,
                           float* residuals, float* update_norms, int* valid_counts, int it,
                           float damping, float min_update_norm, float min_residual,
                           void* stream) {
  gn_step_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(sums, xi0, state, residuals, update_norms,
                                                    valid_counts, it, damping, min_update_norm,
                                                    min_residual);
  return (int)cudaGetLastError();
}
