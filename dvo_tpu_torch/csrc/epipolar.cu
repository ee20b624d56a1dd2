// Epipolar depth observation fused with the Gaussian depth filter: a group
// of lanes marches each observing pixel, one launch per depth update.
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
//
// Two entries over one kernel template (the per-pixel code is
// epipolar_pixel.cuh):
//   * dvo_epipolar        — takes the 24 per-pixel planes that
//     models/mapper.epipolar_fields prepares in PyTorch ops, the interface
//     of epipolar_update_pallas (plane order of dvo_tpu/ops/pallas/epipolar.py);
//   * dvo_epipolar_fused  — takes the raw maps (reference depth, sigma, age,
//     reset plane, the object frame's gray and mask), the ring and a small
//     pose table, and computes the 24 values in registers: the planes are
//     never written.  XLA fuses that preparation around the Pallas kernel for
//     free; eager PyTorch issues it op by op, so here it moves into the
//     kernel.  Trigonometry stays in the pose table (a few ops on (C, 6)
//     tensors per frame): per pixel there are only adds, multiplies,
//     divisions, sqrtf and rintf.
//
// What bounds it on the card: the march — per observing pixel a few dozen
// bilinear gathers (4 loads each) from its keyframe slot of the gray ring
// (8 x 120 x 160 x 4 B = 614 KB, L2-resident), with lengths that differ
// from pixel to pixel, and fewer than half of the pixels observing at all.
// Design:
//   * a block owns kPixels consecutive pixels; its first kPixels threads
//     load or prepare one pixel each and compact the observing ones into a
//     shared-memory list (ballot + prefix), so idle pixels cost no lanes;
//   * all kThreads threads then march: a group of kLanes lanes takes one
//     listed pixel at a time and deals its samples over the lanes; the
//     samples go through a row of shared memory, so no lane waits on
//     another while it gathers, the dependent chain is length / kLanes, and
//     a warp holds 32 / kLanes pixels whose lengths may differ without
//     idling whole warps;
//   * the first kPixels threads finish their pixel in registers and write
//     the three maps;
//   * the counts (observed, accepted, rejected, and in the fused entry
//     aged_out) are integers: one atomicAdd per block and count into a
//     zeroed 4-int buffer is exact and independent of the order the blocks
//     finish in, so results repeat bit for bit.  The entry zeroes the buffer
//     with cudaMemsetAsync on the same stream.
// Measured on an H100 (PERF.md section 6 has the numbers): 16 lanes a pixel,
// 64 pixels and 512 threads a block; the windows through the row rather than
// by shuffle.  Measured and dropped: staging a slot's whole gray plane (77 KB)
// in dynamic shared memory with asynchronous 16-byte copies (cp.async), per
// slot that a block's listed pixels refer to, and marching from there — a
// block's few dozen marching pixels read a few KB of the plane, so the copy
// moved far more than the gathers it saved and the launch took 2.6 to 4 times
// as long; the ring stays in L2.  Also dropped: dealing a block every
// blocks-th pixel (or run of 32) to even out the long segments, which
// cluster in the image — no faster, or slower for the lost locality.

#include "epipolar_pixel.cuh"

// -DDVO_EPI_STAMPS=1 (tools/epipolar_sweep.py --stamps): thread 0 of every
// block stamps the nanosecond timer at the kernel's five phase boundaries.
#ifndef DVO_EPI_STAMPS
#define DVO_EPI_STAMPS 0
#endif

namespace {

using namespace dvo::epi;

#if DVO_EPI_STAMPS
constexpr int kStampBlocks = 4096;
constexpr int kStamps = 5;  // start, prepared, listed, marched, finished
__device__ unsigned long long g_stamps[kStampBlocks * kStamps];
__device__ __forceinline__ void stamp(int k) {
  if (threadIdx.x == 0 && blockIdx.x < kStampBlocks) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    g_stamps[blockIdx.x * kStamps + k] = t;
  }
}
#else
__device__ __forceinline__ void stamp(int) {}
#endif

struct Outputs {
  float* depth;
  float* sigma;
  int32_t* age;
  int32_t* stats;  // observed, accepted, rejected, aged_out
};

// Floats of a marching group's row: the march's s.steps + 2 offsets, rounded
// up to whole float4s.
__host__ __device__ inline int row_floats(int steps) { return (steps + 2 + 3) & ~3; }

template <bool kFused>
__global__ void __launch_bounds__(kThreads)
epipolar_kernel(const float* __restrict__ fields, Raw raw, Ring ring, Outputs out, Scalars s) {
  __shared__ Pixel listed[kPixels];        // observing pixels, in pixel order
  __shared__ int owner[kPixels];           // the thread that owns listed[j]
  __shared__ Match matched[kPixels];       // by owning thread
  __shared__ int warp_count[kPixels / 32];
  __shared__ int counts[4];
  // Dynamic: one row of row_floats(s.steps) samples per marching group.
  extern __shared__ __align__(16) float rows[];
  float* row = rows + (threadIdx.x / kLanes) * row_floats(s.steps);

  const int n = s.bh * s.w;  // the block's pixels
  const int tid = threadIdx.x;
  const int p = blockIdx.x * kPixels + tid;
  const bool owns = tid < kPixels && p < n;
  const unsigned full = 0xffffffffu;
  const int warp = tid >> 5;
  const int warp_lane = tid & 31;

  stamp(0);
  Pixel px;
  px.base_ok = false;
  bool aged_out = false;
  if (tid < 4) counts[tid] = 0;
  if (owns) {
    if constexpr (kFused) {
      px = prepare(raw, p, s.h, s.w, s.y_offset, s.capacity, &aged_out);
    } else {
      px = load_fields(fields, p, n, s.capacity);
    }
  }

  stamp(1);
  // ---- compact the observing pixels (whole warps own pixels) ----
  unsigned observing = 0;
  if (tid < kPixels) {
    observing = __ballot_sync(full, px.base_ok);
    if (warp_lane == 0) warp_count[warp] = __popc(observing);
  }
  __syncthreads();
  int n_listed = 0;
#pragma unroll
  for (int k = 0; k < kPixels / 32; ++k) n_listed += warp_count[k];
  if (tid < kPixels && px.base_ok) {
    int j = __popc(observing & ((1u << warp_lane) - 1u));
    for (int k = 0; k < warp; ++k) j += warp_count[k];
    listed[j] = px;
    owner[j] = tid;
  }
  __syncthreads();

  stamp(2);
  // ---- march: one group of kLanes lanes per listed pixel ----
  const int lane = tid & (kLanes - 1);
  const unsigned group_mask = (kLanes == 32 ? full : ((1u << (kLanes & 31)) - 1u))
                              << (warp_lane & ~(kLanes - 1));
  for (int j = tid / kLanes; j < n_listed; j += kGroups) {
    const Pixel& q = listed[j];
    const Match m = march(ring.gray + (size_t)q.slot * s.h * s.w, q, s, lane, group_mask, row);
    if (lane == 0) matched[owner[j]] = m;
  }
  __syncthreads();

  stamp(3);
  // ---- finish: one thread per owned pixel ----
  if (tid < kPixels) {
    Flags fl{false, false, false};
    if (owns) {
      const Match m = px.base_ok ? matched[tid] : Match{s.big_ssd, 0};
      fl = finish(px, m, ring, s, p, out.depth, out.sigma, out.age);
    }
    const int c[4] = {__popc(__ballot_sync(full, fl.observed)),
                      __popc(__ballot_sync(full, fl.accepted)),
                      __popc(__ballot_sync(full, fl.rejected)),
                      __popc(__ballot_sync(full, aged_out))};
    if (warp_lane == 0) {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (c[k]) atomicAdd(&counts[k], c[k]);
    }
  }
  __syncthreads();
  // Integer sums: exact whatever the order of the blocks.
  if (tid < 4 && counts[tid]) atomicAdd(&out.stats[tid], counts[tid]);
  stamp(4);
}

template <bool kFused>
int launch(const float* fields, const Raw& raw, const Ring& ring, const Outputs& out,
           const Scalars& s, cudaStream_t stream) {
  const size_t dynamic = (size_t)kGroups * row_floats(s.steps) * sizeof(float);
  if (s.steps < 1 || dynamic > 200 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(out.stats, 0, 4 * sizeof(int32_t), stream);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (s.bh * s.w + kPixels - 1) / kPixels;
  if (dynamic > 48 * 1024) {  // a march of more than ~380 steps at 32 groups
    err = cudaFuncSetAttribute(epipolar_kernel<kFused>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dynamic);
    if (err != cudaSuccess) return (int)err;
  }
  epipolar_kernel<kFused><<<blocks, kThreads, dynamic, stream>>>(fields, raw, ring, out, s);
  return (int)cudaGetLastError();
}

}  // namespace

// The lanes that march one pixel, the threads of a block and the pixels a
// block owns, as this library was built (-DDVO_EPI_LANES, _THREADS, _PIXELS).
#if DVO_EPI_STAMPS
// Copies the last launch's stamps (blocks x 5 uint64 nanoseconds) to dst.
extern "C" int dvo_epipolar_stamps(void* dst, int blocks) {
  if (blocks > kStampBlocks) return (int)cudaErrorInvalidValue;
  return (int)cudaMemcpyFromSymbol(dst, g_stamps, sizeof(unsigned long long) * kStamps * blocks);
}
#endif

extern "C" int dvo_epipolar_lanes() { return kLanes; }
extern "C" int dvo_epipolar_threads() { return kThreads; }
extern "C" int dvo_epipolar_pixels() { return kPixels; }

// stats: 4 int32 (observed, accepted, rejected, 0), zeroed here.  The field
// planes and the outputs are block_h x w (rows of the h x w ring images).
extern "C" int dvo_epipolar(const float* fields, const float* born_gray, const float* born_gx,
                            const float* born_gy, const uint8_t* born_gmask, float* depth_out,
                            float* sigma_out, int32_t* age_out, int32_t* stats, int h, int w,
                            int block_h, int capacity, int steps, float match_thresh,
                            float big_ssd, float epi_sigma2, float lum_2sigma2,
                            float accept_d_lo, float accept_d_hi, float accept_s_lo,
                            float accept_s_hi, float gain_ramp, float reset_sigma,
                            void* stream) {
  if (block_h < 0 || block_h > h) return (int)cudaErrorInvalidValue;
  const Scalars s{h, w, block_h, 0, capacity, steps, match_thresh, big_ssd, epi_sigma2,
                  lum_2sigma2, accept_d_lo, accept_d_hi, accept_s_lo, accept_s_hi, gain_ramp,
                  reset_sigma};
  return launch<false>(fields, Raw{}, Ring{born_gray, born_gx, born_gy, born_gmask},
                       Outputs{depth_out, sigma_out, age_out, stats}, s, (cudaStream_t)stream);
}

// stats: 4 int32 (observed, accepted, rejected, aged_out), zeroed here.
// head, count: the ring's newest slot and live keyframes, one int32 each in
// device memory (every thread of the crop reads them: one broadcast load).
// The reference maps, the reset plane and the outputs are block_h x w, rows
// y_offset .. y_offset + block_h - 1 of the h x w object frame and ring.
extern "C" int dvo_epipolar_fused(
    const float* obj_gray, const uint8_t* obj_mask, const float* ref_depth,
    const float* ref_sigma, const int32_t* ref_age, const float* reset_depth,
    const float* table, const float* born_gray, const float* born_gx, const float* born_gy,
    const uint8_t* born_gmask, float* depth_out, float* sigma_out, int32_t* age_out,
    int32_t* stats, const int32_t* head, const int32_t* count, int h, int w, int block_h,
    int y_offset, int capacity, int steps, int crop_x0, int crop_x1, int crop_y0, int crop_y1,
    float min_search_depth, float match_thresh, float big_ssd, float epi_sigma2,
    float lum_2sigma2, float accept_d_lo, float accept_d_hi, float accept_s_lo,
    float accept_s_hi, float gain_ramp, float reset_sigma, void* stream) {
  if (capacity < 1 || block_h < 0 || y_offset < 0 || y_offset + block_h > h)
    return (int)cudaErrorInvalidValue;
  const Scalars s{h, w, block_h, y_offset, capacity, steps, match_thresh, big_ssd,
                  epi_sigma2, lum_2sigma2, accept_d_lo, accept_d_hi, accept_s_lo, accept_s_hi,
                  gain_ramp, reset_sigma};
  const Raw raw{obj_gray, obj_mask, ref_depth, ref_sigma, ref_age, reset_depth, table,
                head, count, crop_x0, crop_x1, crop_y0, crop_y1, min_search_depth};
  return launch<true>(nullptr, raw, Ring{born_gray, born_gx, born_gy, born_gmask},
                      Outputs{depth_out, sigma_out, age_out, stats}, s, (cudaStream_t)stream);
}
