// Fused frame build: every pyramid level's value planes, mask and
// central-difference gradients in one launch, one thread per base pixel.
//
// Replaces the Pallas kernel dvo_tpu/ops/pallas/framebuild.py:_build_kernel
// (reached through _pyramid_call by build_pyramid_planes, cull_pyramid_one
// and cull_pyramid_pair) and computes what the XLA build computes
// (dvo_tpu/ops/image.py cull_image + gradients, reference
// convert.cpp:7-75): for level t, the point sample plane[y * 2^t, x * 2^t]
// of each of n_val value planes and of the mask; with the mask, for value
// plane 0, gx = I[x+1] - I[x-1] and gy = I[y+1] - I[y-1] (not halved, zero
// on the border columns / rows) and gmask = both x-neighbours and both
// y-neighbours valid on an interior pixel.
//
// The TPU kernel decimates with one-hot selection matmuls and shifts with
// pltpu.roll because Mosaic cannot lower strided slices; a GPU block reads
// the base planes directly, so none of that carries over.  A level-t
// neighbour of (y, x) is the base pixel at ((y +- 1) * 2^t, x * 2^t) or
// (y * 2^t, (x +- 1) * 2^t).  Every output is a copy or one float
// subtraction: the kernel is bit-identical to the plain version.
//
// What bounds it on the card: pure memory traffic, ~0.6 MB at the RGB-D
// base (212x256, 4 levels, 3 value planes + mask + gradients), well under a
// microsecond of HBM time, so launch latency dominates.  Written in CUDA C++
// rather than Triton so the kernels share one nvcc build and one ctypes
// launch ABI.
//
// Design (the first kernels ran one thread per output pixel of the
// whole buffer, found its level with a loop of divisions, and loaded the
// mask neighbours one after another behind short-circuit tests, up to five
// dependent round trips to L2): one thread per BASE pixel on a 2D grid of
// 32x4 blocks (150 blocks at 120x160, 424 at 212x256), which writes level 0
// and every coarser level whose sample it is (framebuild_cull.cuh).  Every
// load a thread makes — its values and mask, and for each of its levels the
// four neighbours' gray and mask — is issued before the first use, so a
// thread waits for memory once; the gates combine with non-short-circuit
// ands.  A warp's level-0 loads and stores are 32 consecutive pixels.
//
// Measured and dropped (PERF.md section 6): a block per tile of
// 2^(levels-1) base rows x 32 columns that
// staged the tile's planes with their halo into shared memory in 16-byte
// loads and computed every level of the tile from there.  Bit-identical, but
// 2.95 us against the first kernel's 2.42 (mono tracking build), 4.59 against
// 3.20 (RGB-D build) and 2.80 against 2.56 (regularize and cull) in the same
// call: the staging loops issued their loads one after another, and a block
// then waited at a barrier before its first store.  At these sizes (0.2-2 MB,
// in L2) a launch is a chain of latencies, not a stream of bytes: the
// per-level offsets are 16-byte aligned at the mono (120x160 x 3), RGB-D
// (212x256 x 4) and Kinect-mono (106x128 x 3) shapes, but vector loads buy
// nothing a warp's coalesced 4-byte accesses do not already get.
//
// Layout: each plane kind is one contiguous buffer holding all levels back
// to back, coarsest first (value plane k at vals + k * total); the wrapper
// returns per-level views of it.
//
// A second kernel, regularize_cull_kernel, is the cull as the epilogue of
// the launch that produces the map: the monocular mapper regularises the
// keyframe's base depth and then re-derives every level of depth and sigma
// from the base, which took three launches (the depth/sigma pair, the
// regulariser, one plane).  Each thread computes its base pixel's
// regularised depth (regularize_pixel.cuh: the regulariser's arithmetic and
// gate order, its ten loads issued first) and writes it, and the unchanged
// sigma, to every level the pixel is a sample of: one launch, bit-identical
// to the three.

#include "framebuild_cull.cuh"
#include "regularize_pixel.cuh"

namespace {

using dvo::kBlockX;
using dvo::kBlockY;
using dvo::kMaxLevels;

constexpr int kMaxValues = 3;

struct Planes {
  const float* v[kMaxValues];
};

__global__ void __launch_bounds__(kBlockX * kBlockY)
framebuild_kernel(Planes in, const uint8_t* __restrict__ mask, float* __restrict__ vals,
                  uint8_t* __restrict__ mask_out, float* __restrict__ gx_out,
                  float* __restrict__ gy_out, uint8_t* __restrict__ gmask_out, int h0, int w0,
                  int levels, int n_val, int total) {
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  if (x >= w0 || y >= h0) return;
  const int top = dvo::top_level(y, x, levels);
  const int p0 = y * w0 + x;

  // ---- every load first: values, mask, each level's four neighbours ----
  float v[kMaxValues];
#pragma unroll
  for (int k = 0; k < kMaxValues; ++k)
    if (k < n_val) v[k] = __ldg(in.v[k] + p0);
  float g[kMaxLevels][4];
  uint8_t m[kMaxLevels][4];
  uint8_t m0 = 0;
  if (mask != nullptr) {
    m0 = __ldg(mask + p0);
#pragma unroll
    for (int t = 0; t < kMaxLevels; ++t) {
      if (t > top) break;
      const int s = 1 << t;
      // right, left, down, up; a neighbour off the image reads a clamped,
      // unused address
      const int q[4] = {y * w0 + min(x + s, w0 - 1), y * w0 + max(x - s, 0),
                        min(y + s, h0 - 1) * w0 + x, max(y - s, 0) * w0 + x};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        g[t][j] = __ldg(in.v[0] + q[j]);
        m[t][j] = __ldg(mask + q[j]);
      }
    }
  }

  // ---- level 0 and every coarser level this pixel is a sample of ----
  int off = total;
#pragma unroll
  for (int t = 0; t < kMaxLevels; ++t) {
    if (t > top) break;
    const int ht = dvo::level_height(h0, t);
    const int wt = dvo::level_width(w0, t);
    off -= ht * wt;
    const int yl = y >> t;
    const int xl = x >> t;
    const int p = off + yl * wt + xl;
#pragma unroll
    for (int k = 0; k < kMaxValues; ++k)
      if (k < n_val) vals[k * total + p] = v[k];
    if (mask == nullptr) continue;
    mask_out[p] = m0 != 0;
    const bool in_x = xl >= 1 && xl <= wt - 2;
    const bool in_y = yl >= 1 && yl <= ht - 2;
    gx_out[p] = in_x ? g[t][0] - g[t][1] : 0.0f;
    gy_out[p] = in_y ? g[t][2] - g[t][3] : 0.0f;
    gmask_out[p] = in_x & in_y & (m[t][0] != 0) & (m[t][1] != 0) & (m[t][2] != 0) &
                   (m[t][3] != 0);
  }
}

__global__ void __launch_bounds__(kBlockX * kBlockY)
regularize_cull_kernel(const float* __restrict__ depth, const float* __restrict__ sigma,
                       float* __restrict__ vals, int h0, int w0, int levels, int total,
                       float gain_ramp, float max_depth) {
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  if (x >= w0 || y >= h0) return;
  const int top = dvo::top_level(y, x, levels);
  const float s = __ldg(sigma + y * w0 + x);
  const float d = dvo::regularize_pixel(depth, sigma, y, x, h0, w0, gain_ramp, max_depth);
  int off = total;
#pragma unroll
  for (int t = 0; t < kMaxLevels; ++t) {
    if (t > top) break;
    const int wt = dvo::level_width(w0, t);
    off -= dvo::level_height(h0, t) * wt;
    const int p = off + (y >> t) * wt + (x >> t);
    vals[p] = d;
    vals[total + p] = s;
  }
}

dim3 base_grid(int h0, int w0) {
  return dim3((w0 + kBlockX - 1) / kBlockX, (h0 + kBlockY - 1) / kBlockY);
}

}  // namespace

// v0..v2: base-level (h0, w0) float planes (unused ones may be null);
// mask: (h0, w0) bool or null for the value-only variants, in which case
// mask_out / gx / gy / gmask are not written.  total = sum of the levels'
// ceil(h0 / 2^t) * ceil(w0 / 2^t).
extern "C" int dvo_framebuild(const float* v0, const float* v1, const float* v2,
                              const uint8_t* mask, float* vals, uint8_t* mask_out, float* gx,
                              float* gy, uint8_t* gmask, int h0, int w0, int levels, int n_val,
                              int total, void* stream) {
  if (n_val < 1 || n_val > kMaxValues || levels < 1 || levels > kMaxLevels)
    return (int)cudaErrorInvalidValue;
  Planes in{{v0, v1, v2}};
  framebuild_kernel<<<base_grid(h0, w0), dim3(kBlockX, kBlockY), 0, (cudaStream_t)stream>>>(
      in, mask, vals, mask_out, gx, gy, gmask, h0, w0, levels, n_val, total);
  return (int)cudaGetLastError();
}

// depth, sigma: base-level (h0, w0) float planes.  vals: 2 * total floats,
// the regularised depth's pyramid then sigma's, each coarsest first.
extern "C" int dvo_regularize_cull(const float* depth, const float* sigma, float* vals, int h0,
                                   int w0, int levels, int total, float gain_ramp,
                                   float max_depth, void* stream) {
  if (levels < 1 || levels > kMaxLevels) return (int)cudaErrorInvalidValue;
  regularize_cull_kernel<<<base_grid(h0, w0), dim3(kBlockX, kBlockY), 0,
                           (cudaStream_t)stream>>>(depth, sigma, vals, h0, w0, levels, total,
                                                   gain_ramp, max_depth);
  return (int)cudaGetLastError();
}
