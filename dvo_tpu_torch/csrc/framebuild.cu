// Fused frame build: every pyramid level's value planes, mask and
// central-difference gradients in one launch, one thread per output pixel.
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
// pltpu.roll because Mosaic cannot lower strided slices; a GPU thread
// gathers the base pixel directly, so none of that carries over.  A
// level-t neighbour of (y, x) is the base pixel at ((y +- 1) * 2^t, x * 2^t)
// or (y * 2^t, (x +- 1) * 2^t), so every output depends on the inputs
// alone.  Every output is a copy or one float subtraction: the kernel is
// bit-identical to the plain version.
//
// What bounds it on the card: pure memory traffic, ~0.6 MB at the RGB-D
// base (212x256, 4 levels, 3 value planes + mask + gradients), well under a
// microsecond of HBM time, so launch overhead dominates.  Its point on this
// launch-bound path is one launch where the plain build issues about a
// dozen small ops per level.  Written in CUDA C++ rather than Triton so the
// four kernels share one nvcc build and one ctypes launch ABI.
//
// Layout: each plane kind is one contiguous buffer holding all levels back
// to back, coarsest first (value plane k at vals + k * total); the wrapper
// returns per-level views of it (framebuild_cull.cuh).
//
// A second kernel, regularize_cull_kernel, is the cull as the epilogue of
// the launch that produces the map: the monocular mapper regularises the
// keyframe's base depth and then re-derives every level of depth and sigma
// from the base, which took three launches (the depth/sigma pair, the
// regulariser, one plane) whose first wrote levels the third overwrote
// unread.  Here each thread computes its base pixel's regularised depth
// (regularize_pixel.cuh, the regulariser's own arithmetic) and scatters it,
// and the unchanged sigma, to every level the pixel belongs to: one launch,
// bit-identical to the three.

#include "framebuild_cull.cuh"
#include "regularize_pixel.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxValues = 3;

struct Planes {
  const float* v[kMaxValues];
};

__global__ void __launch_bounds__(kThreads)
framebuild_kernel(Planes in, const uint8_t* __restrict__ mask, float* __restrict__ vals,
                  uint8_t* __restrict__ mask_out, float* __restrict__ gx_out,
                  float* __restrict__ gy_out, uint8_t* __restrict__ gmask_out, int h0, int w0,
                  int levels, int n_val, int total) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= total) return;
  const dvo::LevelPixel o = dvo::locate(p, h0, w0, levels);
  const int t = o.t, ht = o.ht, wt = o.wt, y = o.y, x = o.x;
  const int row = (y << t) * w0;
  const int base = row + (x << t);
  for (int k = 0; k < n_val; ++k) vals[k * total + p] = in.v[k][base];
  if (mask == nullptr) return;

  mask_out[p] = mask[base] != 0;
  const float* gray = in.v[0];
  const bool in_x = x >= 1 && x <= wt - 2;
  const bool in_y = y >= 1 && y <= ht - 2;
  float gx = 0.0f, gy = 0.0f;
  bool ok = in_x && in_y;
  if (in_x) {
    const int r = row + ((x + 1) << t);
    const int l = row + ((x - 1) << t);
    gx = gray[r] - gray[l];
    ok = ok && mask[r] != 0 && mask[l] != 0;
  }
  if (in_y) {
    const int d = ((y + 1) << t) * w0 + (x << t);
    const int u = ((y - 1) << t) * w0 + (x << t);
    gy = gray[d] - gray[u];
    ok = ok && mask[d] != 0 && mask[u] != 0;
  }
  gx_out[p] = gx;
  gy_out[p] = gy;
  gmask_out[p] = ok;
}

__global__ void __launch_bounds__(kThreads)
regularize_cull_kernel(const float* __restrict__ depth, const float* __restrict__ sigma,
                       float* __restrict__ vals, int h0, int w0, int levels, int total,
                       float gain_ramp, float max_depth) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= h0 * w0) return;
  const int y = p / w0;
  const int x = p - y * w0;
  const float d = dvo::regularize_pixel(depth, sigma, y, x, h0, w0, gain_ramp, max_depth);
  dvo::cull_store(vals, d, y, x, h0, w0, levels);
  dvo::cull_store(vals + total, sigma[p], y, x, h0, w0, levels);
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
  if (n_val < 1 || n_val > kMaxValues || levels < 1 || levels > 16) return (int)cudaErrorInvalidValue;
  Planes in{{v0, v1, v2}};
  const int blocks = (total + kThreads - 1) / kThreads;
  framebuild_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      in, mask, vals, mask_out, gx, gy, gmask, h0, w0, levels, n_val, total);
  return (int)cudaGetLastError();
}

// depth, sigma: base-level (h0, w0) float planes.  vals: 2 * total floats,
// the regularised depth's pyramid then sigma's, each coarsest first.
extern "C" int dvo_regularize_cull(const float* depth, const float* sigma, float* vals, int h0,
                                   int w0, int levels, int total, float gain_ramp,
                                   float max_depth, void* stream) {
  if (levels < 1 || levels > 16) return (int)cudaErrorInvalidValue;
  const int blocks = (h0 * w0 + kThreads - 1) / kThreads;
  regularize_cull_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      depth, sigma, vals, h0, w0, levels, total, gain_ramp, max_depth);
  return (int)cudaGetLastError();
}
