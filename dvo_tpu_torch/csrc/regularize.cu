// 4-neighbour depth regulariser.
//
// Replaces the Pallas kernel dvo_tpu/ops/pallas/regularize.py:
// _regularize_kernel (reached through regularize_pallas) and follows the
// XLA twin dvo_tpu/models/mapper.py:regularize (reference
// implement.cpp:156-180): fuse the left, right, down and up neighbours in
// that order with the compatibility-gated Gaussian (no reset), reading
// neighbours from the ORIGINAL maps, then clamp to max_depth.  The mono
// path's fused route regularises inside framebuild.cu's
// regularize_cull_kernel; this launch serves the fields route and
// ops/cuda/regularize.regularize.
//
// What bounds it on the card.  8 bytes read and 4 written per pixel for ~73
// flops: at 120x160, 230 KB that sit in L2, 0.069 us at the memory rate.
// No launch comes near that; what a launch costs is latency: the launch
// itself, a thread's loads, and a chain of four dependent gated fusions,
// each with two IEEE divisions and a square root.
//
// Design.  The arithmetic is dvo::fuse_taps (regularize_pixel.cuh), which
// regularize_cull_kernel shares, so every candidate below rounds as
// regularize_plain does, bit for bit (-fmad=false, IEEE division, sqrtf).
// Only how the neighbours reach a thread, and how pixels map to threads and
// blocks, differ:
//  (a) flat: one thread a pixel on a 1-D grid of 256-thread blocks, ten
//      loads a thread (regularize_pixel; 75 blocks at 120x160 on 132 SMs).
//  (b) tile: blocks of 32 x k threads on a 2-D grid, one pixel a thread, ten
//      loads (120x160: 150-600 blocks; up and down share L1 lines).
//  (c) walk with one row: (b), but a warp is 32 neighbouring pixels of one
//      row and takes the left and right neighbours from the neighbouring
//      lanes (__shfl_up_sync / __shfl_down_sync); lane 0 and lane 31 load
//      the warp's outer neighbours.  Six loads a thread, eight at the edges.
//  (d) walk with r rows: a thread walks r rows of one column, loading the
//      r + 2 rows of depth and sigma around them once (two loads a pixel),
//      the r fusion chains independent, so that they interleave.
// A warp's lanes share rows, so a warp leaves only as a whole; lanes past
// the right edge load the last column and write nothing.
//
// The shipped candidate is kLaunch below (mirrored by
// ops/cuda/regularize.LAUNCH, held against the dvo_regularize_kind /
// _block_rows / _thread_rows entries on the card).  Built with
// -DDVO_REGULARIZE_SWEEP (tools/regularize_sweep.py) the library exports
// dvo_regularize_variant, every candidate of the sweep.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W: device us a launch
// (torch.profiler, 20 calls), two turns each, every candidate bitwise equal
// to regularize_plain.  On the mono state's maps at 120x160
// (chip_smoke.py's kernels phase): (a) flat 256 2.47; (b) tile 32x1 2.43,
// 32x2 2.44, 32x4 2.41-2.42, 32x8 2.39; (c) shuffles 2.54-2.79; (d) two
// rows a thread 3.78-3.82, four 6.36-6.44, eight 12.60-13.06.  On
// tools/regularize_sweep.py's synthetic maps, 120x160 / 106x128 / 212x256 /
// 37x53: flat 2.06 / 2.06 / 2.35-2.42 / 2.03, tile 32x4 1.88-2.01 / 1.97 /
// 2.25 / 1.88-1.89, shuffles (32x4) 2.12 / 2.10-2.11 / 2.32-2.33 / 2.05.
// The launch floor there: an empty launch 0.86-0.87 us, a copy of the
// call's bytes 1.10-1.17 us.  So the grid is not what bounds the launch: 75
// blocks of 256 or 150 of 128 come within 2-9% of each other.  What is left
// above the copy is each pixel's chain of four gated fusions (three IEEE
// divisions and a square root each): ~1.3 us on the mono maps, which fuse
// more neighbours than the synthetic ones, ~0.8 us on those.
// Walking rows to share loads serialises the chains (the divisions' slow
// path is a call the compiler does not interleave), and shuffles cost more
// than the L1 hits they replace.  Shipped: (b) 32 x 4, the least at
// 120x160, 212x256 and 37x53 on the synthetic maps and within 0.01 us of
// the least on the mono maps.

#include "regularize_pixel.cuh"

namespace {

constexpr unsigned kFullMask = 0xffffffffu;

enum Kind { kFlat = 0, kTile = 1, kWalk = 2 };

// A launch: the kind, the rows of a block (tile, walk: blocks of 32 x rows
// threads) and the rows a thread walks (walk).
struct Launch {
  int kind, block_rows, thread_rows;
};

constexpr Launch kLaunch{kTile, 4, 1};

struct Maps {
  const float* depth;
  const float* sigma;
  float* out;
  int h, w;
  float gain_ramp, max_depth;
};

constexpr int kFlatThreads = 256;

// (a)
__global__ void __launch_bounds__(kFlatThreads) regularize_flat(Maps m) {
  const int p = blockIdx.x * kFlatThreads + threadIdx.x;
  if (p >= m.h * m.w) return;
  const int y = p / m.w;
  const int x = p - y * m.w;
  m.out[p] = dvo::regularize_pixel(m.depth, m.sigma, y, x, m.h, m.w, m.gain_ramp, m.max_depth);
}

// (b)
template <int kRows>
__global__ void __launch_bounds__(32 * kRows) regularize_tile(Maps m) {
  const int x = blockIdx.x * 32 + threadIdx.x;
  const int y = blockIdx.y * kRows + threadIdx.y;
  if (x >= m.w || y >= m.h) return;
  m.out[y * m.w + x] =
      dvo::regularize_pixel(m.depth, m.sigma, y, x, m.h, m.w, m.gain_ramp, m.max_depth);
}

// (c) with kWalkRows = 1, (d) above.  Block (32, kRows); thread (lane, t)
// takes column blockIdx.x * 32 + lane, rows y0 .. y0 + kWalkRows - 1 with
// y0 = (blockIdx.y * kRows + t) * kWalkRows.
template <int kRows, int kWalkRows>
__global__ void __launch_bounds__(32 * kRows) regularize_walk(Maps m) {
  const int lane = threadIdx.x;
  const int x = blockIdx.x * 32 + lane;
  const int y0 = (blockIdx.y * kRows + threadIdx.y) * kWalkRows;
  if (y0 >= m.h) return;  // the whole warp
  const int xc = min(x, m.w - 1);
  // rows y0 - 1 .. y0 + kWalkRows (clamped): r + 1 is row y0 + r
  float d[kWalkRows + 2], s[kWalkRows + 2];
#pragma unroll
  for (int r = 0; r < kWalkRows + 2; ++r) {
    const int q = dvo::clampi(y0 - 1 + r, 0, m.h - 1) * m.w + xc;
    d[r] = __ldg(m.depth + q);
    s[r] = __ldg(m.sigma + q);
  }
  float dl[kWalkRows], sl[kWalkRows], dr[kWalkRows], sr[kWalkRows];
#pragma unroll
  for (int r = 0; r < kWalkRows; ++r) {
    dl[r] = __shfl_up_sync(kFullMask, d[r + 1], 1);
    sl[r] = __shfl_up_sync(kFullMask, s[r + 1], 1);
    dr[r] = __shfl_down_sync(kFullMask, d[r + 1], 1);
    sr[r] = __shfl_down_sync(kFullMask, s[r + 1], 1);
  }
  if (lane == 0 || lane == 31) {  // the warp's outer neighbours
    const int xo = dvo::clampi(lane == 0 ? x - 1 : x + 1, 0, m.w - 1);
#pragma unroll
    for (int r = 0; r < kWalkRows; ++r) {
      const int q = dvo::clampi(y0 + r, 0, m.h - 1) * m.w + xo;
      const float dq = __ldg(m.depth + q), sq = __ldg(m.sigma + q);
      if (lane == 0) {
        dl[r] = dq;
        sl[r] = sq;
      } else {
        dr[r] = dq;
        sr[r] = sq;
      }
    }
  }
  if (x >= m.w) return;
#pragma unroll
  for (int r = 0; r < kWalkRows; ++r) {
    const int y = y0 + r;
    if (y >= m.h) break;
    const float nd[4] = {dl[r], dr[r], d[r + 2], d[r]};
    const float ns[4] = {sl[r], sr[r], s[r + 2], s[r]};
    const bool in[4] = {x > 0, x + 1 < m.w, y + 1 < m.h, y > 0};
    m.out[y * m.w + x] = dvo::fuse_taps(d[r + 1], s[r + 1], nd, ns, in, m.gain_ramp,
                                        m.max_depth);
  }
}

// The launch `l`: one of the candidates instantiated here, else
// cudaErrorInvalidConfiguration.
cudaError_t launch(Launch l, const Maps& m, cudaStream_t stream) {
  if (l.kind == kFlat) {
    const int blocks = (m.h * m.w + kFlatThreads - 1) / kFlatThreads;
    regularize_flat<<<blocks, kFlatThreads, 0, stream>>>(m);
    return cudaGetLastError();
  }
  const int rows = l.block_rows * (l.kind == kWalk ? l.thread_rows : 1);
  const dim3 grid((m.w + 31) / 32, (m.h + rows - 1) / rows);
  const dim3 block(32, l.block_rows);
#define DVO_WALK(K, R)                                                       \
  if (l.kind == kWalk && l.block_rows == K && l.thread_rows == R) {          \
    regularize_walk<K, R><<<grid, block, 0, stream>>>(m);                    \
    return cudaGetLastError();                                               \
  }
#define DVO_TILE(K)                                                          \
  if (l.kind == kTile && l.block_rows == K) {                                \
    regularize_tile<K><<<grid, block, 0, stream>>>(m);                       \
    return cudaGetLastError();                                               \
  }
  DVO_TILE(4)  // kLaunch
#ifdef DVO_REGULARIZE_SWEEP  // every candidate of tools/regularize_sweep.py
  DVO_TILE(1)
  DVO_TILE(2)
  DVO_TILE(4)
  DVO_TILE(8)
  DVO_WALK(1, 1)
  DVO_WALK(2, 1)
  DVO_WALK(4, 1)
  DVO_WALK(8, 1)
  DVO_WALK(1, 2)
  DVO_WALK(2, 2)
  DVO_WALK(4, 2)
  DVO_WALK(1, 4)
  DVO_WALK(2, 4)
  DVO_WALK(4, 4)
  DVO_WALK(1, 8)
  DVO_WALK(2, 8)
  DVO_WALK(4, 8)
#endif
#undef DVO_WALK
#undef DVO_TILE
  return cudaErrorInvalidConfiguration;
}

int call(Launch l, const float* depth, const float* sigma, float* out, int h, int w,
         float gain_ramp, float max_depth, void* stream) {
  const Maps m{depth, sigma, out, h, w, gain_ramp, max_depth};
  return (int)launch(l, m, (cudaStream_t)stream);
}

}  // namespace

// The shipped launch (regularize.LAUNCH holds its mirror against these).
extern "C" int dvo_regularize_kind() { return kLaunch.kind; }
extern "C" int dvo_regularize_block_rows() { return kLaunch.block_rows; }
extern "C" int dvo_regularize_thread_rows() { return kLaunch.thread_rows; }

extern "C" int dvo_regularize(const float* depth, const float* sigma, float* out, int h,
                              int w, float gain_ramp, float max_depth, void* stream) {
  return call(kLaunch, depth, sigma, out, h, w, gain_ramp, max_depth, stream);
}

#ifdef DVO_REGULARIZE_SWEEP
// dvo_regularize at another launch (tools/regularize_sweep.py's candidates).
extern "C" int dvo_regularize_variant(int kind, int block_rows, int thread_rows,
                                      const float* depth, const float* sigma, float* out,
                                      int h, int w, float gain_ramp, float max_depth,
                                      void* stream) {
  return call(Launch{kind, block_rows, thread_rows}, depth, sigma, out, h, w, gain_ramp,
              max_depth, stream);
}
#endif
