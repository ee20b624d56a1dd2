// What one launch costs on the card before it does any work: the yardsticks
// the kernel table in PERF.md holds each kernel against ("launch floor").
//
//   * dvo_floor_empty — a kernel that does nothing (one block of 32
//     threads): the device time of a launch through the same ctypes route
//     as every kernel of the library;
//   * dvo_floor_copy  — a grid-stride copy of nbytes with 16-byte loads and
//     stores: moves a kernel's bytes (nbytes read, nbytes written) at the
//     best rate a simple kernel gets, with the same launch.
//
// Neither replaces a TPU kernel; chip_smoke.py times them beside the
// kernels that do (tools/framebuild_floor.py).

#include "dvo_kernels.h"

namespace {

__global__ void empty_kernel() {}

__global__ void __launch_bounds__(256)
copy_kernel(const float4* __restrict__ src, float4* __restrict__ dst, int n) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x)
    dst[i] = __ldg(src + i);
}

}  // namespace

extern "C" int dvo_floor_empty(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

// src, dst: 16-byte aligned; nbytes a multiple of 16.
extern "C" int dvo_floor_copy(const void* src, void* dst, int nbytes, void* stream) {
  if (nbytes <= 0 || nbytes % 16 != 0 || (reinterpret_cast<uintptr_t>(src) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(dst) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const int n = nbytes / 16;
  int blocks = (n + 255) / 256;
  if (blocks > 132 * 8) blocks = 132 * 8;
  copy_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(static_cast<const float4*>(src),
                                                        static_cast<float4*>(dst), n);
  return (int)cudaGetLastError();
}
