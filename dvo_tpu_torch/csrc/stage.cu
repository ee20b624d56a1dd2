// Stage markers: empty kernels that the port's tracing (utils/trace.py)
// enqueues where a stage of the step begins, while a profiler records.  A
// profiler's device timeline then carries one marker at the start of each
// stage's region, and a reader cuts the timeline at them: every device op
// between a marker and the next one belongs to the first marker's stage.
//
// One kernel per name, declared extern "C" so that the profiler prints the
// bare name (dvo_stage_track, ...).  A marker is one block of one thread
// that does nothing: the least a launch costs (csrc/floor.cu's empty
// launch).  They replace no TPU kernel: the JAX package's profiles come
// from XLA's named scopes, which need no device op.

#include <cuda_runtime.h>

// In the order of utils/trace.py's MARKERS.
extern "C" __global__ void dvo_stage_frame_build() {}
extern "C" __global__ void dvo_stage_track() {}
extern "C" __global__ void dvo_stage_pose() {}
extern "C" __global__ void dvo_stage_map() {}
extern "C" __global__ void dvo_stage_copy() {}
extern "C" __global__ void dvo_stage_end() {}

namespace {

using Marker = void (*)();
constexpr Marker kMarkers[] = {dvo_stage_frame_build, dvo_stage_track, dvo_stage_pose,
                               dvo_stage_map,         dvo_stage_copy,  dvo_stage_end};
constexpr int kCount = sizeof(kMarkers) / sizeof(kMarkers[0]);

}  // namespace

// Loads every marker's code into the context, so that a marker's first
// launch may be one recorded into a CUDA graph (lazy module loading would
// otherwise load it inside the capture).
extern "C" int dvo_stage_load() {
  for (int i = 0; i < kCount; ++i) {
    cudaFuncAttributes attr;
    const cudaError_t err = cudaFuncGetAttributes(&attr, kMarkers[i]);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

extern "C" int dvo_stage_mark(int which, void* stream) {
  if (which < 0 || which >= kCount) return (int)cudaErrorInvalidValue;
  kMarkers[which]<<<1, 1, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
