// A conditional (IF) node inside a CUDA graph being captured: the work
// captured between dvo_graph_if_begin and dvo_graph_if_end runs on a replay
// only where a device bool holds, with no host read.  The monocular step's
// bundle adjustment is such a region: due on a promotion whose window is
// full, and skipped whole on every other frame (models/odometry.py).
//
// begin, on the stream under capture:
//   1. a handle of the captured graph, and a one-thread kernel that sets it
//      from the bool on each replay (cudaGraphSetConditional);
//   2. an IF node after that kernel, and the stream's capture made to depend
//      on the node alone, so that what the stream captures next follows the
//      region;
//   3. the body's capture begun on a second stream into the node's body
//      graph.
// end closes the body's capture.  The caller (ops/cuda/_build.branch) puts
// the body's work on that second stream and its allocations into a memory
// pool of their own, which lives as long as the graph.
//
// It replaces no TPU kernel: dvo_tpu's step selects the branch with lax.cond
// inside the compiled program.

#include <cuda_runtime.h>

namespace {

__global__ void set_condition(cudaGraphConditionalHandle handle, const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

}  // namespace

// Loads the condition kernel's code into the context, so that its first
// launch may be one recorded into a graph (as dvo_stage_load).
extern "C" int dvo_graph_if_load() {
  cudaFuncAttributes attr;
  return (int)cudaFuncGetAttributes(&attr, set_condition);
}

extern "C" int dvo_graph_if_begin(void* pred, void* body_stream, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t n = 0;
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &n);
  if (err != cudaSuccess) return (int)err;
  if (status != cudaStreamCaptureStatusActive) return (int)cudaErrorStreamCaptureUnmatched;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return (int)err;
  set_condition<<<1, 1, 0, s>>>(handle, (const bool*)pred);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &n);
  if (err != cudaSuccess) return (int)err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, n, &params);
  if (err != cudaSuccess) return (int)err;
  err = cudaStreamUpdateCaptureDependencies(s, &node, 1, cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaStreamBeginCaptureToGraph((cudaStream_t)body_stream,
                                            params.conditional.phGraph_out[0], nullptr,
                                            nullptr, 0, cudaStreamCaptureModeThreadLocal);
}

extern "C" int dvo_graph_if_end(void* body_stream) {
  cudaGraph_t body;
  return (int)cudaStreamEndCapture((cudaStream_t)body_stream, &body);
}
