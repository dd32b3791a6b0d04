// A CUDA graph IF conditional node around a captured body: the device-side
// branch of ops/cuda/graph.py::device_if.
//
// The counterpart of lax.cond with an empty else branch, as the JAX
// incremental step uses it (water_sandbox_tpu/ops/pallas/incremental.py
// :308, :355, :385, :401, :437). Not a port of a Pallas kernel: the one
// kernel here copies a () bool from device memory into the node's handle.
//
// wst_if_begin, called while `stream` (the parent) is being captured into a
// graph on `device`:
//   1. creates a conditional handle in the graph being captured and
//      captures one thread that sets it from *pred (1 when true) — so the
//      branch is decided on the device at that point of every replay;
//   2. adds an IF conditional node after it and makes the node the
//      parent's capture dependency (what the parent captures next runs
//      after the node, whether its body ran or not);
//   3. starts capturing `child` into the node's body graph.
// The caller then issues the body on `child` and calls wst_if_end with
// `child` as its stream, which ends that capture. Both return a
// cudaError_t (0: success).
//
// PyTorch 2.11 has no Python binding for conditional nodes; this is what
// its CUDAGraph::begin_capture_to_if_node does in later releases.

#include <cuda_runtime.h>

namespace {

__global__ void set_if_kernel(cudaGraphConditionalHandle handle,
                              const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

}  // namespace

extern "C" int wst_if_begin(const void* pred, void* child, int device,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t ps = static_cast<cudaStream_t>(stream);
  cudaStreamCaptureStatus status;
  unsigned long long id;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n_deps;
  err = cudaStreamGetCaptureInfo(ps, &status, &id, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (status != cudaStreamCaptureStatusActive) {
    return static_cast<int>(cudaErrorIllegalState);
  }
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  set_if_kernel<<<1, 1, 0, ps>>>(handle, static_cast<const bool*>(pred));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // the dependencies now end in the set kernel's node
  err = cudaStreamGetCaptureInfo(ps, &status, &id, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaStreamUpdateCaptureDependencies(ps, &node, 1,
                                            cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaStreamBeginCaptureToGraph(
      static_cast<cudaStream_t>(child), params.conditional.phGraph_out[0],
      nullptr, nullptr, 0, cudaStreamCaptureModeThreadLocal));
}

extern "C" int wst_if_end(int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraph_t body;
  return static_cast<int>(
      cudaStreamEndCapture(static_cast<cudaStream_t>(stream), &body));
}
