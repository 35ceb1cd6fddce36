// Conditional nodes for a stream capture: the captured registration
// program (models/program.py) wraps each loop step in an "if" node whose
// body runs only while some pair of the batch is not done, so the loop
// stops on the device with no host poll.
//
// se3icp_cond_begin, called while `parent` is capturing: a one-thread
// kernel on `parent` copies the bool at `pred` into a new conditional
// handle; an "if" node on that handle follows it in the parent's graph,
// and `child` (a stream not capturing) starts capturing into the node's
// body graph.  se3icp_cond_end ends the child's capture.  Work issued to
// `child` in between is the body; the parent's next work waits for the
// node.  Both return a cudaError_t (0 on success).
#include <cuda_runtime.h>

#if CUDART_VERSION < 12040
#error "conditional graph nodes need CUDA 12.4 or newer"
#endif

namespace {

__global__ void set_if_kernel(cudaGraphConditionalHandle handle,
                              const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

}  // namespace

extern "C" int se3icp_cond_begin(void* parent, void* child,
                                 const void* pred) {
  cudaStream_t ps = (cudaStream_t)parent;
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  cudaError_t e =
      cudaStreamGetCaptureInfo(ps, &status, nullptr, &graph, &deps, &n_deps);
  if (e != cudaSuccess) return (int)e;
  if (status != cudaStreamCaptureStatusActive)
    return (int)cudaErrorStreamCaptureImplicit;
  cudaGraphConditionalHandle handle;
  e = cudaGraphConditionalHandleCreate(&handle, graph, 0,
                                       cudaGraphCondAssignDefault);
  if (e != cudaSuccess) return (int)e;
  set_if_kernel<<<1, 1, 0, ps>>>(handle, (const bool*)pred);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // the node depends on what the capture's next work would: the kernel
  e = cudaStreamGetCaptureInfo(ps, &status, nullptr, &graph, &deps, &n_deps);
  if (e != cudaSuccess) return (int)e;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  e = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (e != cudaSuccess) return (int)e;
  e = cudaStreamUpdateCaptureDependencies(ps, &node, 1,
                                          cudaStreamSetCaptureDependencies);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaStreamBeginCaptureToGraph(
      (cudaStream_t)child, params.conditional.phGraph_out[0], nullptr,
      nullptr, 0, cudaStreamCaptureModeThreadLocal);
}

extern "C" int se3icp_cond_end(void* child) {
  cudaGraph_t body;
  return (int)cudaStreamEndCapture((cudaStream_t)child, &body);
}
