// Conditional (IF) nodes for a CUDA graph under stream capture: the device
// side of the steady-state tail's convergence check
// (msm_we_tpu_torch/_graph.py::conditional, step.py::_conditional_rounds).
// Counterpart of the lax.while_loop in
// msm_we_tpu/parallel/sharded.py::steady_state_from_flux, whose body runs
// only while the residual exceeds tol; no Pallas kernel.
//
// The PyTorch the port runs on (2.11) captures no conditional node, so this
// adds one to the graph a stream is capturing: a one-thread kernel copies
// a 0-dim bool tensor into a conditional handle (cudaGraphSetConditional),
// and an IF node after it runs a body graph (a child graph node) only when
// the handle is 1. A round of the tail after convergence so launches one
// tiny kernel and no more. The body graph is captured separately by the
// caller, in the same memory pool, from tensors the capture already holds.
//
// What bounds it: launch latency (one byte read per replay); no work.
// Needs CUDA 12.4 or newer (child graph nodes in a conditional body).
// Plain C interface for ctypes: does not synchronise, allocates nothing.

#include <cuda_runtime.h>

namespace {

__global__ void set_if_kernel(cudaGraphConditionalHandle handle,
                              const bool* flag) {
  cudaGraphSetConditional(handle, *flag ? 1u : 0u);
}

}  // namespace

extern "C" {

// Append to the graph that ``stream`` is capturing: the kernel that sets a
// new conditional handle from ``*flag``, then an IF node on that handle
// whose body is a copy of ``body`` (a captured, uninstantiated graph).
// Later work captured on ``stream`` depends on the IF node.
int msm_graph_add_if(const void* flag, void* body, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph = nullptr;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  cudaError_t err =
      cudaStreamGetCaptureInfo(st, &status, nullptr, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return int(err);
  if (status != cudaStreamCaptureStatusActive)
    return int(cudaErrorStreamCaptureImplicit);
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return int(err);
  set_if_kernel<<<1, 1, 0, st>>>(handle, static_cast<const bool*>(flag));
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  err = cudaStreamGetCaptureInfo(st, &status, nullptr, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return int(err);
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (err != cudaSuccess) return int(err);
  cudaGraphNode_t child;
  err = cudaGraphAddChildGraphNode(&child, params.conditional.phGraph_out[0],
                                   nullptr, 0, static_cast<cudaGraph_t>(body));
  if (err != cudaSuccess) return int(err);
  return int(cudaStreamUpdateCaptureDependencies(
      st, &node, 1, cudaStreamSetCaptureDependencies));
}

}  // extern "C"
