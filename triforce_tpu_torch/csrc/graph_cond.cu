// Conditional nodes in a CUDA graph under stream capture: the device side
// of ``graphs.GraphSet.cond`` (the counterpart of JAX's ``lax.cond`` and of
// the bodies of its ``while_loop``s in ``triforce_tpu/engine.py``).
//
// A CUDA graph replays fixed work; an if-node (CUDA 12.4+) runs its body
// graph only where a value set on the device in the same launch is
// non-zero, so a replayed decode step decides on the card and the host
// reads nothing back. PyTorch 2.11 does not expose conditional nodes, so
// this library adds one to the graph a stream is capturing:
//
//   tf_cond_begin(parent, pred, child):
//     * the graph ``parent`` is capturing and its current dependencies
//       (cudaStreamGetCaptureInfo);
//     * a conditional handle of that graph (cudaGraphConditionalHandleCreate);
//     * one one-thread kernel, captured on ``parent``, that sets the handle
//       from the bool at ``pred`` (cudaGraphSetConditional);
//     * an if-node after it (cudaGraphAddNode of a cudaGraphNodeTypeConditional,
//       cudaGraphCondTypeIf), which becomes ``parent``'s only dependency;
//     * ``child`` (an idle stream) starts capturing into the node's body
//       graph (cudaStreamBeginCaptureToGraph).
//   tf_cond_end(child): ``child`` stops capturing; its work is the body.
//
// The caller launches the body's work on ``child`` between the two calls
// and routes the allocations it makes there to a memory pool of the
// capture. Nothing here is a compute kernel: the set kernel reads one bool.

#include <cuda_runtime.h>

namespace {

__global__ void tf_set_cond_kernel(cudaGraphConditionalHandle handle,
                                   const bool* pred) {
    cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

cudaError_t capture_info(cudaStream_t s, cudaGraph_t* graph,
                         const cudaGraphNode_t** deps, size_t* n) {
    cudaStreamCaptureStatus status;
#if CUDART_VERSION >= 13000
    cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, graph,
                                               deps, nullptr, n);
#else
    cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, graph,
                                               deps, n);
#endif
    if (err != cudaSuccess) return err;
    return status == cudaStreamCaptureStatusActive
               ? cudaSuccess : cudaErrorIllegalState;
}

}  // namespace

extern "C" int tf_cond_begin(void* parent_stream, const void* pred,
                             void* child_stream) {
    cudaStream_t parent = static_cast<cudaStream_t>(parent_stream);
    cudaStream_t child = static_cast<cudaStream_t>(child_stream);
    cudaGraph_t graph;
    const cudaGraphNode_t* deps;
    size_t n;
    cudaError_t err = capture_info(parent, &graph, &deps, &n);
    if (err != cudaSuccess) return err;
    cudaGraphConditionalHandle handle;
    err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
    if (err != cudaSuccess) return err;
    tf_set_cond_kernel<<<1, 1, 0, parent>>>(handle,
                                            static_cast<const bool*>(pred));
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    err = capture_info(parent, &graph, &deps, &n);   // now after the kernel
    if (err != cudaSuccess) return err;
    cudaGraphNodeParams params = {};
    params.type = cudaGraphNodeTypeConditional;
    params.conditional.handle = handle;
    params.conditional.type = cudaGraphCondTypeIf;
    params.conditional.size = 1;
    cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
    err = cudaGraphAddNode(&node, graph, deps, nullptr, n, &params);
#else
    err = cudaGraphAddNode(&node, graph, deps, n, &params);
#endif
    if (err != cudaSuccess) return err;
#if CUDART_VERSION >= 13000
    err = cudaStreamUpdateCaptureDependencies(
        parent, &node, nullptr, 1, cudaStreamSetCaptureDependencies);
#else
    err = cudaStreamUpdateCaptureDependencies(
        parent, &node, 1, cudaStreamSetCaptureDependencies);
#endif
    if (err != cudaSuccess) return err;
    return cudaStreamBeginCaptureToGraph(child, params.conditional.phGraph_out[0],
                                         nullptr, nullptr, 0,
                                         cudaStreamCaptureModeGlobal);
}

extern "C" int tf_cond_end(void* child_stream) {
    cudaGraph_t body;
    return cudaStreamEndCapture(static_cast<cudaStream_t>(child_stream),
                                &body);
}
