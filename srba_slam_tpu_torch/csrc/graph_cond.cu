// A captured CUDA graph run under a device-side condition.
//
// ops/cuda_graphs.py replays the step of an iterative solve (a block of GN
// or LM iterations) as one CUDA graph. A step past the loop's exit leaves
// its carry as it was, so a loop run to its cap without reading the exit
// test on the host gives the same bits, at the cost of the masked steps.
// Here the captured step becomes the body of a conditional WHILE node
// (CUDA 12.4) that runs while the carry's `more` flag is set and at most n
// times: a kernel before the node zeroes a step count and sets the node's
// handle, one at the end of the body counts the step and sets it again, so
// the loop's steps are one launch, a step past the exit runs no kernel, and
// the host reads nothing.
//
// `srba_cond_graph_create` makes that loop an executable graph of its own
// (the loops launched from the host). A program captured whole
// (ops/cuda_graphs.py `program`: a batch's VO scan) holds its loops in the
// one graph: `srba_cond_append` adds the same nodes to the stream's active
// capture, and `srba_graph_instantiate` / `srba_graph_launch` run the
// captured program.

#include <cuda_runtime.h>

namespace {

// Before the WHILE node (first = 1) and at the end of its body (first = 0):
// count the steps run, and let the next one run while *pred is set and
// fewer than n have run.
__global__ void while_condition_kernel(cudaGraphConditionalHandle handle, const bool* pred,
                                       int* count, int n, int first) {
    int c = first ? 0 : *count + 1;
    *count = c;
    cudaGraphSetConditional(handle, (*pred && c < n) ? 1u : 0u);
}

cudaError_t add_while_condition(cudaGraphNode_t* node, cudaGraph_t graph,
                                const cudaGraphNode_t* deps, size_t n_deps,
                                cudaGraphConditionalHandle handle, const void* pred,
                                void* count, int n, int first) {
    void* args[] = {&handle, (void*)&pred, &count, &n, &first};
    cudaKernelNodeParams kp = {};
    kp.func = (void*)while_condition_kernel;
    kp.gridDim = dim3(1);
    kp.blockDim = dim3(1);
    kp.kernelParams = args;
    return cudaGraphAddKernelNode(node, graph, deps, n_deps, &kp);
}

// Add to `graph`, after `deps`, up to n steps of `body` (copied) while
// *pred is set, counted in the int `count`; *last is the WHILE node.
cudaError_t add_while(cudaGraphNode_t* last, cudaGraph_t graph, const cudaGraphNode_t* deps,
                      size_t n_deps, void* body, const void* pred, void* count, int n) {
    cudaGraphConditionalHandle handle;
    cudaError_t err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
    cudaGraphNode_t init = nullptr, child = nullptr, tail = nullptr;
    if (err == cudaSuccess) {
        err = add_while_condition(&init, graph, deps, n_deps, handle, pred, count, n, 1);
    }
    cudaGraphNodeParams cp = {};
    if (err == cudaSuccess) {
        cp.type = cudaGraphNodeTypeConditional;
        cp.conditional.handle = handle;
        cp.conditional.type = cudaGraphCondTypeWhile;
        cp.conditional.size = 1;
        err = cudaGraphAddNode(last, graph, &init, 1, &cp);
    }
    if (err == cudaSuccess) {
        err = cudaGraphAddChildGraphNode(&child, cp.conditional.phGraph_out[0], nullptr, 0,
                                         (cudaGraph_t)body);
    }
    if (err == cudaSuccess) {
        err = add_while_condition(&tail, cp.conditional.phGraph_out[0], &child, 1, handle, pred,
                                  count, n, 0);
    }
    return err;
}

}  // namespace

// The executable graph of up to n steps of the captured graph `body` while
// *pred is set (pred and count are read at every launch). Returns a
// cudaError_t: cudaErrorNotSupported where body holds a node that a
// conditional body cannot (a stream-ordered allocation, for one).
extern "C" int srba_cond_graph_create(void* body, const void* pred, void* count, int n,
                                      void** exec_out) {
    cudaGraph_t graph = nullptr;
    cudaError_t err = cudaGraphCreate(&graph, 0);
    if (err != cudaSuccess) return (int)err;
    cudaGraphNode_t last = nullptr;
    err = add_while(&last, graph, nullptr, 0, body, pred, count, n);
    cudaGraphExec_t exec = nullptr;
    if (err == cudaSuccess) err = cudaGraphInstantiate(&exec, graph, 0);
    cudaGraphDestroy(graph);
    if (err == cudaSuccess) {
        *exec_out = (void*)exec;
    } else {
        cudaGetLastError();  // so that the next launch check does not report it
    }
    return (int)err;
}

extern "C" int srba_graph_launch(void* exec, void* stream) {
    return (int)cudaGraphLaunch((cudaGraphExec_t)exec, (cudaStream_t)stream);
}

// Append to the active capture of `stream` the nodes of
// srba_cond_graph_create: up to n steps of the captured graph `body` while
// *pred is set. The stream's capture then continues after them. Returns a
// cudaError_t (cudaErrorStreamCaptureInvalidated where the stream is not
// capturing).
extern "C" int srba_cond_append(void* stream, void* body, const void* pred, void* count,
                                int n) {
    cudaStream_t s = (cudaStream_t)stream;
    if (n <= 0) return (int)cudaSuccess;
    cudaStreamCaptureStatus status;
    cudaGraph_t graph = nullptr;
    const cudaGraphNode_t* deps = nullptr;
    size_t n_deps = 0;
    cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &n_deps);
    if (err == cudaSuccess && status != cudaStreamCaptureStatusActive) {
        err = cudaErrorStreamCaptureInvalidated;
    }
    cudaGraphNode_t last = nullptr;
    if (err == cudaSuccess) err = add_while(&last, graph, deps, n_deps, body, pred, count, n);
    if (err == cudaSuccess) {
        err = cudaStreamUpdateCaptureDependencies(s, &last, 1, cudaStreamSetCaptureDependencies);
    }
    if (err != cudaSuccess) cudaGetLastError();
    return (int)err;
}

// The executable graph of a captured `graph` (instantiated without flags,
// as conditional nodes require of their graph).
extern "C" int srba_graph_instantiate(void* graph, void** exec_out) {
    cudaGraphExec_t exec = nullptr;
    cudaError_t err = cudaGraphInstantiate(&exec, (cudaGraph_t)graph, 0);
    if (err == cudaSuccess) {
        *exec_out = (void*)exec;
    } else {
        cudaGetLastError();
    }
    return (int)err;
}

// Free an executable graph made by srba_cond_graph_create or
// srba_graph_instantiate (the caller has synchronized its device).
extern "C" int srba_graph_exec_destroy(void* exec) {
    cudaError_t err = cudaGraphExecDestroy((cudaGraphExec_t)exec);
    if (err != cudaSuccess) cudaGetLastError();
    return (int)err;
}
