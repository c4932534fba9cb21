// A captured CUDA graph run under a device-side condition.
//
// ops/cuda_graphs.py replays the step of an iterative solve (a block of GN
// or LM iterations) as one CUDA graph. A step past the loop's exit leaves
// its carry as it was, so a loop run to its cap without reading the exit
// test on the host gives the same bits, at the cost of the masked steps.
// Here the captured step becomes the body of a conditional node (CUDA
// 12.4): each launch first copies the carry's `more` flag into the node's
// handle, and the body runs only while it is set, so a step past the exit
// costs one launch and one one-thread kernel, with no host read.

#include <cuda_runtime.h>

namespace {

__global__ void set_condition_kernel(cudaGraphConditionalHandle handle, const bool* pred) {
    cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

}  // namespace

// The executable graph "set the handle from *pred, then if it is set run
// body" (body is cloned; pred is read at every launch). Returns a
// cudaError_t: cudaErrorNotSupported where body holds a node that a
// conditional body cannot (a stream-ordered allocation, for one).
extern "C" int srba_cond_graph_create(void* body, const void* pred, void** exec_out) {
    cudaGraph_t outer = nullptr;
    cudaError_t err = cudaGraphCreate(&outer, 0);
    if (err != cudaSuccess) return (int)err;
    cudaGraphConditionalHandle handle;
    err = cudaGraphConditionalHandleCreate(&handle, outer, 0, 0);
    cudaGraphNode_t set_node = nullptr, cond_node = nullptr, child = nullptr;
    if (err == cudaSuccess) {
        void* args[] = {&handle, (void*)&pred};
        cudaKernelNodeParams kp = {};
        kp.func = (void*)set_condition_kernel;
        kp.gridDim = dim3(1);
        kp.blockDim = dim3(1);
        kp.kernelParams = args;
        err = cudaGraphAddKernelNode(&set_node, outer, nullptr, 0, &kp);
    }
    cudaGraphNodeParams cp = {};
    if (err == cudaSuccess) {
        cp.type = cudaGraphNodeTypeConditional;
        cp.conditional.handle = handle;
        cp.conditional.type = cudaGraphCondTypeIf;
        cp.conditional.size = 1;
        err = cudaGraphAddNode(&cond_node, outer, &set_node, 1, &cp);
    }
    if (err == cudaSuccess) {
        err = cudaGraphAddChildGraphNode(&child, cp.conditional.phGraph_out[0], nullptr, 0,
                                         (cudaGraph_t)body);
    }
    cudaGraphExec_t exec = nullptr;
    if (err == cudaSuccess) err = cudaGraphInstantiate(&exec, outer, 0);
    cudaGraphDestroy(outer);
    if (err == cudaSuccess) {
        *exec_out = (void*)exec;
    } else {
        cudaGetLastError();  // so that the next launch check does not report it
    }
    return (int)err;
}

extern "C" int srba_cond_graph_launch(void* exec, void* stream) {
    return (int)cudaGraphLaunch((cudaGraphExec_t)exec, (cudaStream_t)stream);
}
