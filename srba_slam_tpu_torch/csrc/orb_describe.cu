// K2: upright 256-bit ORB descriptors at K keypoints of blurred images.
//
// Replaces the TPU kernel srba_slam_tpu/ops/pallas_fast.py
// orb_bitplanes_pallas (kernel body _make_orb_kernel), used through
// orb_descriptors_pallas. Output, per keypoint (y, x) of image n:
//   bit 32j+b of word j = blur[y+dy_p, x+dx_p] < blur[y+dy_q, x+dx_q]
// for test 32j+b of OpenCV's rounded bit_pattern_31_, each sample
// coordinate clipped into the image; 0 for invalid keypoints. Words are
// stored as int32 holding the bit pattern of the JAX package's uint32.
// Bit-exact against its plain torch version ops/orb.py upright_descriptors.
//
// What bounds it on an H100: latency of scattered reads and the launch. A
// stereo pair at K=512 makes 2*512*512 four-byte reads (2 MB of requests)
// from a 3.6 MB blurred pair that sits in the 50 MB L2, and writes 32 KB.
//
// What the design does about it: the TPU kernel built image-wide bit-planes
// because its gathers were slow; here the work is done at the keypoints
// only. One warp per keypoint: lane b of the warp evaluates test 32j+b for
// j = 0..7, and __ballot_sync packs the 32 lanes' results into word j, so
// no bit shuffling is needed. The 256 offset quadruples are staged once per
// block in shared memory, where the lanes read consecutive entries. (In
// __constant__ memory, 32 lanes reading 32 different addresses would be
// served one address at a time.)

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;             // keypoints per block
constexpr int N_TESTS = 256;

__global__ void __launch_bounds__(WARPS * 32)
orb_describe_kernel(const float* __restrict__ blurred, const int* __restrict__ ys,
                    const int* __restrict__ xs, const uint8_t* __restrict__ valid,
                    const int4* __restrict__ pattern, int* __restrict__ out,
                    int n_kp_total, int K, int H, int W) {
    __shared__ int4 s_pat[N_TESTS];
    for (int i = threadIdx.x; i < N_TESTS; i += blockDim.x) s_pat[i] = pattern[i];
    __syncthreads();

    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int kp = blockIdx.x * WARPS + warp;   // uniform across the warp
    if (kp >= n_kp_total) return;
    const float* img = blurred + (size_t)(kp / K) * H * W;
    const int y = ys[kp], x = xs[kp];
    const bool ok = valid[kp] != 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        const int4 p = s_pat[32 * j + lane];    // (dy_p, dx_p, dy_q, dx_q)
        const int y1 = min(max(y + p.x, 0), H - 1), x1 = min(max(x + p.y, 0), W - 1);
        const int y2 = min(max(y + p.z, 0), H - 1), x2 = min(max(x + p.w, 0), W - 1);
        const float a = __ldg(img + (size_t)y1 * W + x1);
        const float b = __ldg(img + (size_t)y2 * W + x2);
        const unsigned word = __ballot_sync(0xffffffffu, a < b);
        if (lane == j) out[(size_t)kp * 8 + j] = ok ? (int)word : 0;
    }
}

}  // namespace

// blurred: [n, h, w] float32; ys, xs: [n, k] int32; valid: [n, k] bool
// (one byte each); pattern: [256, 4] int32 (dy_p, dx_p, dy_q, dx_q);
// out: [n, k, 8] int32. All contiguous on the current device; n * k > 0.
// Launches on `stream` and returns cudaGetLastError() of the launch.
extern "C" int srba_orb_describe(const float* blurred, const int* ys, const int* xs,
                                 const uint8_t* valid, const int* pattern, int* out,
                                 int n, int k, int h, int w, void* stream) {
    const int total = n * k;
    const int blocks = (total + WARPS - 1) / WARPS;
    orb_describe_kernel<<<blocks, WARPS * 32, 0, (cudaStream_t)stream>>>(
        blurred, ys, xs, valid, (const int4*)pattern, out, total, k, h, w);
    return (int)cudaGetLastError();
}
