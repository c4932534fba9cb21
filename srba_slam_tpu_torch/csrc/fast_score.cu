// K3: FAST-9/16 corner score map, without suppression.
//
// Replaces the TPU kernel srba_slam_tpu/ops/pallas_fast.py
// fast_score_map_pallas (kernel body _make_kernel). Output, for every image
// n of a batch [N, H, W]:
//   score = FAST-9/16 score (fast_circle.cuh), zero unless score > threshold,
//           zero within `margin` of a border (margin >= 3, so that the circle
//           of every pixel that keeps a score lies inside the image).
// Bit-exact against its plain torch version ops/fast.py fast_score_map. The
// TPU kernel rolls its lanes at the row ends; the margin masks that wrap, as
// it masks this kernel's zero-filled halo.
//
// What bounds it on an H100: bytes and launch cost. One 370x1226 image reads
// 0.45 MB of uint8 (1.8 MB of f32) and writes 1.8 MB of f32: about 1 us at
// 3.35 TB/s, below the cost of the launch.
//
// What the design does about it: K1's tiling without the NMS pass. One block
// per 32x32 output tile stages the tile plus the 3-pixel circle halo in
// shared memory once, reading the frame's own dtype (a uint8 value equals its
// f32 cast), and writes each output pixel once.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fast_circle.cuh"

namespace {

constexpr int TW = 32;               // output tile width
constexpr int TH = 32;               // output tile height
constexpr int CR = 3;                // FAST circle radius = halo
constexpr int IW = TW + 2 * CR;      // staged image tile
constexpr int IH = TH + 2 * CR;

template <typename T>
__global__ void __launch_bounds__(256)
fast_score_kernel(const T* __restrict__ img, float* __restrict__ out, int H, int W,
                  float th, int margin) {
    __shared__ float s_img[IH][IW];

    const int n = blockIdx.z;
    const int x0 = blockIdx.x * TW;
    const int y0 = blockIdx.y * TH;
    const T* src = img + (size_t)n * H * W;
    const int tid = threadIdx.y * blockDim.x + threadIdx.x;
    const int nthr = blockDim.x * blockDim.y;

    // 1. stage the tile plus halo; outside the image reads as 0 (only pixels
    //    within 3 px of a border see it, and the margin zeroes them)
    for (int i = tid; i < IH * IW; i += nthr) {
        const int ly = i / IW, lx = i % IW;
        const int gy = y0 - CR + ly, gx = x0 - CR + lx;
        float v = 0.f;
        if (gy >= 0 && gy < H && gx >= 0 && gx < W) v = (float)src[(size_t)gy * W + gx];
        s_img[ly][lx] = v;
    }
    __syncthreads();

    // 2. score, threshold and margin of every output pixel
    for (int i = tid; i < TH * TW; i += nthr) {
        const int ty = i / TW, tx = i % TW;
        const int gy = y0 + ty, gx = x0 + tx;
        if (gy >= H || gx >= W) continue;
        float score = 0.f;
        if (gy >= margin && gy < H - margin && gx >= margin && gx < W - margin) {
            score = srba::fast_score<IW>(s_img, ty + CR, tx + CR);
            if (!(score > th)) score = 0.f;
        }
        out[((size_t)n * H + gy) * W + gx] = score;
    }
}

}  // namespace

// img: [n, h, w] uint8 (img_is_u8 != 0) or float32, contiguous, on the
// current device; out: [n, h, w] float32. Launches on `stream` and returns
// cudaGetLastError() of the launch.
extern "C" int srba_fast_score(const void* img, int img_is_u8, float* out, int n, int h, int w,
                               float th, int margin, void* stream) {
    const dim3 block(32, 8);
    const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, n);
    cudaStream_t s = (cudaStream_t)stream;
    if (img_is_u8) {
        fast_score_kernel<uint8_t><<<grid, block, 0, s>>>((const uint8_t*)img, out, h, w, th, margin);
    } else {
        fast_score_kernel<float><<<grid, block, 0, s>>>((const float*)img, out, h, w, th, margin);
    }
    return (int)cudaGetLastError();
}
