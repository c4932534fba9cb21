// K1: fused FAST-9/16 corner score + 5x5 keyed non-max suppression.
//
// Replaces the TPU kernel srba_slam_tpu/ops/pallas_fast.py
// fast_nms_pallas (kernel body _make_fast_nms_kernel). Output, for every
// image n of a batch [N, H, W]:
//   score = max over the 16 contiguous 9-tap arcs of
//           max(min(tap - c), -max(tap - c)),
//   zero unless score > threshold, zero within `margin` of a border;
//   key   = score - eps * (y * W + x)       (f32, two separate roundings)
//   out   = score where key >= max(key over the 5x5 window) and score > 0.
// Pixels outside the image have key -inf, as the padding of the JAX
// package's reduce_window. Bit-exact against its plain torch version
// local_max_suppress(fast_score_map(img, th, margin), 2).
//
// What bounds it on an H100: bytes and launch cost, not arithmetic. A
// stereo pair at 370x1226 reads 0.9 MB of uint8 and writes 3.6 MB of f32;
// at 3.35 TB/s that is ~1.4 us, below the cost of the launch itself.
//
// What the design does about it: one block per 32x32 output tile stages the
// tile plus a 5-pixel halo (3 for the circle, 2 for the NMS window) into
// shared memory once, reading the frame's uint8 bytes directly (the value
// equals its f32 cast), computes the scores and keys of the tile plus its
// NMS halo in shared memory, and writes each output pixel once. No
// intermediate map touches device memory. The key is formed with
// __fmul_rn/__fsub_rn so that nvcc cannot contract it into an FMA: plateau
// tie-breaks depend on its exact rounding.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TW = 32;               // output tile width
constexpr int TH = 32;               // output tile height
constexpr int NR = 2;                // NMS radius (5x5 window)
constexpr int CR = 3;                // FAST circle radius
constexpr int HALO = CR + NR;
constexpr int IW = TW + 2 * HALO;    // staged image tile
constexpr int IH = TH + 2 * HALO;
constexpr int SW = TW + 2 * NR;      // score/key tile (output + NMS halo)
constexpr int SH = TH + 2 * NR;

// FAST-9/16 score of the pixel at (cy, cx) of the staged tile: the circle
// taps clockwise from 12 o'clock, as ops/fast.py CIRCLE.
__device__ __forceinline__ float fast_score(const float (*s)[IW], int cy, int cx) {
    const float c = s[cy][cx];
    float d[16];
    d[0] = s[cy - 3][cx] - c;
    d[1] = s[cy - 3][cx + 1] - c;
    d[2] = s[cy - 2][cx + 2] - c;
    d[3] = s[cy - 1][cx + 3] - c;
    d[4] = s[cy][cx + 3] - c;
    d[5] = s[cy + 1][cx + 3] - c;
    d[6] = s[cy + 2][cx + 2] - c;
    d[7] = s[cy + 3][cx + 1] - c;
    d[8] = s[cy + 3][cx] - c;
    d[9] = s[cy + 3][cx - 1] - c;
    d[10] = s[cy + 2][cx - 2] - c;
    d[11] = s[cy + 1][cx - 3] - c;
    d[12] = s[cy][cx - 3] - c;
    d[13] = s[cy - 1][cx - 3] - c;
    d[14] = s[cy - 2][cx - 2] - c;
    d[15] = s[cy - 3][cx - 1] - c;
    float mn3[16], mx3[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
        mn3[i] = fminf(fminf(d[i], d[(i + 1) & 15]), d[(i + 2) & 15]);
        mx3[i] = fmaxf(fmaxf(d[i], d[(i + 1) & 15]), d[(i + 2) & 15]);
    }
    float bright = -INFINITY, dark = INFINITY;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
        bright = fmaxf(bright, fminf(fminf(mn3[i], mn3[(i + 3) & 15]), mn3[(i + 6) & 15]));
        dark = fminf(dark, fmaxf(fmaxf(mx3[i], mx3[(i + 3) & 15]), mx3[(i + 6) & 15]));
    }
    return fmaxf(bright, -dark);
}

template <typename T>
__global__ void __launch_bounds__(256)
fast_nms_kernel(const T* __restrict__ img, float* __restrict__ out, int H, int W,
                float th, int margin, float eps) {
    __shared__ float s_img[IH][IW];
    __shared__ float s_key[SH][SW];
    __shared__ float s_score[TH][TW];

    const int n = blockIdx.z;
    const int x0 = blockIdx.x * TW;
    const int y0 = blockIdx.y * TH;
    const T* src = img + (size_t)n * H * W;
    const int tid = threadIdx.y * blockDim.x + threadIdx.x;
    const int nthr = blockDim.x * blockDim.y;

    // 1. stage the tile plus halo; outside the image reads as 0 (only
    //    pixels within 3 px of a border see it, and the margin zeroes them)
    for (int i = tid; i < IH * IW; i += nthr) {
        const int ly = i / IW, lx = i % IW;
        const int gy = y0 - HALO + ly, gx = x0 - HALO + lx;
        float v = 0.f;
        if (gy >= 0 && gy < H && gx >= 0 && gx < W) v = (float)src[(size_t)gy * W + gx];
        s_img[ly][lx] = v;
    }
    __syncthreads();

    // 2. score, threshold, margin and key for the tile plus the NMS halo
    for (int i = tid; i < SH * SW; i += nthr) {
        const int sy = i / SW, sx = i % SW;
        const int gy = y0 - NR + sy, gx = x0 - NR + sx;
        float key = -INFINITY, score = 0.f;
        if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
            if (gy >= margin && gy < H - margin && gx >= margin && gx < W - margin) {
                score = fast_score(s_img, sy + CR, sx + CR);
                if (!(score > th)) score = 0.f;
            }
            key = __fsub_rn(score, __fmul_rn(eps, (float)(gy * W + gx)));
        }
        s_key[sy][sx] = key;
        if (sy >= NR && sy < NR + TH && sx >= NR && sx < NR + TW) s_score[sy - NR][sx - NR] = score;
    }
    __syncthreads();

    // 3. keep a pixel where its key is the maximum of its 5x5 window
    for (int i = tid; i < TH * TW; i += nthr) {
        const int ty = i / TW, tx = i % TW;
        const int gy = y0 + ty, gx = x0 + tx;
        if (gy >= H || gx >= W) continue;
        float pooled = -INFINITY;
#pragma unroll
        for (int dy = 0; dy <= 2 * NR; ++dy) {
#pragma unroll
            for (int dx = 0; dx <= 2 * NR; ++dx) pooled = fmaxf(pooled, s_key[ty + dy][tx + dx]);
        }
        const float sc = s_score[ty][tx];
        out[((size_t)n * H + gy) * W + gx] = (s_key[ty + NR][tx + NR] >= pooled && sc > 0.f) ? sc : 0.f;
    }
}

}  // namespace

// img: [n, h, w] uint8 (img_is_u8 != 0) or float32, contiguous, on the
// current device; out: [n, h, w] float32. Launches on `stream` and returns
// cudaGetLastError() of the launch.
extern "C" int srba_fast_nms(const void* img, int img_is_u8, float* out, int n, int h, int w,
                             float th, int margin, float eps, void* stream) {
    const dim3 block(32, 8);
    const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, n);
    cudaStream_t s = (cudaStream_t)stream;
    if (img_is_u8) {
        fast_nms_kernel<uint8_t><<<grid, block, 0, s>>>((const uint8_t*)img, out, h, w, th, margin, eps);
    } else {
        fast_nms_kernel<float><<<grid, block, 0, s>>>((const float*)img, out, h, w, th, margin, eps);
    }
    return (int)cudaGetLastError();
}
