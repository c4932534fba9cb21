// K2: upright 256-bit ORB descriptors at K keypoints, with the 7x7 Gaussian
// pre-blur fused in.
//
// Replaces the TPU kernel srba_slam_tpu/ops/pallas_fast.py
// orb_bitplanes_pallas (kernel body _make_orb_kernel), used through
// orb_descriptors_pallas, and the blur in front of it. Output, per keypoint
// (y, x) of image n:
//   bit 32j+b of word j = blur[y+dy_p, x+dx_p] < blur[y+dy_q, x+dx_q]
// for test 32j+b of OpenCV's rounded bit_pattern_31_, each sample
// coordinate clipped into the image; 0 for invalid keypoints. blur is
// ops/orb.py gauss_blur7: a vertical then a horizontal 7-tap pass, zero
// padding outside the image, each tap's product and sum rounded apart, in
// tap order, then rounded half to even. Words are stored as int32 holding
// the bit pattern of the JAX package's uint32. Bit-exact against its plain
// torch version upright_descriptors(gauss_blur7(imgs), ...).
//
// What bounds it on an H100: bytes and latency. A stereo pair at K=512
// samples at most 1024 * 375 distinct points; their 7x7 supports are at
// most the 0.9 MB uint8 pair, and the blur of the sampled points is ~14
// multiply-adds each. The blur as a separate pass wrote and read a 3.6 MB
// f32 pair in ~30 elementwise launches.
//
// What the design does about it: the blur happens at the keypoints only,
// in shared memory, and each keypoint has a block of 4 warps, so that the
// card holds all 1024 keypoints of a pair at once and each one's chain of
// dependent steps is short. The block stages its keypoint's 33x33 frame
// patch (the pattern's reach of 13 plus the blur's 3) as f32, from 3
// aligned 4-byte loads a thread on uint8 frames, all in flight together
// (stage_patch), runs the vertical pass over it (27 x 33
// sums, 7 a thread), and each lane of warp w then takes the horizontal pass
// at its own two sample points of test 32j+lane, for the words j = 2w and
// 2w+1; __ballot_sync packs the 32 lanes' results into word j. A keypoint
// within 13 px of a border, whose samples clip, blurs each clipped sample
// directly from the frame in the same order. The products and sums go
// through __fmul_rn / __fadd_rn so nvcc cannot contract them into FMAs;
// torch rounds each. The lanes read their offset quadruples from the
// 4 KB pattern through the read-only cache, 512 contiguous bytes a warp.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;             // warps per keypoint (one block each)
constexpr int THREADS = WARPS * 32;
constexpr int WORDS_PER_WARP = 8 / WARPS;
constexpr int REACH = 13;            // largest |offset| of the pattern (a CPU test holds it)
constexpr int BR = 3;                // blur radius
constexpr int P = 2 * REACH + 1;     // blurred patch side (27)
constexpr int Q = P + 2 * BR;        // frame patch side (33)
constexpr int RAW_PER = (Q * Q + THREADS - 1) / THREADS;    // patch pixels per thread (9)
constexpr int VERT_PER = (P * Q + THREADS - 1) / THREADS;   // vertical sums per thread (7)

struct Gauss7 {
    float g[7];
};

// blur of the vertical sums v[0..6] (one per column) in tap order
__device__ __forceinline__ float hpass(const float* v, const float* g) {
    float acc = __fmul_rn(g[0], v[0]);
#pragma unroll
    for (int i = 1; i < 7; ++i) acc = __fadd_rn(acc, __fmul_rn(g[i], v[i]));
    return rintf(acc);
}

template <typename T>
__device__ __forceinline__ float pixel(const T* img, int H, int W, int y, int x) {
    return (y >= 0 && y < H && x >= 0 && x < W) ? (float)img[(size_t)y * W + x] : 0.f;
}

// gauss_blur7 at (y, x) of one frame, straight from device memory
template <typename T>
__device__ float blur_at(const T* img, int H, int W, int y, int x, const float* g) {
    float v[7];
#pragma unroll
    for (int j = 0; j < 7; ++j) {
        float acc = __fmul_rn(g[0], pixel(img, H, W, y - BR, x + j - BR));
#pragma unroll
        for (int i = 1; i < 7; ++i)
            acc = __fadd_rn(acc, __fmul_rn(g[i], pixel(img, H, W, y + i - BR, x + j - BR)));
        v[j] = acc;
    }
    return hpass(v, g);
}

// s_raw = the QxQ frame patch from (y0, x0), f32, zero outside the frame.
// [lo, hi) are the addresses of the whole batch's bytes.
// f32 frames: one load a pixel, 9 a thread, all in flight together.
__device__ __forceinline__ void stage_patch(const float* img, uintptr_t, uintptr_t, int H, int W,
                                            int y0, int x0, float (*s_raw)[Q]) {
    float v[RAW_PER];
#pragma unroll
    for (int k = 0; k < RAW_PER; ++k) {
        const int i = threadIdx.x + THREADS * k, r = i / Q, c = i - r * Q;
        v[k] = i < Q * Q ? pixel(img, H, W, y0 + r, x0 + c) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < RAW_PER; ++k) {
        const int i = threadIdx.x + THREADS * k, r = i / Q, c = i - r * Q;
        if (i < Q * Q) s_raw[r][c] = v[k];
    }
}

// uint8 frames: byte loads scattered over 33 rows are what the staging
// spends its time on, so each row is read as the aligned 4-byte words that
// cover it (9 a row, 3 a thread), and each word's bytes that fall in the
// patch and in the frame row are unpacked. A word is read only if one of its
// bytes lies in the frame row. A word that also reaches outside the batch's
// bytes [lo, hi) (its first word, when the tensor does not start 4-aligned;
// its last, when it does not end so) is read byte by byte, so no read
// leaves the tensor.
__device__ __forceinline__ void stage_patch(const uint8_t* img, uintptr_t lo, uintptr_t hi, int H,
                                            int W, int y0, int x0, float (*s_raw)[Q]) {
    constexpr int WPR = (Q + 3 + 3) / 4;      // words a row can span (9)
    constexpr int WORD_PER = (Q * WPR + THREADS - 1) / THREADS;
    uint32_t v[WORD_PER];
#pragma unroll
    for (int k = 0; k < WORD_PER; ++k) {
        const int i = threadIdx.x + THREADS * k, r = i / WPR, j = i - r * WPR;
        const int gy = y0 + r;
        const uintptr_t row = (uintptr_t)img + (uintptr_t)((intptr_t)gy * W);
        const int shift = (int)((row + x0) & 3);
        const int gx = x0 - shift + 4 * j;    // frame column of the word's first byte
        const bool ok = i < Q * WPR && gy >= 0 && gy < H && gx + 3 >= 0 && gx < W;
        const uintptr_t a = row + (uintptr_t)(intptr_t)gx;
        uint32_t word = 0u;
        if (ok && a >= lo && a + 4 <= hi) {
            word = __ldg((const uint32_t*)a);
        } else if (ok) {
            for (int b = 0; b < 4; ++b)
                if (a + b >= lo && a + b < hi) word |= (uint32_t)__ldg((const uint8_t*)(a + b)) << (8 * b);
        }
        v[k] = word;
    }
#pragma unroll
    for (int k = 0; k < WORD_PER; ++k) {
        const int i = threadIdx.x + THREADS * k, r = i / WPR, j = i - r * WPR;
        if (i >= Q * WPR) break;
        const int shift = (int)((uintptr_t)(img + (size_t)(y0 + r) * W + x0) & 3);
#pragma unroll
        for (int b = 0; b < 4; ++b) {
            const int c = 4 * j + b - shift, gx = x0 + c;
            if (c >= 0 && c < Q) s_raw[r][c] = (gx >= 0 && gx < W) ? (float)((v[k] >> (8 * b)) & 0xffu) : 0.f;
        }
    }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
orb_describe_kernel(const T* __restrict__ imgs, const int* __restrict__ ys,
                    const int* __restrict__ xs, const uint8_t* __restrict__ valid,
                    const int4* __restrict__ pattern, Gauss7 gauss, int* __restrict__ out,
                    int K, int H, int W) {
    __shared__ float s_raw[Q][Q];      // frame patch, f32
    __shared__ float s_vert[P][Q];     // its vertical pass
    const int kp = blockIdx.x;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    int* dst = out + (size_t)kp * 8;
    if (!valid[kp]) {                  // uniform across the block
        if (threadIdx.x < 8) dst[threadIdx.x] = 0;
        return;
    }
    float g[7];
#pragma unroll
    for (int t = 0; t < 7; ++t) g[t] = gauss.g[t];
    const T* img = imgs + (size_t)(kp / K) * H * W;
    const int y = ys[kp], x = xs[kp];

    if (y >= REACH && y < H - REACH && x >= REACH && x < W - REACH) {
        // no sample clips: blur the patch in shared memory
        // 1. stage the frame patch
        const uintptr_t lo = (uintptr_t)imgs;
        const uintptr_t hi = lo + (size_t)(gridDim.x / K) * H * W * sizeof(T);
        stage_patch(img, lo, hi, H, W, y - REACH - BR, x - REACH - BR, s_raw);
        __syncthreads();

        // 2. the vertical pass
#pragma unroll
        for (int k = 0; k < VERT_PER; ++k) {
            const int i = threadIdx.x + THREADS * k, r = i / Q, c = i - r * Q;
            if (i < P * Q) {
                float acc = __fmul_rn(g[0], s_raw[r][c]);
#pragma unroll
                for (int t = 1; t < 7; ++t) acc = __fadd_rn(acc, __fmul_rn(g[t], s_raw[r + t][c]));
                s_vert[r][c] = acc;
            }
        }
        __syncthreads();

        // 3. the horizontal pass at each test's two points, the tests, the words
#pragma unroll
        for (int w = 0; w < WORDS_PER_WARP; ++w) {
            const int j = warp * WORDS_PER_WARP + w;
            const int4 p = __ldg(pattern + 32 * j + lane);    // (dy_p, dx_p, dy_q, dx_q)
            const float a = hpass(&s_vert[REACH + p.x][REACH + p.y], g);
            const float b = hpass(&s_vert[REACH + p.z][REACH + p.w], g);
            const unsigned word = __ballot_sync(0xffffffffu, a < b);
            if (lane == 0) dst[j] = (int)word;
        }
    } else {
        // within reach of a border: clip each sample, blur it directly
#pragma unroll 1
        for (int w = 0; w < WORDS_PER_WARP; ++w) {
            const int j = warp * WORDS_PER_WARP + w;
            const int4 p = __ldg(pattern + 32 * j + lane);
            const int y1 = min(max(y + p.x, 0), H - 1), x1 = min(max(x + p.y, 0), W - 1);
            const int y2 = min(max(y + p.z, 0), H - 1), x2 = min(max(x + p.w, 0), W - 1);
            const float a = blur_at(img, H, W, y1, x1, g);
            const float b = blur_at(img, H, W, y2, x2, g);
            const unsigned word = __ballot_sync(0xffffffffu, a < b);
            if (lane == 0) dst[j] = (int)word;
        }
    }
}

}  // namespace

// imgs: [n, h, w] uint8 (img_is_u8 != 0) or float32; ys, xs: [n, k] int32;
// valid: [n, k] bool (one byte each); pattern: [256, 4] int32 (dy_p, dx_p,
// dy_q, dx_q), every |offset| <= 13; g7: the 7 blur weights (host memory);
// out: [n, k, 8] int32. Tensors contiguous on the current device; n * k > 0.
// Launches on `stream` and returns cudaGetLastError() of the launch.
extern "C" int srba_orb_describe(const void* imgs, int img_is_u8, const int* ys, const int* xs,
                                 const uint8_t* valid, const int* pattern, const float* g7,
                                 int* out, int n, int k, int h, int w, void* stream) {
    Gauss7 g;
    for (int i = 0; i < 7; ++i) g.g[i] = g7[i];
    cudaStream_t s = (cudaStream_t)stream;
    if (img_is_u8) {
        orb_describe_kernel<uint8_t><<<n * k, THREADS, 0, s>>>(
            (const uint8_t*)imgs, ys, xs, valid, (const int4*)pattern, g, out, k, h, w);
    } else {
        orb_describe_kernel<float><<<n * k, THREADS, 0, s>>>(
            (const float*)imgs, ys, xs, valid, (const int4*)pattern, g, out, k, h, w);
    }
    return (int)cudaGetLastError();
}
