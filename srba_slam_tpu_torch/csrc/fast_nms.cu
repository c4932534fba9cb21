// K1: fused FAST-9/16 corner score + (2r+1)^2 keyed non-max suppression.
//
// Replaces the TPU kernel srba_slam_tpu/ops/pallas_fast.py
// fast_nms_pallas (kernel body _make_fast_nms_kernel). Output, for every
// image n of a batch [N, H, W]:
//   score = max over the 16 contiguous 9-tap arcs of
//           max(min(tap - c), -max(tap - c)),
//   zero unless score > threshold[n], zero within `margin` of a border;
//   key   = score - eps * (y * W + x)       (f32, two separate roundings)
//   out   = score where key >= max(key over the (2r+1)^2 window) and
//           score > 0, for an NMS radius r of 0 to 5 (the radii the TPU
//           kernel's 8-row band halo holds).
// Pixels outside the image have key -inf, as the padding of the JAX
// package's reduce_window. Bit-exact against its plain torch version
// local_max_suppress(fast_score_map(img, th, margin), r). The threshold is
// one value for the batch or one per image (a fleet step detects the
// frames of sequences whose adaptive thresholds differ).
//
// What bounds it on an H100: bytes. A stereo pair at 370x1226 reads 0.9 MB
// of uint8 and writes 3.6 MB of f32 (1.35 us at 3.35 TB/s). Scoring every
// pixel in f32 takes ~190 operations a pixel (2.6 us at the 67 TFLOP/s f32
// rate), but most pixels need far fewer: on street frames the score of only
// about 15% can exceed the threshold (chip_smoke.py counts them).
//
// What the design does about it:
// - uint8 frames (the VO path) score in integer DPX instructions on packed
//   int16 pairs (fast_circle.cuh fast_score_u8): 40 three-way min/max
//   instructions a pixel, each on two lanes, equal to the f32 score bit for
//   bit. Every pixel is scored: skipping the warps whose pixels a cheap
//   bound rules out cost more than it saved on an H100. f32 frames keep the
//   f32 fast_score.
// - One block of 128 x 4 threads per (128 - 2r) x (36 - 2r) output tile
//   (124 x 32 at the default r = 2). Each thread owns one column of the
//   128 x 36 score tile (the output plus the r-px NMS halo) and every 4th
//   row of it, so all threads do the same work, no index is divided, and
//   every radius stages the same 134 x 42 tile. At 2x370x1226 and r = 2 the
//   grid is 10 x 12 x 2 = 240 blocks: one wave at two blocks an SM.
// - The tile plus its (3 + r)-px halo (3 for the circle, r for the NMS
//   window) is staged in shared memory once from the frame's own bytes;
//   scores stay in registers, keys in shared memory, and the window max is
//   separable: a (2r+1)-wide row max into the staging buffer, then a
//   (2r+1)-high column max. No intermediate map touches device memory.
// - The key is formed with __fmul_rn/__fsub_rn so that nvcc cannot contract
//   it into an FMA: plateau tie-breaks depend on its exact rounding.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "fast_circle.cuh"

namespace {

constexpr int CR = 3;                // FAST circle radius
constexpr int BX = 128;              // threads along x = score tile width
constexpr int BY = 4;                // threads along y
constexpr int SW = BX;               // score/key tile (output + NMS halo)
constexpr int SH = 36;               // = BY * 9 score rows, for every radius
constexpr int IW = SW + 2 * CR;      // staged image tile (134 x 42)
constexpr int IH = SH + 2 * CR;
constexpr int ROWS = SH / BY;        // score rows per thread
static_assert(SH % BY == 0, "score rows must split evenly over the threads");

// The output tile of NMS radius NR: the score tile less the NMS halo.
template <int NR>
struct Tile {
    static_assert(NR >= 0 && 2 * NR < SH, "NMS radius out of range");
    static constexpr int TW = SW - 2 * NR;   // 124 at NR = 2
    static constexpr int TH = SH - 2 * NR;   // 32 at NR = 2
};

template <typename S>
union Staging {
    S img[IH][IW];                   // the frame tile, as staged for scoring
    float rowmax[SH][SW];            // then the row maxima of the keys
};

template <typename T, int NR>
__global__ void __launch_bounds__(BX * BY, 2)
fast_nms_kernel(const T* __restrict__ img, float* __restrict__ out, int H, int W,
                float th, const float* __restrict__ thr, int margin, float eps) {
    constexpr bool kU8 = std::is_same<T, uint8_t>::value;
    constexpr int TW = Tile<NR>::TW, TH = Tile<NR>::TH;
    using S = decltype(srba::stage_px(T()));
    __shared__ Staging<S> s_buf;
    __shared__ float s_key[SH][SW];

    const int n = blockIdx.z;
    const int x0 = blockIdx.x * TW;
    const int y0 = blockIdx.y * TH;
    const int tx = threadIdx.x, ty = threadIdx.y;
    const T* src = img + (size_t)n * H * W;
    const float t = thr != nullptr ? thr[n] : th;   // this image's threshold

    // 1. stage the tile plus halo; outside the image reads as 0 (only
    //    pixels within 3 px of a border see it, and the margin zeroes them)
    srba::stage_tile<IH, IW, BX, BY>(src, s_buf.img, H, W, y0 - NR - CR, x0 - NR - CR);
    __syncthreads();

    // 2. score, threshold, margin and key of the thread's score pixels
    //    (column tx, rows ty + BY * i); the scores stay in registers
    const int gx = x0 - NR + tx;
    const bool col_in = gx >= 0 && gx < W;
    const bool col_inner = gx >= margin && gx < W - margin;
    float score[ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
        const int sy = ty + BY * i;
        const int gy = y0 - NR + sy;
        float s;
        if constexpr (kU8) s = srba::fast_score_u8<IW>(s_buf.img, sy + CR, tx + CR);
        else s = srba::fast_score<IW>(s_buf.img, sy + CR, tx + CR);
        const bool inner = col_inner && gy >= margin && gy < H - margin;
        score[i] = (inner && s > t) ? s : 0.f;
        s_key[sy][tx] = (col_in && gy >= 0 && gy < H)
                            ? __fsub_rn(score[i], __fmul_rn(eps, (float)(gy * W + gx)))
                            : -INFINITY;
    }
    __syncthreads();

    // 3. (2NR+1)-wide row maxima of the keys, into the staging buffer (free
    //    now); a max is exact in any order
    const bool out_col = tx >= NR && tx < SW - NR;
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
        const int sy = ty + BY * i;
        if (out_col) {
            const float* k = &s_key[sy][tx - NR];
            float m = k[0];
#pragma unroll
            for (int d = 1; d <= 2 * NR; ++d) m = fmaxf(m, k[d]);
            s_buf.rowmax[sy][tx - NR] = m;
        }
    }
    __syncthreads();

    // 4. keep a pixel where its key is the maximum of its window
    if (!out_col || gx >= W) return;
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
        const int sy = ty + BY * i;
        const int gy = y0 - NR + sy;
        if (sy < NR || sy >= SH - NR || gy >= H) continue;
        const int ox = tx - NR;
        float pooled = s_buf.rowmax[sy - NR][ox];
#pragma unroll
        for (int d = 1 - NR; d <= NR; ++d) pooled = fmaxf(pooled, s_buf.rowmax[sy + d][ox]);
        out[((size_t)n * H + gy) * W + gx] =
            (s_key[sy][tx] >= pooled && score[i] > 0.f) ? score[i] : 0.f;
    }
}

template <int NR>
void launch(const void* img, int img_is_u8, float* out, int n, int h, int w, float th,
            const float* thr, int margin, float eps, cudaStream_t s) {
    constexpr int TW = Tile<NR>::TW, TH = Tile<NR>::TH;
    const dim3 block(BX, BY);
    const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, n);
    if (img_is_u8) {
        fast_nms_kernel<uint8_t, NR><<<grid, block, 0, s>>>((const uint8_t*)img, out, h, w, th,
                                                            thr, margin, eps);
    } else {
        fast_nms_kernel<float, NR><<<grid, block, 0, s>>>((const float*)img, out, h, w, th, thr,
                                                          margin, eps);
    }
}

}  // namespace

// img: [n, h, w] uint8 (img_is_u8 != 0) or float32, contiguous, on the
// current device; out: [n, h, w] float32; thr: null (every image takes
// `th`) or float32 [n] on the device (image i takes thr[i]); radius 0-5.
// Launches on `stream` and returns cudaGetLastError() of the launch, or
// cudaErrorInvalidValue for another radius.
extern "C" int srba_fast_nms(const void* img, int img_is_u8, float* out, int n, int h, int w,
                             float th, const float* thr, int margin, int radius, float eps,
                             void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    switch (radius) {
        case 0: launch<0>(img, img_is_u8, out, n, h, w, th, thr, margin, eps, s); break;
        case 1: launch<1>(img, img_is_u8, out, n, h, w, th, thr, margin, eps, s); break;
        case 2: launch<2>(img, img_is_u8, out, n, h, w, th, thr, margin, eps, s); break;
        case 3: launch<3>(img, img_is_u8, out, n, h, w, th, thr, margin, eps, s); break;
        case 4: launch<4>(img, img_is_u8, out, n, h, w, th, thr, margin, eps, s); break;
        case 5: launch<5>(img, img_is_u8, out, n, h, w, th, thr, margin, eps, s); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
