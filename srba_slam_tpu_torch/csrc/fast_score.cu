// K3: FAST-9/16 corner score map, without suppression.
//
// Replaces the TPU kernel srba_slam_tpu/ops/pallas_fast.py
// fast_score_map_pallas (kernel body _make_kernel). Output, for every image
// n of a batch [N, H, W]:
//   score = FAST-9/16 score (fast_circle.cuh), zero unless score >
//           threshold[n] (one threshold for the batch or one per image),
//           zero within `margin` of a border.
// Bit-exact against its plain torch version ops/fast.py fast_score_map. The
// plain version and the TPU kernel roll the image at its borders. From a
// margin of 3 on the circle of every pixel that keeps a score lies inside the
// image, the margin masks that wrap, and this kernel stages a zero-filled
// halo instead. Under a margin of 3 a pixel near a border keeps the score
// of a circle that wraps to the opposite border, so there the kernel stages
// the halo from the wrapped coordinates (stage_tile_wrap).
//
// What bounds it on an H100: by its bytes, little. One 370x1226 image reads
// 0.45 MB of uint8 (1.8 MB of f32) and writes 1.8 MB of f32: 0.68 us at
// 3.35 TB/s for uint8; four fifths of it is the output. The launch alone
// takes about 1.2 us of device time, and scoring every pixel takes ~70
// instructions a pixel even in DPX, so launch, staging latency and the
// score's instruction issue are what bind (measured in PERF.md).
//
// What the design does about it (K1's, fast_nms.cu, without the NMS):
// - uint8 frames score in DPX instructions on packed int16 pairs
//   (fast_circle.cuh fast_score_u8), 40 three-way min/max a pixel, bit for
//   bit the f32 score; f32 frames keep the f32 fast_score.
// - One block of 128 x 4 threads per 128 x 32 output tile: each thread owns
//   one column of the tile and every 4th row of it, so all threads do the
//   same work, no index is divided, and each warp writes one row of 32
//   floats (128 bytes) at a time.
// - The tile plus its 3-px circle halo (134 x 38) is staged in shared
//   memory once (fast_circle.cuh stage_tile, as K1 stages), from the
//   frame's own bytes, every load of a thread issued before its first store.
// - 32-row tiles: one 370x1226 image is 10 x 12 = 120 blocks, one an SM;
//   a stereo pair 240, two an SM. Both shapes run in one wave. On an H100
//   16-row tiles (twice the blocks, 1.38x the staged rows against 1.19x)
//   were slower at both shapes, as were blocks of 128 x 2 and 128 x 8
//   threads, and persistent blocks that load the next tile while scoring
//   the current one (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "fast_circle.cuh"

namespace {

constexpr int CR = 3;                // FAST circle radius = halo
constexpr int BX = 128;              // threads along x = output tile width
constexpr int BY = 4;                // threads along y
constexpr int TW = BX;
constexpr int TH = 32;               // output tile height
constexpr int IW = TW + 2 * CR;      // staged tile (134 x 38)
constexpr int IH = TH + 2 * CR;
constexpr int ROWS = TH / BY;        // output rows per thread
static_assert(TH % BY == 0, "output rows must split evenly over the threads");

// The staged tile with the image wrapped at its borders, as torch.roll wraps
// it: tile pixel (ly, lx) is src[(y_org + ly) mod H][(x_org + lx) mod W].
// Only margins under 3 need it, which no timed path uses, so it is the plain
// strided loop.
template <typename T, typename S>
__device__ __forceinline__ void stage_tile_wrap(const T* __restrict__ src, S (*s)[IW], int H, int W,
                                                int y_org, int x_org) {
    const int tid = threadIdx.y * BX + threadIdx.x;
    for (int i = tid; i < IH * IW; i += BX * BY) {
        const int ly = i / IW, lx = i % IW;
        const int gy = ((y_org + ly) % H + H) % H;
        const int gx = ((x_org + lx) % W + W) % W;
        s[ly][lx] = srba::stage_px(src[gy * W + gx]);
    }
}

template <typename T, bool WRAP>
__global__ void __launch_bounds__(BX * BY, 2)
fast_score_kernel(const T* __restrict__ img, float* __restrict__ out, int H, int W,
                  float th, const float* __restrict__ thr, int margin) {
    using S = decltype(srba::stage_px(T()));
    __shared__ S s_img[IH][IW];

    const int n = blockIdx.z;
    const int x0 = blockIdx.x * TW;
    const int y0 = blockIdx.y * TH;
    const int tx = threadIdx.x, ty = threadIdx.y;
    const T* src = img + (size_t)n * H * W;
    float* dst = out + (size_t)n * H * W;
    const float t = thr != nullptr ? thr[n] : th;   // this image's threshold

    // 1. stage the tile plus halo; outside the image reads as 0 (only pixels
    //    within 3 px of a border see it, and a margin >= 3 zeroes them), or
    //    as the wrapped image where the margin keeps such pixels
    if constexpr (WRAP) {
        stage_tile_wrap(src, s_img, H, W, y0 - CR, x0 - CR);
    } else {
        srba::stage_tile<IH, IW, BX, BY>(src, s_img, H, W, y0 - CR, x0 - CR);
    }
    __syncthreads();

    // 2. score, threshold and margin of the thread's pixels (column tx, rows
    //    ty + BY * i), each written once; int offsets (H * W < 2^31)
    const int gx = x0 + tx;
    if (gx >= W) return;
    const bool col_inner = gx >= margin && gx < W - margin;
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
        const int ly = ty + BY * i;
        const int gy = y0 + ly;
        if (gy >= H) break;
        float s;
        if constexpr (std::is_same<T, uint8_t>::value) {
            s = srba::fast_score_u8<IW>(s_img, ly + CR, tx + CR);
        } else {
            s = srba::fast_score<IW>(s_img, ly + CR, tx + CR);
        }
        const bool inner = col_inner && gy >= margin && gy < H - margin;
        dst[gy * W + gx] = (inner && s > t) ? s : 0.f;
    }
}

// Does nothing: the device time of a launch alone, at any grid and block
// (utils/kernel_timing.py launch_floor_ms).
__global__ void empty_kernel() {}

}  // namespace

// img: [n, h, w] uint8 (img_is_u8 != 0) or float32, contiguous, on the
// current device; out: [n, h, w] float32; thr: null (every image takes
// `th`) or float32 [n] on the device (image i takes thr[i]); margin >= 0.
// Launches on `stream` and returns cudaGetLastError() of the launch.
extern "C" int srba_fast_score(const void* img, int img_is_u8, float* out, int n, int h, int w,
                               float th, const float* thr, int margin, void* stream) {
    const dim3 block(BX, BY);
    const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, n);
    cudaStream_t s = (cudaStream_t)stream;
    const bool wrap = margin < CR;
    if (img_is_u8 && wrap) {
        fast_score_kernel<uint8_t, true><<<grid, block, 0, s>>>((const uint8_t*)img, out, h, w, th, thr, margin);
    } else if (img_is_u8) {
        fast_score_kernel<uint8_t, false><<<grid, block, 0, s>>>((const uint8_t*)img, out, h, w, th, thr, margin);
    } else if (wrap) {
        fast_score_kernel<float, true><<<grid, block, 0, s>>>((const float*)img, out, h, w, th, thr, margin);
    } else {
        fast_score_kernel<float, false><<<grid, block, 0, s>>>((const float*)img, out, h, w, th, thr, margin);
    }
    return (int)cudaGetLastError();
}

// Launches the empty kernel on a grid gx x gy x gz of bx x by x bz blocks;
// returns cudaGetLastError() of the launch.
extern "C" int srba_empty_launch(int gx, int gy, int gz, int bx, int by, int bz, void* stream) {
    empty_kernel<<<dim3(gx, gy, gz), dim3(bx, by, bz), 0, (cudaStream_t)stream>>>();
    return (int)cudaGetLastError();
}
