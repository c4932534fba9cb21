// The FAST-9/16 corner score of one pixel of an image tile staged in shared
// memory, and the staging of that tile, shared by K1 (fast_nms.cu) and K3
// (fast_score.cu).
//
// score = max over the 16 contiguous 9-tap arcs of the Bresenham circle of
//         max(min(tap - c), -max(tap - c)),
// the taps clockwise from 12 o'clock, as ops/fast.py CIRCLE. Every value is
// the min or max of one f32 difference, so the result is bit-exact against
// the plain torch version on any device.
//
// Two forms: fast_score on f32 pixels (any frame), and fast_score_u8 on
// uint8 frames staged as packed int16 pairs, in Hopper's DPX min/max.
// stage_tile fills the tile for either.

#pragma once

#include <math.h>
#include <stdint.h>

namespace srba {

// A uint8 pixel v staged for fast_score_u8: the int16 pair (v, -v), low lane
// v. v * 0xFFFF0001 = v - (v << 16) mod 2^32, one multiply.
__device__ __forceinline__ uint32_t pack_pm(uint32_t v) { return v * 0xFFFF0001u; }

// fast_score for a uint8 frame, exactly: every difference d = tap - c is an
// integer in [-255, 255], so the f32 score is an integer too. The tile `s`
// holds pack_pm(pixel). A DPX three-way minimum over the taps' pairs
// (t, -t) gives each 3-tap window's (min t, -max t), another each 9-tap
// arc's, and a DPX three-way maximum over the 16 arcs leaves
// (max over arcs of min t, -min over arcs of max t). Subtracting c commutes
// with every min and max, so it comes last, once per lane:
// bright = lo - c, dark = hi + c. 40 DPX instructions (each two lanes of a
// three-way min or max) against fast_score's ~190 f32 operations. Same
// contract on (cy, cx) as fast_score.
template <int IW>
__device__ __forceinline__ float fast_score_u8(const uint32_t (*s)[IW], int cy, int cx) {
    uint32_t t[16];
    t[0] = s[cy - 3][cx];
    t[1] = s[cy - 3][cx + 1];
    t[2] = s[cy - 2][cx + 2];
    t[3] = s[cy - 1][cx + 3];
    t[4] = s[cy][cx + 3];
    t[5] = s[cy + 1][cx + 3];
    t[6] = s[cy + 2][cx + 2];
    t[7] = s[cy + 3][cx + 1];
    t[8] = s[cy + 3][cx];
    t[9] = s[cy + 3][cx - 1];
    t[10] = s[cy + 2][cx - 2];
    t[11] = s[cy + 1][cx - 3];
    t[12] = s[cy][cx - 3];
    t[13] = s[cy - 1][cx - 3];
    t[14] = s[cy - 2][cx - 2];
    t[15] = s[cy - 3][cx - 1];
    uint32_t w3[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) w3[i] = __vimin3_s16x2(t[i], t[(i + 1) & 15], t[(i + 2) & 15]);
    uint32_t w9[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) w9[i] = __vimin3_s16x2(w3[i], w3[(i + 3) & 15], w3[(i + 6) & 15]);
    uint32_t m = __vimax3_s16x2(w9[0], w9[1], w9[2]);
#pragma unroll
    for (int i = 3; i < 15; i += 2) m = __vimax3_s16x2(m, w9[i], w9[i + 1]);
    m = __vimax3_s16x2(m, w9[15], w9[15]);
    const int c = (int)(s[cy][cx] & 0xffffu);
    return (float)max((int)(int16_t)(m & 0xffffu) - c, (int)(int16_t)(m >> 16) + c);
}

// `s` is a staged tile of IW columns; (cy, cx) must lie at least 3 pixels
// inside it.
template <int IW>
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

// A pixel as its tile holds it: pack_pm for fast_score_u8, f32 for fast_score.
__device__ __forceinline__ uint32_t stage_px(uint8_t v) { return pack_pm(v); }
__device__ __forceinline__ float stage_px(float v) { return v; }

// Stage the IH x IW tile of the image `src` [H, W] whose top-left pixel is
// (y_org, x_org) into `s`, each pixel as stage_px gives it; outside the
// image reads as 0. For a block of BX x BY threads and IW - BX extra
// columns: thread (tx, ty) loads column tx of rows ty + BY * k, and the
// extra columns go to the first (IW - BX) * IH threads. Every load of a
// thread is issued before its first store, so their latencies overlap.
// Offsets are int: the caller keeps H * W < 2^31. Call __syncthreads()
// before reading the tile.
template <int IH, int IW, int BX, int BY, typename T, typename S>
__device__ __forceinline__ void stage_tile(const T* __restrict__ src, S (*s)[IW], int H, int W,
                                           int y_org, int x_org) {
    constexpr int ROWS = (IH + BY - 1) / BY;
    constexpr int EXTRA = IW - BX;
    static_assert(EXTRA >= 0 && EXTRA * IH <= BX * BY, "one extra pixel per thread at most");
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int tid = ty * BX + tx;
    const int gx = x_org + tx;
    const int ex_ly = tid / EXTRA, ex_lx = BX + tid % EXTRA;   // by constants
    const int gx_ex = x_org + ex_lx, gy_ex = y_org + ex_ly;
    T v[ROWS];
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
        const int ly = ty + BY * k, gy = y_org + ly;
        v[k] = (ly < IH && (unsigned)gx < (unsigned)W && (unsigned)gy < (unsigned)H)
                   ? src[gy * W + gx] : T(0);
    }
    const bool ex = tid < EXTRA * IH;
    const T v_ex = (ex && (unsigned)gx_ex < (unsigned)W && (unsigned)gy_ex < (unsigned)H)
                       ? src[gy_ex * W + gx_ex] : T(0);
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
        const int ly = ty + BY * k;
        if (ly < IH) s[ly][tx] = stage_px(v[k]);
    }
    if (ex) s[ex_ly][ex_lx] = stage_px(v_ex);
}

}  // namespace srba
