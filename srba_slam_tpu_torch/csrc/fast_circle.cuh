// The FAST-9/16 corner score of one pixel of an image tile staged in shared
// memory, shared by K1 (fast_nms.cu) and K3 (fast_score.cu).
//
// score = max over the 16 contiguous 9-tap arcs of the Bresenham circle of
//         max(min(tap - c), -max(tap - c)),
// the taps clockwise from 12 o'clock, as ops/fast.py CIRCLE. Every value is
// the min or max of one f32 difference, so the result is bit-exact against
// the plain torch version on any device.

#pragma once

#include <math.h>

namespace srba {

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

}  // namespace srba
