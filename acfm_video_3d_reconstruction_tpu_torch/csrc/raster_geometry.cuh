// Per-(pixel, face) geometry shared by the rasterizer's forward and backward
// kernels, so that both decide `inside`, the zero-area guard and the
// min-of-3 segment distance on the same bits, and the face cull that both
// kernels apply.
//
// Numerics follow ops/rasterizer_cuda.py::_barycentric and _seg operation for
// operation, with IEEE divides (no reciprocal-multiply). The JAX reference is
// compiled by XLA, whose CPU backend contracts x*y - z*w into fma(x, y,
// -(z*w)) and w - t*e into fma(-t, e, w); those fused multiply-adds are
// written out here (__fmaf_rn) and every other contraction is off
// (--fmad=false, ops/cuda_build.py): a one-ULP change in a sub-area flips
// `inside`, the zero-area guard and the z-buffer argmin at silhouette edges,
// edge-on faces and shared edges.
//
// The per-face terms (the area and its guarded denominator, each edge's ex,
// ey and clamped |e|^2) depend on the face alone. The kernels compute them
// once per face with face_area / guard_area / edge and pass them to the
// per-pair functions; the expressions are those of the per-pair version, so
// the bits are the same.
#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ float clip01(float v) { return fminf(fmaxf(v, 0.0f), 1.0f); }

// The pixel centre of pixel index i (column or row) in NDC.
__device__ __forceinline__ float pixel_centre(float i, float size) {
  return (2.0f * i + 1.0f) / size - 1.0f;
}

// Twice the face's signed area, fma(bx - ax, cy - ay, -((by - ay)(cx - ax))).
__device__ __forceinline__ float face_area(float ax, float ay, float bx, float by, float cx,
                                           float cy) {
  return __fmaf_rn(bx - ax, cy - ay, -((by - ay) * (cx - ax)));
}

// The barycentrics' denominator: a near-zero area replaced by 1e-12.
__device__ __forceinline__ float guard_area(float area) {
  return fabsf(area) < 1e-12f ? 1e-12f : area;
}

struct Bary {
  float b0, b1, b2;
};

// Unclipped barycentrics of pixel (px, py) in face (a, b, c): the three
// signed sub-areas over denom = guard_area(face_area(...)).
__device__ __forceinline__ Bary barycentric(float ax, float ay, float bx, float by, float cx,
                                            float cy, float denom, float px, float py) {
  const float w0 = __fmaf_rn(bx - px, cy - py, -((by - py) * (cx - px)));
  const float w1 = __fmaf_rn(cx - px, ay - py, -((cy - py) * (ax - px)));
  const float w2 = __fmaf_rn(ax - px, by - py, -((ay - py) * (bx - px)));
  return {w0 / denom, w1 / denom, w2 / denom};
}

__device__ __forceinline__ bool is_inside(const Bary& b) {
  return (b.b0 >= 0.0f) && (b.b1 >= 0.0f) && (b.b2 >= 0.0f);
}

struct Edge {
  float ex, ey, ee;  // e = v - u and max(|e|^2, 1e-12)
};

__device__ __forceinline__ Edge edge(float ux, float uy, float vx, float vy) {
  const float ex = vx - ux, ey = vy - uy;
  return {ex, ey, fmaxf(__fmaf_rn(ex, ex, ey * ey), 1e-12f)};
}

struct Seg {
  float d2, dx, dy, t;  // squared distance, d = w - t*e, clamped t
};

// Distance from pixel p to segment u -> u + e: t = clip(w.e / |e|^2, 0, 1)
// with w = p - u, d = w - t*e.
__device__ __forceinline__ Seg segment(float ux, float uy, const Edge& e, float px, float py) {
  const float wx = px - ux, wy = py - uy;
  const float t = clip01(__fmaf_rn(wx, e.ex, wy * e.ey) / e.ee);
  const float dx = __fmaf_rn(-t, e.ex, wx);
  const float dy = __fmaf_rn(-t, e.ey, wy);
  return {__fmaf_rn(dx, dx, dy * dy), dx, dy, t};
}

// ---------------------------------------------------------------- culling --
//
// A slot's window is the set of its bin's pixels whose centre lies in the
// face's box widened by the cull margin m, or the whole bin for a face whose
// f32 area is under the threshold T. Every (pixel, slot) pair outside the
// window has in_radius == False, so the kernels skip it without changing an
// output bit: its log term is +0 and it never wins the z-test, and the
// survivors are still walked in slot order (the strict < keeps the first
// minimal slot). ops/rasterizer_cuda.py::cull_windows is the same function
// in PyTorch, constant for constant; tests/test_torch_port_raster.py checks
// the claim exhaustively on the CPU, adversarial faces included.
//
// Why it is exact. Let u = 2^-24, p a pixel centre of the bin (its f32
// value) and the pixel outside the widened box by delta along x (y alike):
// every vertex has x_i - p_x >= delta (or <= -delta). Dx bounds |x_i - p_x|
// and Dy |y_i - p_y| over the vertices and the bin's pixels; Ex, Ey are the
// box's extents.
//  1. Not inside. The exact barycentrics b_i (of these f32 inputs) sum to 1
//     and sum b_i (x_i - p_x) = 0. If N is the sum of the negative ones'
//     magnitudes, N Dx >= (1 + N) delta, so N >= delta / Dx and one b_i
//     (at most two are negative) has b_i <= -delta / (2 Dx): the exact
//     sub-area w_i has |w_i| >= |area| delta / (2 Dx) with the sign
//     opposite to the area's. A sub-area is fma(A, B, -(C D)) of rounded
//     differences with |A|, |C| <= Dx and |B|, |D| <= Dy, so its f32 error
//     is at most (2u + 3u + 2u) Dx Dy + O(u^2) < 8u Dx Dy; the area's alike
//     is < 8u Ex Ey. With |area_f32| >= T = u (64 Dx Dy max(Dx, Dy) / m
//     + 16 Ex Ey) (and >= 1e-12, so the guard keeps the area) and delta
//     > m (1 - 1e-4), the exact area has the computed one's sign and |w_i|
//     > 4 x 8u Dx Dy: the computed w_i keeps its sign, b_i < 0 strictly and
//     `inside` is false. A face under T, which includes every zero-area
//     face (collinear or repeated vertices, for which all three sub-areas
//     can be exactly 0 and `inside` true far outside the box, e.g. along a
//     whole pixel-centre column), keeps the whole bin.
//  2. Out of radius (soft mode). Each segment point u + t e with the
//     computed t in [0, 1] lies in the box, so the exact d_x = w_x - t e_x
//     has |d_x| >= delta; w_x = fl(p_x - u_x) and e_x are off by u Dx and
//     u Ex, so the computed d^2 >= (delta - u (Dx + Ex))^2 (1 - u)^3. With
//     m = sqrt(blur) (1 + 2^-12) + pad, where pad = 2^-18 (Dx + Dy + Ex + Ey
//     + 4) also covers the f32 rounding of the window's pixel bounds (< 8u
//     (Dx + 4) in NDC), the computed d^2 >= blur (1 + 2^-12): d^2 < blur is
//     false, so in_radius is false.
// m is at least kCullMinMarginPx pixels, so T stays bounded in hard mode
// (blur 0). At 256^2, bins 16x128 and the soft margin (3.9 px) T is about
// 0.4 px^2 for a face near the bin: 54 of 44,023 slots of the full-width
// scene take the whole bin (238 in hard mode, margin 1 px).

constexpr float kCullMinMarginPx = 1.0f;  // ops/rasterizer_cuda.py CULL_MIN_MARGIN_PX

struct Window {
  int x0, x1, y0, y1;  // bin-local, inclusive; empty when x0 > x1 or y0 > y1
};

// The window of a face (its six 2D coordinates and face_area) in the bin
// whose top-left pixel is (bin_x0, bin_y0). blur is the blur radius in soft
// mode and 0 in hard mode.
__device__ __forceinline__ Window cull_window(float ax, float ay, float bx, float by, float cx,
                                              float cy, float area, int bin_x0, int bin_y0,
                                              int tile_w, int tile_h, int image_size,
                                              float blur) {
  const float S = (float)image_size;
  const float fx0 = (float)bin_x0, fy0 = (float)bin_y0;
  const float qx0 = pixel_centre(fx0, S), qx1 = pixel_centre(fx0 + (float)(tile_w - 1), S);
  const float qy0 = pixel_centre(fy0, S), qy1 = pixel_centre(fy0 + (float)(tile_h - 1), S);
  const float xmin = fminf(fminf(ax, bx), cx), xmax = fmaxf(fmaxf(ax, bx), cx);
  const float ymin = fminf(fminf(ay, by), cy), ymax = fmaxf(fmaxf(ay, by), cy);
  const float Dx = fmaxf(xmax - qx0, qx1 - xmin);
  const float Dy = fmaxf(ymax - qy0, qy1 - ymin);
  const float Ex = xmax - xmin, Ey = ymax - ymin;
  const float pad = 0x1p-18f * ((((Dx + Dy) + Ex) + Ey) + 4.0f);
  const float m = fmaxf(sqrtf(blur) * (1.0f + 0x1p-12f) + pad, kCullMinMarginPx * 2.0f / S);
  const float Dm = fmaxf(Dx, Dy);
  const float T = fmaxf(0x1p-24f * (64.0f * ((Dx * Dy) * Dm) / m + 16.0f * (Ex * Ey)), 1e-12f);
  if (!(fabsf(area) >= T)) return {0, tile_w - 1, 0, tile_h - 1};
  const float hs = S * 0.5f;
  // first pixel whose centre is >= lo, last whose centre is <= hi
  const float x0 = fminf(fmaxf(ceilf((xmin - m + 1.0f) * hs - 0.5f) - fx0, 0.0f), (float)tile_w);
  const float x1 = fminf(fmaxf(floorf((xmax + m + 1.0f) * hs - 0.5f) - fx0, -1.0f),
                         (float)(tile_w - 1));
  const float y0 = fminf(fmaxf(ceilf((ymin - m + 1.0f) * hs - 0.5f) - fy0, 0.0f), (float)tile_h);
  const float y1 = fminf(fmaxf(floorf((ymax + m + 1.0f) * hs - 0.5f) - fy0, -1.0f),
                         (float)(tile_h - 1));
  return {(int)x0, (int)x1, (int)y0, (int)y1};
}
