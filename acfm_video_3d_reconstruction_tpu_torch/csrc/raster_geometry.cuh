// Per-(pixel, face) geometry shared by the rasterizer's forward and backward
// kernels, so that both decide `inside`, the zero-area guard and the
// min-of-3 segment distance on the same bits.
//
// Numerics follow ops/rasterizer_cuda.py::_barycentric and _seg operation for
// operation, with IEEE divides (no reciprocal-multiply). The JAX reference is
// compiled by XLA, whose CPU backend contracts x*y - z*w into fma(x, y,
// -(z*w)) and w - t*e into fma(-t, e, w); those fused multiply-adds are
// written out here (__fmaf_rn) and every other contraction is off
// (--fmad=false, ops/cuda_build.py): a one-ULP change in a sub-area flips
// `inside`, the zero-area guard and the z-buffer argmin at silhouette edges,
// edge-on faces and shared edges.
#pragma once

__device__ __forceinline__ float clip01(float v) { return fminf(fmaxf(v, 0.0f), 1.0f); }

struct Bary {
  float b0, b1, b2;
};

// Unclipped barycentrics of pixel (px, py) in face (a, b, c): the three
// signed sub-areas over the face's area, a near-zero area replaced by 1e-12.
__device__ __forceinline__ Bary barycentric(float ax, float ay, float bx, float by,
                                            float cx, float cy, float px, float py) {
  const float w0 = __fmaf_rn(bx - px, cy - py, -((by - py) * (cx - px)));
  const float w1 = __fmaf_rn(cx - px, ay - py, -((cy - py) * (ax - px)));
  const float w2 = __fmaf_rn(ax - px, by - py, -((ay - py) * (bx - px)));
  const float area = __fmaf_rn(bx - ax, cy - ay, -((by - ay) * (cx - ax)));
  const float denom = fabsf(area) < 1e-12f ? 1e-12f : area;
  return {w0 / denom, w1 / denom, w2 / denom};
}

__device__ __forceinline__ bool is_inside(const Bary& b) {
  return (b.b0 >= 0.0f) && (b.b1 >= 0.0f) && (b.b2 >= 0.0f);
}

struct Seg {
  float d2, dx, dy, t;  // squared distance, d = w - t*e, clamped t
};

// Distance from pixel p to segment u -> v: t = clip(w.e / |e|^2, 0, 1) with
// w = p - u and e = v - u, d = w - t*e.
__device__ __forceinline__ Seg segment(float ux, float uy, float vx, float vy, float px,
                                       float py) {
  const float ex = vx - ux, ey = vy - uy;
  const float wx = px - ux, wy = py - uy;
  const float ee = fmaxf(__fmaf_rn(ex, ex, ey * ey), 1e-12f);
  const float t = clip01(__fmaf_rn(wx, ex, wy * ey) / ee);
  const float dx = __fmaf_rn(-t, ex, wx);
  const float dy = __fmaf_rn(-t, ey, wy);
  return {__fmaf_rn(dx, dx, dy * dy), dx, dy, t};
}
