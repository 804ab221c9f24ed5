// Binned soft rasterizer, backward pass (sm_90a).
//
// Replaces acfm_video_3d_reconstruction_tpu/ops/rasterizer_tpu.py::_bwd_kernel
// (with _soft_logterm_grad), the Pallas TPU kernel launched by _soft_bwd.
//
// The forward (raster_fwd.cu, soft mode) computes per pixel
//   S = sum over the bin's in-radius slots of log_sigmoid(signed d^2 / sigma).
// Given A = dL/dS (B, H, W) this kernel writes, for each (view b, bin t,
// slot k), the gradient of sum_pixels A * S with respect to the slot's six
// 2D face coordinates:
//   grad (B, T, K, 9) rows [gax gay gbx gby gcx gcy 0 0 0].
// z never enters S, so the z columns are 0; every slot at or past the bin's
// count is a zero row (ops/rasterizer_cuda.py scatters the rows back to the
// faces by autograd, and an invalid slot gathers face 0).
//
// Per (pixel, slot), as _soft_logterm_grad derives it:
//   g = A * sigmoid(-signed/sigma) / sigma, negated inside the face, 0 when
//       the face is not in radius;
//   the min of the three segment distances routes g as jnp.minimum's VJP
//   does: ties split 50/50 at each nesting level (sliver faces make
//   d20 == d22 over whole regions);
//   each segment's endpoints take the envelope-theorem gradient of its
//   clamped point-segment distance, d = w - t*e:
//   dd^2/du = 2 d (t - 1), dd^2/dv = -2 t d.
// `inside`, the zero-area guard, t and the min-of-3 use the forward's
// arithmetic bit for bit (raster_geometry.cuh), so each decides as it did in
// the forward.
//
// Design: one block per (view, bin, group of kWarps slots); warp w of the
// block owns slot k = group * kWarps + w. The warp computes the slot's
// per-face terms (the guarded area, each edge's ex, ey and clamped |e|^2,
// raster_geometry.cuh's expressions) and its cull window (cull_window, the
// forward's predicate and whole-bin rule, soft mode) once, in registers, and
// its lanes walk only the window's pixels, row-major, 32 at a time: each
// lane reads A from global memory (L2; rows are contiguous in x), forms its
// pixel centre in registers and keeps six partial sums; one xor-shuffle
// reduction per slot writes the slot's row. A pixel outside the window has
// in_radius == False (raster_geometry.cuh), so its g is exactly 0 and
// skipping it changes only the order of the sums. No atomics: every row has
// one writer and a fixed summation order, so the kernel is deterministic.
// Blocks whose group lies past the bin's count only write zero rows, and
// every slot past the count is an exact zero row. A block per bin that
// stages the bin's A once in shared memory, its warps taking the slots in
// turn, was timed and was slower (PERF.md).
//
// Bound: fp32 ALU work. The operations the function needs (an FMA counts
// two) per (pixel, valid slot) pair, 130:
//   six pixel-relative differences 6, three sub-areas 9, three divides by
//   the area 3, the inside test 5; three point-segment distances 39 (the
//   dot 3, a divide 1, the clip 2, two FMAs 4, the squared length 3, each);
//   the min of three 2, the signed select 2, the radius test 2; g: v 1, the
//   sigmoid 3, / sigma and * A 2, the sign and radius selects 3; the tie
//   routing 14 (four compares, four selects, one product, five for g0..g2);
//   the endpoint gradients 33 (t - 1 three, twelve products by d, twelve by
//   g, six differences); the six sums 6.
// A pair out of radius needs only the tests before g, 68: its g is 0. Per
// (view, face), once: the area and its zero guard 10 and each edge's ex,
// ey, |e|^2 and clamp 18 (28). The pairs these inputs need are the
// windows' pixels (ops/rasterizer_cuda.py::cull_pair_counts "needed", ~6%
// of the bins' pairs at 256^2), at full cost where in radius and at the
// tests' cost elsewhere; the kernel walks them in whole warps ("warp").
// Bytes are small: the face row is read once per slot, A once per window
// pixel, and each slot writes 36 B.

#include <cuda_runtime.h>

#include "raster_geometry.cuh"

namespace {

constexpr int kRow = 9;                      // floats per face-table row
constexpr int kWarps = 8;                    // slots per block at a time, one per warp
constexpr int kThreads = kWarps * 32;

// Writes slot row `row` of face row `c` in bin (bin_x0, bin_y0): the sum
// over the window's pixels, lane-strided and shuffle-reduced. A of pixel
// (x, y) is a_map[y * image_size + x], read from global memory through the
// read-only cache.
__device__ __forceinline__ void slot_row(const float* __restrict__ c,
                                         const float* __restrict__ a_map,
                                         float* __restrict__ row, int bin_x0, int bin_y0,
                                         int image_size, int tile_h, int tile_w, float sigma,
                                         float blur_radius, int lane) {
  const float ax = c[0], ay = c[1], bx = c[2], by = c[3], cx = c[4], cy = c[5];
  const float area = face_area(ax, ay, bx, by, cx, cy);
  const float denom = guard_area(area);
  const Edge e0 = edge(ax, ay, bx, by), e1 = edge(bx, by, cx, cy), e2 = edge(cx, cy, ax, ay);
  const Window w = cull_window(ax, ay, bx, by, cx, cy, area, bin_x0, bin_y0, tile_w, tile_h,
                               image_size, blur_radius);
  const int ww = max(w.x1 - w.x0 + 1, 0), wh = max(w.y1 - w.y0 + 1, 0);
  const int n_pix = ww * wh;
  const float S_img = (float)image_size;

  float gax = 0.0f, gay = 0.0f, gbx = 0.0f, gby = 0.0f, gcx = 0.0f, gcy = 0.0f;
  for (int i = lane; i < n_pix; i += 32) {
    const int y = bin_y0 + w.y0 + i / ww;
    const int x = bin_x0 + w.x0 + i % ww;
    const float px = pixel_centre((float)x, S_img), py = pixel_centre((float)y, S_img);
    const bool inside = is_inside(barycentric(ax, ay, bx, by, cx, cy, denom, px, py));
    const Seg s0 = segment(ax, ay, e0, px, py);
    const Seg s1 = segment(bx, by, e1, px, py);
    const Seg s2 = segment(cx, cy, e2, px, py);
    const float inner = fminf(s0.d2, s1.d2);
    const float d2 = fminf(inner, s2.d2);
    const float signed_d2 = inside ? -d2 : d2;
    const bool in_radius = inside || (signed_d2 < blur_radius);

    const float v = signed_d2 / sigma;
    float g = 1.0f / (1.0f + expf(v)) / sigma * __ldg(a_map + (long long)y * image_size + x);
    g = in_radius ? (inside ? -g : g) : 0.0f;
    const float s_in = inner < s2.d2 ? 1.0f : (inner == s2.d2 ? 0.5f : 0.0f);
    const float sel0 = s_in * (s0.d2 < s1.d2 ? 1.0f : (s0.d2 == s1.d2 ? 0.5f : 0.0f));
    const float g0 = g * sel0;
    const float g1 = g * (s_in - sel0);
    const float g2 = g * (1.0f - s_in);

    // a = u(seg0), v(seg2); b = v(seg0), u(seg1); c = v(seg1), u(seg2)
    gax += g0 * (s0.dx * (s0.t - 1.0f)) - g2 * (s2.t * s2.dx);
    gay += g0 * (s0.dy * (s0.t - 1.0f)) - g2 * (s2.t * s2.dy);
    gbx += g1 * (s1.dx * (s1.t - 1.0f)) - g0 * (s0.t * s0.dx);
    gby += g1 * (s1.dy * (s1.t - 1.0f)) - g0 * (s0.t * s0.dy);
    gcx += g2 * (s2.dx * (s2.t - 1.0f)) - g1 * (s1.t * s1.dx);
    gcy += g2 * (s2.dy * (s2.t - 1.0f)) - g1 * (s1.t * s1.dy);
  }
  for (int off = 16; off > 0; off >>= 1) {
    gax += __shfl_xor_sync(0xffffffffu, gax, off);
    gay += __shfl_xor_sync(0xffffffffu, gay, off);
    gbx += __shfl_xor_sync(0xffffffffu, gbx, off);
    gby += __shfl_xor_sync(0xffffffffu, gby, off);
    gcx += __shfl_xor_sync(0xffffffffu, gcx, off);
    gcy += __shfl_xor_sync(0xffffffffu, gcy, off);
  }
  if (lane == 0) {
    row[0] = 2.0f * gax;
    row[1] = 2.0f * gay;
    row[2] = 2.0f * gbx;
    row[3] = 2.0f * gby;
    row[4] = 2.0f * gcx;
    row[5] = 2.0f * gcy;
    row[6] = 0.0f;
    row[7] = 0.0f;
    row[8] = 0.0f;
  }
}

__global__ void __launch_bounds__(kThreads)
raster_bwd_kernel(const float* __restrict__ table, const int* __restrict__ counts,
                  const float* __restrict__ dS, float* __restrict__ grad, int n_t, int K,
                  int image_size, int tile_h, int tile_w, float sigma, float blur_radius) {
  const int t = blockIdx.y;
  const int b = blockIdx.z;
  const int k0 = blockIdx.x * kWarps;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long bt = (long long)b * n_t + t;
  const int count = counts[bt];
  float* out = grad + bt * K * kRow;

  if (k0 >= count) {  // the whole group is invalid: zero rows
    const int n = min(kWarps, K - k0) * kRow;
    for (int i = threadIdx.x; i < n; i += kThreads) out[k0 * kRow + i] = 0.0f;
    return;
  }

  const int k = k0 + warp;
  if (k >= K) return;
  float* row = out + k * kRow;
  if (k >= count) {
    if (lane < kRow) row[lane] = 0.0f;
    return;
  }
  const int n_bx = image_size / tile_w;
  slot_row(table + (bt * K + k) * kRow, dS + (long long)b * image_size * image_size, row,
           (t % n_bx) * tile_w, (t / n_bx) * tile_h, image_size, tile_h, tile_w, sigma,
           blur_radius, lane);
}

}  // namespace

// Launches the kernel on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int acfm_raster_bwd(const float* table, const int* counts, const float* dS,
                               float* grad, int B, int n_t, int K, int image_size,
                               int tile_h, int tile_w, float sigma, float blur_radius,
                               void* stream) {
  const dim3 grid((K + kWarps - 1) / kWarps, n_t, B);
  raster_bwd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      table, counts, dS, grad, n_t, K, image_size, tile_h, tile_w, sigma, blur_radius);
  return static_cast<int>(cudaGetLastError());
}
