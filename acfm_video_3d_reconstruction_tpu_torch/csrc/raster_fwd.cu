// Binned mesh rasterizer, forward pass, soft and hard modes (sm_90a).
//
// Replaces acfm_video_3d_reconstruction_tpu/ops/rasterizer_tpu.py::_fwd_kernel
// (with _face_geometry), the Pallas TPU kernel launched by _run_fwd.
//
// Input is the bin pass of ops/rasterizer_cuda.py: for each (view b, bin t)
// a compacted list of the faces whose bounding box (plus the blur margin)
// overlaps the bin, in ascending face order, `count` of them valid:
//   table  (B, T, K, 9) float32 rows [ax ay bx by cx cy za zb zc]
//   idx    (B, T, K)    int32 global face id of each slot
//   counts (B, T)       int32 valid slots
// Per pixel the kernel walks the bin's slots 0..count-1 in order, as the
// TPU kernel's fori_loop does, and keeps in registers
//   S    = sum over in-radius faces of log_sigmoid(signed d^2 / sigma)
//          (soft; hard mode adds -16 per covering face),
//   the argmin-z in-radius face (strict <, so the first slot wins ties),
//   its clipped, renormalised barycentrics b0, b1 and its depth z.
// Outputs are written untiled, (B, H, W): S, pix_to_face (through idx),
// b0, b1, zbuf.
//
// Design. A warp owns a patch of 4x8 pixels of one bin (lane (r, c) =
// (lane / 8, lane % 8) takes pixel (r, c) of it); a block holds kWarps
// patches of one bin. Patches of 8x8 and 16x8 (2 or 4 pixels a thread) were
// timed and were slower: the smaller patch culls more pairs than the larger
// ones save in per-slot work (PERF.md). The block stages the bin's slots
// kChunk at a time: one thread per slot loads the face row and computes its per-face terms once (the area's
// guarded denominator, each edge's ex, ey and clamped |e|^2, with
// raster_geometry.cuh's expressions, so the bits equal the per-pair ones)
// and its cull window (cull_window), into a record of whole float4s that
// the warps read as 16-byte broadcasts. Each warp then tests 32 slots at a
// time against its patch, one per lane, and walks the ballot's set bits in
// slot order: a slot whose window misses the patch is skipped by the whole
// warp at once (no divergence), and every skipped pair has in_radius ==
// False (the exactness argument is in raster_geometry.cuh), so the outputs
// equal the unculled walk's bit for bit. Per pair, every divide is still
// an IEEE divide by the same operands and expf / log1pf stay.
//
// Bound: fp32 ALU work. The operations the function needs (an FMA counts
// two) per (pixel, valid slot) pair:
//   both modes, 40: six pixel-relative differences 6, three sub-areas 9,
//     three divides by the area 3, the inside test 5, clipping 6, the sum
//     and its clamp 3, three renormalising divides 3, z 5;
//   hard, 47: + the S update 1, the depth test 2, four selects 4;
//   soft, 99: + three point-segment distances 39 (w = p - u is the
//     negation of a pixel-relative difference already formed; the dot 3,
//     a divide 1, the clip 2, two FMAs 4, the squared length 3, each),
//     the min of three 2, the signed select 2, the radius test 2, v 1,
//     log_sigmoid with one exp and one log1p 6, the S update 1, the depth
//     test 2, four selects 4.
// Of these, a pair out of radius needs only its tests: the differences,
// sub-areas, divides and inside test, 23, and in soft mode the distances,
// the min, the signed select and the radius test, 68. Per (view, face),
// once: the area and its zero guard 10 and, in soft mode, each edge's ex,
// ey, |e|^2 and clamp 18. The pairs these inputs need are those inside
// the cull windows (ops/rasterizer_cuda.py::cull_pair_counts "needed", ~6%
// of the bins' pairs at 256^2 soft, ~3% hard), at full cost where in
// radius and at the tests' cost elsewhere; the kernel evaluates whole
// patches that meet a window ("patch", ~10% soft, ~6% hard at 4x8). Bytes
// are small: the face table is read once per block and each pixel writes
// 20 B.
//
// Numerics follow _face_geometry operation for operation; the shared
// geometry and its fused multiply-adds are in raster_geometry.cuh. z is
// fma(b2, zc, fma(b0, za, b1*zb)), as XLA's CPU backend contracts
// a*b + c*d + e*f. log_sigmoid is the stable min(x, 0) - log1p(exp(-|x|))
// with IEEE expf/log1pf.

#include <cuda_runtime.h>

#include "raster_geometry.cuh"

namespace {

constexpr int kRow = 9;          // floats per face-table row
constexpr int kWarps = 8;        // patches per block, one per warp
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = kThreads; // slots staged at a time, one per thread
constexpr int kPH = 4;           // patch rows (8 columns)
constexpr float kBig = 1e10f;    // empty z-buffer value (rasterizer.py _BIG)

// float4s per staged face record:
//   r0 (ax, ay, bx, by), r1 (cx, cy, za, zb), r2 (zc, denom, face id bits, e0.ex),
//   soft only: r3 (e0.ey, e0.ee, e1.ex, e1.ey), r4 (e1.ee, e2.ex, e2.ey, e2.ee)
template <bool SOFT>
constexpr int kRecord = SOFT ? 5 : 3;

template <bool SOFT>
__global__ void __launch_bounds__(kThreads)
raster_fwd_kernel(const float* __restrict__ table, const int* __restrict__ idx,
                  const int* __restrict__ counts, float* __restrict__ s_out,
                  int* __restrict__ p2f_out, float* __restrict__ b0_out,
                  float* __restrict__ b1_out, float* __restrict__ z_out, int n_t,
                  int K, int image_size, int tile_h, int tile_w, float sigma,
                  float blur_radius) {
  constexpr int R = kRecord<SOFT>;
  __shared__ float4 s_rec[kChunk * R];
  __shared__ int4 s_win[kChunk];

  const int n_px = (tile_w + 7) / 8;
  const int n_patches = ((tile_h + kPH - 1) / kPH) * n_px;
  const int blocks_per_bin = (n_patches + kWarps - 1) / kWarps;
  const int t = blockIdx.x / blocks_per_bin;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int patch = (blockIdx.x % blocks_per_bin) * kWarps + warp;
  const bool warp_active = patch < n_patches;  // warp-uniform

  const int n_bx = image_size / tile_w;
  const int bin_x0 = (t % n_bx) * tile_w, bin_y0 = (t / n_bx) * tile_h;
  // the patch, bin-local and clipped to the bin
  const int pr0 = (patch / n_px) * kPH, pc0 = (patch % n_px) * 8;
  const int pr1 = min(pr0 + kPH, tile_h) - 1, pc1 = min(pc0 + 8, tile_w) - 1;
  const float S_img = (float)image_size;
  const int lx = pc0 + lane % 8, ly = pr0 + lane / 8;
  const float px = pixel_centre((float)(bin_x0 + lx), S_img);
  const float py = pixel_centre((float)(bin_y0 + ly), S_img);

  const long long bt = (long long)b * n_t + t;
  const int count = counts[bt];
  const float* tab = table + bt * K * kRow;
  const int* bidx = idx + bt * K;
  const float blur = SOFT ? blur_radius : 0.0f;

  float S = 0.0f, bb0 = 0.0f, bb1 = 0.0f, zbuf = kBig;
  int face = -1;

  for (int k0 = 0; k0 < count; k0 += kChunk) {
    const int n = min(kChunk, count - k0);
    __syncthreads();
    if (threadIdx.x < n) {
      const int i = threadIdx.x;
      const float* c = tab + (k0 + i) * kRow;
      const float ax = c[0], ay = c[1], bx = c[2], by = c[3], cx = c[4], cy = c[5];
      const float area = face_area(ax, ay, bx, by, cx, cy);
      const Edge e0 = edge(ax, ay, bx, by);
      s_rec[i * R + 0] = make_float4(ax, ay, bx, by);
      s_rec[i * R + 1] = make_float4(cx, cy, c[6], c[7]);
      s_rec[i * R + 2] = make_float4(c[8], guard_area(area), __int_as_float(bidx[k0 + i]), e0.ex);
      if constexpr (SOFT) {
        const Edge e1 = edge(bx, by, cx, cy), e2 = edge(cx, cy, ax, ay);
        s_rec[i * R + 3] = make_float4(e0.ey, e0.ee, e1.ex, e1.ey);
        s_rec[i * R + 4] = make_float4(e1.ee, e2.ex, e2.ey, e2.ee);
      }
      const Window w = cull_window(ax, ay, bx, by, cx, cy, area, bin_x0, bin_y0, tile_w,
                                   tile_h, image_size, blur);
      s_win[i] = make_int4(w.x0, w.x1, w.y0, w.y1);
    }
    __syncthreads();
    if (!warp_active) continue;
    for (int g0 = 0; g0 < n; g0 += 32) {
      bool hit = false;
      if (g0 + lane < n) {
        const int4 w = s_win[g0 + lane];
        hit = max(w.x, pc0) <= min(w.y, pc1) && max(w.z, pr0) <= min(w.w, pr1);
      }
      unsigned mask = __ballot_sync(0xffffffffu, hit);
      while (mask) {
        const int k = g0 + __ffs(mask) - 1;
        mask &= mask - 1;
        const float4* rec = s_rec + k * R;
        const float4 r0 = rec[0], r1 = rec[1], r2 = rec[2];
        const float ax = r0.x, ay = r0.y, bx = r0.z, by = r0.w;
        const float cx = r1.x, cy = r1.y, za = r1.z, zb = r1.w;
        const float zc = r2.x, denom = r2.y;
        Edge e0{}, e1{}, e2{};
        if constexpr (SOFT) {
          const float4 r3 = rec[3], r4 = rec[4];
          e0 = {r2.w, r3.x, r3.y};
          e1 = {r3.z, r3.w, r4.x};
          e2 = {r4.y, r4.z, r4.w};
        }
        const Bary bc = barycentric(ax, ay, bx, by, cx, cy, denom, px, py);
        const bool inside = is_inside(bc);
        bool in_radius;
        if constexpr (SOFT) {
          const float d2 = fminf(fminf(segment(ax, ay, e0, px, py).d2,
                                       segment(bx, by, e1, px, py).d2),
                                 segment(cx, cy, e2, px, py).d2);
          const float signed_d2 = inside ? -d2 : d2;
          in_radius = inside || (signed_d2 < blur_radius);
          if (in_radius) {
            const float v = signed_d2 / sigma;
            S += fminf(v, 0.0f) - log1pf(expf(-fabsf(v)));
          }
        } else {
          in_radius = inside;
          if (inside) S += -16.0f;
        }
        if (in_radius) {
          float b0c = clip01(bc.b0), b1c = clip01(bc.b1), b2c = clip01(bc.b2);
          const float s = fmaxf(b0c + b1c + b2c, 1e-12f);
          b0c = b0c / s;
          b1c = b1c / s;
          b2c = b2c / s;
          const float z = __fmaf_rn(b2c, zc, __fmaf_rn(b0c, za, b1c * zb));
          if (z < zbuf) {
            zbuf = z;
            bb0 = b0c;
            bb1 = b1c;
            face = __float_as_int(r2.z);
          }
        }
      }
    }
  }
  if (!warp_active || lx >= tile_w || ly >= tile_h) return;
  const long long o = ((long long)b * image_size + bin_y0 + ly) * image_size + bin_x0 + lx;
  s_out[o] = S;
  p2f_out[o] = face;
  b0_out[o] = bb0;
  b1_out[o] = bb1;
  z_out[o] = zbuf;
}

}  // namespace

// Launches the kernel on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int acfm_raster_fwd(const float* table, const int* idx, const int* counts,
                               float* s_out, int* p2f_out, float* b0_out,
                               float* b1_out, float* z_out, int B, int n_t, int K,
                               int image_size, int tile_h, int tile_w, float sigma,
                               float blur_radius, int soft, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_patches = ((tile_h + kPH - 1) / kPH) * ((tile_w + 7) / 8);
  const dim3 grid(n_t * ((n_patches + kWarps - 1) / kWarps), B);
  if (soft) {
    raster_fwd_kernel<true><<<grid, kThreads, 0, s>>>(
        table, idx, counts, s_out, p2f_out, b0_out, b1_out, z_out, n_t, K, image_size, tile_h,
        tile_w, sigma, blur_radius);
  } else {
    raster_fwd_kernel<false><<<grid, kThreads, 0, s>>>(
        table, idx, counts, s_out, p2f_out, b0_out, b1_out, z_out, n_t, K, image_size, tile_h,
        tile_w, sigma, blur_radius);
  }
  return static_cast<int>(cudaGetLastError());
}
