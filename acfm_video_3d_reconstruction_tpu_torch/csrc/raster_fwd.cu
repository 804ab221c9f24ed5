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
// Per (view, face), once: the area and its zero guard 10 and, in soft
// mode, each edge's ex, ey, |e|^2 and clamp 18. This kernel recomputes
// those per pair (28 soft / 10 hard extra operations): staging them with
// the face rows is the first lever. The bytes are small: the face table is
// read once per block into shared memory (<= 128 slots x 40 B at a time)
// and each pixel writes 20 B. The design keeps all per-pixel state in
// registers, reads face rows from shared memory as warp-wide broadcasts,
// and never touches a slot past the bin's count, so the work is the
// data's sum over bins of count x pixels and not K x pixels.
//
// Numerics follow _face_geometry operation for operation; the shared
// geometry (barycentrics, point-segment distances) and its fused multiply-
// adds are in raster_geometry.cuh. z is fma(b2, zc, fma(b0, za, b1*zb)), as
// XLA's CPU backend contracts a*b + c*d + e*f. log_sigmoid is the stable
// min(x, 0) - log1p(exp(-|x|)) with IEEE expf/log1pf.

#include <cuda_runtime.h>

#include "raster_geometry.cuh"

namespace {

constexpr int kRow = 9;          // floats per face-table row
constexpr int kSlotChunk = 128;  // slots staged in shared memory at a time
constexpr int kThreads = 256;    // pixels per block, one per thread
constexpr float kBig = 1e10f;    // empty z-buffer value (rasterizer.py _BIG)

template <bool SOFT>
__global__ void __launch_bounds__(kThreads)
raster_fwd_kernel(const float* __restrict__ table, const int* __restrict__ idx,
                  const int* __restrict__ counts, float* __restrict__ s_out,
                  int* __restrict__ p2f_out, float* __restrict__ b0_out,
                  float* __restrict__ b1_out, float* __restrict__ z_out, int n_t,
                  int K, int image_size, int tile_h, int tile_w, float sigma,
                  float blur_radius) {
  __shared__ float s_tab[kSlotChunk * kRow];
  __shared__ int s_idx[kSlotChunk];

  const int P = tile_h * tile_w;
  const int blocks_per_bin = (P + kThreads - 1) / kThreads;
  const int t = blockIdx.x / blocks_per_bin;
  const int pix = (blockIdx.x % blocks_per_bin) * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  const bool active = pix < P;

  const int n_bx = image_size / tile_w;
  const int y = (t / n_bx) * tile_h + pix / tile_w;
  const int x = (t % n_bx) * tile_w + pix % tile_w;
  const float px = (2.0f * (float)x + 1.0f) / (float)image_size - 1.0f;
  const float py = (2.0f * (float)y + 1.0f) / (float)image_size - 1.0f;

  const long long bt = (long long)b * n_t + t;
  const int count = counts[bt];
  const float* tab = table + bt * K * kRow;
  const int* bidx = idx + bt * K;

  float S = 0.0f, bb0 = 0.0f, bb1 = 0.0f, zbuf = kBig;
  int face = -1;

  for (int k0 = 0; k0 < count; k0 += kSlotChunk) {
    const int n = min(kSlotChunk, count - k0);
    __syncthreads();
    for (int i = threadIdx.x; i < n * kRow; i += kThreads) s_tab[i] = tab[k0 * kRow + i];
    for (int i = threadIdx.x; i < n; i += kThreads) s_idx[i] = bidx[k0 + i];
    __syncthreads();
    if (!active) continue;
    for (int k = 0; k < n; ++k) {
      const float* c = s_tab + k * kRow;
      const float ax = c[0], ay = c[1], bx = c[2], by = c[3], cx = c[4], cy = c[5];
      const float za = c[6], zb = c[7], zc = c[8];

      const Bary bc = barycentric(ax, ay, bx, by, cx, cy, px, py);
      const bool inside = is_inside(bc);

      float b0c = clip01(bc.b0), b1c = clip01(bc.b1), b2c = clip01(bc.b2);
      const float s = fmaxf(b0c + b1c + b2c, 1e-12f);
      b0c = b0c / s;
      b1c = b1c / s;
      b2c = b2c / s;
      const float z = __fmaf_rn(b2c, zc, __fmaf_rn(b0c, za, b1c * zb));

      bool in_radius;
      if (SOFT) {
        const float d2 = fminf(fminf(segment(ax, ay, bx, by, px, py).d2,
                                     segment(bx, by, cx, cy, px, py).d2),
                               segment(cx, cy, ax, ay, px, py).d2);
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
      if (in_radius && z < zbuf) {
        zbuf = z;
        bb0 = b0c;
        bb1 = b1c;
        face = s_idx[k];
      }
    }
  }
  if (!active) return;
  const long long o = ((long long)b * image_size + y) * image_size + x;
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
  const int P = tile_h * tile_w;
  const dim3 grid(n_t * ((P + kThreads - 1) / kThreads), B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (soft) {
    raster_fwd_kernel<true><<<grid, kThreads, 0, s>>>(
        table, idx, counts, s_out, p2f_out, b0_out, b1_out, z_out, n_t, K,
        image_size, tile_h, tile_w, sigma, blur_radius);
  } else {
    raster_fwd_kernel<false><<<grid, kThreads, 0, s>>>(
        table, idx, counts, s_out, p2f_out, b0_out, b1_out, z_out, n_t, K,
        image_size, tile_h, tile_w, sigma, blur_radius);
  }
  return static_cast<int>(cudaGetLastError());
}
