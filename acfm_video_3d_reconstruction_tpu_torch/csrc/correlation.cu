// Cost volume (correlation) of two feature maps, forward only, f32.
//
// Replaces acfm_video_3d_reconstruction_tpu/flow/correlation_pallas.py
// (`_kernel`, called from `correlation_pallas`): for every pixel (y, x) and
// displacement (dy, dx) in [-md, md]^2,
//   out[b, (dy+md)*(2md+1) + (dx+md), y, x]
//     = (sum_c f1[b, c, y, x] * f2[b, c, y+dy, x+dx]) * (1/C),
// with f2 read as zero outside the image. NCHW in, (B, nd, H, W) out.
//
// What bounds it on an H100: bytes. Per output element the function does C
// fused multiply-adds and reads 2C inputs that it shares with its
// neighbours; at MaskFlownet's shapes (C = 32..196, nd = 25 or 81) the
// inputs and the output, each moved once, take longer at 3.35 TB/s than
// the 2*B*H*W*C*nd operations at 67 TFLOP/s.
//
// Design (simple and right first): one block per (b, y, 32-pixel strip of
// the row). Thread (tx, ty) owns pixel x = x0 + tx and displacement row
// dy = ty - md, and keeps the 2md+1 sums of that row (dx = -md..md) in
// registers. The channels are walked in chunks of CC: each chunk stages
// f1's strip (CC x 32) and f2's 2md+1 rows around y, widened by md pixels
// on each side (CC x (2md+1) x (32+2md)), in shared memory, zero where the
// row or column falls outside the image (bounds checked on load; no padded
// copy of f2 is made). Every f1 value a thread reads feeds 2md+1 FMAs.
// Each output has one writer and sums its channels in ascending order, so
// the result is deterministic and needs no atomics. Loads and stores are
// coalesced along x. What limits this design instead of the bytes: about
// 1.1 shared-memory reads per FMA and, at the coarse levels, a serial walk
// over the channel chunks in too few blocks to fill the card (a 6x12 map
// is 72 blocks); see PERF.md for its times against the bound.
#include <cuda_runtime.h>

namespace {

constexpr int TX = 32;  // pixels of a row per block (one warp wide)
constexpr int CC = 16;  // channels staged per chunk

template <int MD>
__global__ void correlation_kernel(const float* __restrict__ f1,
                                   const float* __restrict__ f2,
                                   float* __restrict__ out,
                                   int C, int H, int W, float inv_c) {
  constexpr int SIDE = 2 * MD + 1;
  constexpr int SW = TX + 2 * MD;  // staged f2 row width
  __shared__ float s1[CC][TX];
  __shared__ float s2[SIDE][CC][SW];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;  // dy + MD
  const int tid = ty * TX + tx;
  const int nthreads = TX * SIDE;
  const int x0 = blockIdx.x * TX;
  const int y = blockIdx.y;
  const long long b = blockIdx.z;
  const long long plane = (long long)H * W;
  const float* f1b = f1 + b * C * plane;
  const float* f2b = f2 + b * C * plane;

  float acc[SIDE];
#pragma unroll
  for (int i = 0; i < SIDE; ++i) acc[i] = 0.0f;

  for (int c0 = 0; c0 < C; c0 += CC) {
    const int cn = min(CC, C - c0);
    __syncthreads();  // the previous chunk is consumed
    for (int i = tid; i < CC * TX; i += nthreads) {
      const int c = i / TX, j = i % TX;
      const int x = x0 + j;
      s1[c][j] = (c < cn && x < W) ? f1b[(c0 + c) * plane + (long long)y * W + x] : 0.0f;
    }
    for (int i = tid; i < SIDE * CC * SW; i += nthreads) {
      const int r = i / (CC * SW);
      const int c = (i / SW) % CC;
      const int j = i % SW;
      const int yy = y + r - MD;
      const int xx = x0 + j - MD;
      const bool in = c < cn && yy >= 0 && yy < H && xx >= 0 && xx < W;
      s2[r][c][j] = in ? f2b[(c0 + c) * plane + (long long)yy * W + xx] : 0.0f;
    }
    __syncthreads();
    for (int c = 0; c < cn; ++c) {
      const float a = s1[c][tx];
#pragma unroll
      for (int dx = 0; dx < SIDE; ++dx) acc[dx] = __fmaf_rn(a, s2[ty][c][tx + dx], acc[dx]);
    }
  }

  const int x = x0 + tx;
  if (x < W) {
    float* o = out + (b * SIDE * SIDE + (long long)ty * SIDE) * plane + (long long)y * W + x;
#pragma unroll
    for (int dx = 0; dx < SIDE; ++dx) o[dx * plane] = acc[dx] * inv_c;
  }
}

template <int MD>
cudaError_t launch(const float* f1, const float* f2, float* out, int B, int C, int H,
                   int W, float inv_c, cudaStream_t stream) {
  const dim3 block(TX, 2 * MD + 1);
  const dim3 grid((W + TX - 1) / TX, H, B);
  correlation_kernel<MD><<<grid, block, 0, stream>>>(f1, f2, out, C, H, W, inv_c);
  return cudaGetLastError();
}

}  // namespace

// f1, f2: (B, C, H, W) f32 contiguous; out: (B, (2md+1)^2, H, W) f32.
// md 4 or 2 (MaskFlownet's two stages). Returns the launch's CUDA error
// code (0 = launched).
extern "C" int acfm_correlation(const float* f1, const float* f2, float* out, int B, int C,
                                int H, int W, int md, float inv_c, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (md) {
    case 2: return launch<2>(f1, f2, out, B, C, H, W, inv_c, s);
    case 4: return launch<4>(f1, f2, out, B, C, H, W, inv_c, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
