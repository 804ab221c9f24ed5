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
// the 2*B*H*W*C*nd operations at 67 TFLOP/s (at the finest level, md=4,
// the operations take 45% of the bytes' time, so the FMAs must also run
// near their rate).
//
// Both templates give a thread P = 4 consecutive pixels of one row and one
// displacement row dy, and keep their 4 x (2md+1) sums in registers: per
// channel the thread reads f1's 4 values and f2's 12 values from column
// x - 4 of row y + dy (as float4s: the window starts on a multiple of 4 for
// md 4 and 2 alike), then slides the window in registers, 16 words read
// for 4 x (2md+1) FMAs (36 at md 4) where the first design read one word
// per FMA. They differ in where the words come from; the shape picks one
// and its numbers (flow/correlation_cuda.py::launch_plan, checked again by
// acfm_correlation below), each instantiated for md 4 and 2:
//
// corr_tile_kernel (fine levels, where its grid holds at least 1.5 blocks
// per SM: at 224 blocks and more it beat the split kernel, at 144 and fewer
// it lost, at every shape of the flow paths' passes). A block
// owns TY = 4 output rows of a 32-pixel strip and every dy. It stages the
// channels CC = 8 at a time in shared memory: f1's TY rows of the strip and
// f2's TY + 2md rows around them, widened by 4 pixels on each side, zero
// outside the image. Staging TY rows at once cuts the reads of each f2 row
// from 2md+1 blocks to (TY + 2md) / TY (9 -> 3 at md 4). A thread loads its
// units of the next chunk into registers before it sums the current one
// and stores them after, so the loads are in flight during the FMAs (plain
// loads; no asynchronous copy). __launch_bounds__ keeps 2 blocks (md 4) or
// 4 (md 2) on an SM.
//
// corr_split_kernel (coarse levels: 6x12 to 24x48 maps of 96-196 channels,
// where a row-strip grid holds 72-576 blocks that walk 6-13 channel chunks
// one after another). A block owns 32 four-pixel groups of the flattened
// (b, y, x/4) range, so the rows of a narrow map share a warp's lanes, and
// DY of the 2md+1 displacement rows; its warps are CS channel groups,
// group k summing channels [k*chunk, (k+1)*chunk) in ascending order
// straight from L1/L2 (the maps are small). The groups' partial sums meet
// in shared memory and are added in a fixed order (group 0 + group 1 +
// ...): no second launch, no scratch in device memory, no atomic. The
// kernel is latency-bound, so it is held to 64 registers (2 blocks of 512
// threads on an SM).
//
// Both: each output has one writer, the summation order is fixed (the
// result is the same bits from run to run), the sum is scaled by 1/C after
// it; loads and stores are float4 where W % 4 == 0 and the pointers are
// 16-byte aligned, scalar otherwise.
//
// Measured (tools/torch_kernel_compare.py, NVIDIA H100 80GB HBM3 at
// 700 W, 12 pairs of a 384x768 input; ms per launch, device time): level 2
// md 4 / md 2 0.081 / 0.044 (the first design 0.246 / 0.118), one pass of
// 15 launches 0.353 ms (1.13). At one pair of 448x1024, level 2 md 4 / md 2
// 0.0125 / 0.0084 tiled, 0.0192 / 0.0097 split (the first design 0.0356 /
// 0.0191). Variants timed in turns with this design and
// dropped (this design's time in brackets): 16 channels a chunk, level 2
// md 4 0.145 (0.086); TY = 8, 0.099 (0.086), level 3 0.100 (0.054); no
// register prefetch 0.086 (0.081), level 3 0.046 (0.041); the tile kernel
// without a register cap 0.102 (0.081); its staging indices recomputed per
// chunk instead of kept, 0.101 (0.081); two shared buffers and one barrier
// a chunk, 0.100 (0.081) (both spill more); the split kernel at up to 98
// registers, level 4 md 4 0.029 (0.022), level 5 0.014 (0.010); split
// chunks of about 24 channels with DY up to 3, level 4 md 4 0.032 (0.029);
// of about 8, level 4 md 4 0.026 (0.022). PERF.md has every shape.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int P = 4;              // pixels of a row per thread
constexpr int GX = 8;             // tile: threads along a row
constexpr int XS = P * GX;        // tile: strip width (32 pixels)
constexpr int SW = XS + 8;        // tile: staged f2 row width (4 more on each side)
constexpr int Q = SW / 4;         // tile: float4s per staged f2 row
constexpr int CC = 8;             // tile: channels staged per chunk
constexpr int NG = 32;            // split: four-pixel groups per block (a warp's lanes)
constexpr int SPLIT_MAX_THREADS = 512;
constexpr int MAX_SMEM = 232448;

template <int MD>
struct Tile {
  static constexpr int SIDE = 2 * MD + 1;
  static constexpr int TY = 4;                         // output rows per block
  static constexpr int NT = GX * SIDE * TY;            // threads
  static constexpr int NR = TY + 2 * MD;               // staged f2 rows
  static constexpr int U2 = CC * NR * Q;               // f2 float4s per chunk
  static constexpr int U1 = CC * TY * GX;              // f1 float4s per chunk
  static constexpr int UPT = (U2 + U1 + NT - 1) / NT;  // float4s a thread stages per chunk
  static constexpr int SMEM = (U2 + U1) * 16;          // dynamic shared bytes
  static constexpr int MIN_BLOCKS = MD == 4 ? 2 : 4;   // per SM, for __launch_bounds__
};

// Four consecutive floats of a row from column xx, each zero outside
// [0, W) and all zero unless `in`; one float4 load when `vec` (then xx and
// W are multiples of 4 and the row is 16-byte aligned).
__device__ __forceinline__ float4 load4(const float* __restrict__ p, bool in, int xx, int W,
                                        int vec) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (!in) return v;
  if (vec) {
    if (xx >= 0 && xx < W) v = __ldg(reinterpret_cast<const float4*>(p));
  } else {
    if (xx >= 0 && xx < W) v.x = __ldg(p);
    if (xx + 1 >= 0 && xx + 1 < W) v.y = __ldg(p + 1);
    if (xx + 2 >= 0 && xx + 2 < W) v.z = __ldg(p + 2);
    if (xx + 3 >= 0 && xx + 3 < W) v.w = __ldg(p + 3);
  }
  return v;
}

// acc[i][j] += a[i] * f2[x + i + j - MD] for the 12-wide window w0 w1 w2
// that starts at x - 4.
template <int MD>
__device__ __forceinline__ void slide(float (&acc)[P][2 * MD + 1], float4 av, float4 w0,
                                      float4 w1, float4 w2) {
  const float a[P] = {av.x, av.y, av.z, av.w};
  const float w[12] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w, w2.x, w2.y, w2.z, w2.w};
#pragma unroll
  for (int i = 0; i < P; ++i)
#pragma unroll
    for (int j = 0; j < 2 * MD + 1; ++j) acc[i][j] = __fmaf_rn(a[i], w[4 - MD + i + j], acc[i][j]);
}

// Writes the 4 pixels from column x of output row o (one displacement).
__device__ __forceinline__ void store4(float* o, float4 v, int x, int W, int vec) {
  if (vec && x + 3 < W) {
    *reinterpret_cast<float4*>(o) = v;
  } else {
    if (x < W) o[0] = v.x;
    if (x + 1 < W) o[1] = v.y;
    if (x + 2 < W) o[2] = v.z;
    if (x + 3 < W) o[3] = v.w;
  }
}

template <int MD>
__global__ void __launch_bounds__(Tile<MD>::NT, Tile<MD>::MIN_BLOCKS)
corr_tile_kernel(const float* __restrict__ f1, const float* __restrict__ f2,
                 float* __restrict__ out, int C, int H, int W, float inv_c, int vec) {
  using T = Tile<MD>;
  constexpr int SIDE = T::SIDE, TY = T::TY, NR = T::NR;
  extern __shared__ float4 smem4[];
  const float4* s2 = smem4;          // [CC][NR][Q]: f2 rows y0 - md .. y0 + TY - 1 + md
  const float4* s1 = smem4 + T::U2;  // [CC][TY][GX]: f1 rows y0 .. y0 + TY - 1

  const int t = threadIdx.x;
  const int g = t % GX;
  const int dyi = (t / GX) % SIDE;
  const int ty = t / (GX * SIDE);
  const int x0 = blockIdx.x * XS;
  const int y0 = blockIdx.y * TY;
  const int plane = H * W;  // C * H * W < 2^31: offsets within a pair are ints
  const long long b = blockIdx.z;
  const float* f1b = f1 + b * C * plane;
  const float* f2b = f2 + b * C * plane;

  float acc[P][SIDE];
#pragma unroll
  for (int i = 0; i < P; ++i)
#pragma unroll
    for (int j = 0; j < SIDE; ++j) acc[i][j] = 0.0f;

  // Thread t stages units t, t + NT, ... of each chunk (f2's, then f1's):
  // their channels within the chunk, their offsets from the chunk's first
  // plane and their columns are the same for every chunk.
  int ch[T::UPT], off[T::UPT], col[T::UPT];
  unsigned row_in = 0, from_f1 = 0;
#pragma unroll
  for (int u = 0; u < T::UPT; ++u) {
    const int i = t + u * T::NT;
    int yy;
    if (i < T::U2) {
      ch[u] = i / (NR * Q);
      yy = y0 - MD + i / Q % NR;
      col[u] = x0 - 4 + 4 * (i % Q);
    } else {
      const int j = i - T::U2;
      ch[u] = i < T::U2 + T::U1 ? j / (TY * GX) : CC;  // CC: no unit
      yy = y0 + j / GX % TY;
      col[u] = x0 + 4 * (j % GX);
      from_f1 |= 1u << u;
    }
    off[u] = ch[u] * plane + yy * W + col[u];
    if (yy >= 0 && yy < H) row_in |= 1u << u;
  }

  // A chunk's loads are issued before the previous chunk's sums and stored
  // after them, so they are in flight while the thread computes.
  float4 v[T::UPT];
  auto fetch = [&](int c0) {
    const int left = min(C - c0, CC);  // channels of this chunk
#pragma unroll
    for (int u = 0; u < T::UPT; ++u)
      v[u] = load4(((from_f1 >> u) & 1 ? f1b : f2b) + c0 * plane + off[u],
                   ((row_in >> u) & 1) && ch[u] < left, col[u], W, vec);
  };
  fetch(0);
  for (int c0 = 0; c0 < C; c0 += CC) {
    __syncthreads();  // the previous chunk is consumed
#pragma unroll
    for (int u = 0; u < T::UPT; ++u)
      if (ch[u] < CC) smem4[t + u * T::NT] = v[u];
    __syncthreads();
    if (c0 + CC < C) fetch(c0 + CC);

    const float4* a4 = s1 + ty * GX + g;
    const float4* w4 = s2 + (ty + dyi) * Q + g;
#pragma unroll 2
    for (int c = 0; c < CC; ++c) {
      const float4* w = w4 + c * NR * Q;
      slide<MD>(acc, a4[c * TY * GX], w[0], w[1], w[2]);
    }
  }

  const int y = y0 + ty;
  const int x = x0 + 4 * g;
  if (y >= H || x >= W) return;
  float* o = out + (b * SIDE * SIDE + dyi * SIDE) * plane + y * W + x;
#pragma unroll
  for (int j = 0; j < SIDE; ++j)
    store4(o + j * plane,
           make_float4(acc[0][j] * inv_c, acc[1][j] * inv_c, acc[2][j] * inv_c, acc[3][j] * inv_c),
           x, W, vec);
}

template <int MD>
__global__ void __launch_bounds__(SPLIT_MAX_THREADS, 2)
corr_split_kernel(const float* __restrict__ f1, const float* __restrict__ f2,
                                  float* __restrict__ out, int B, int C, int H, int W, int DY,
                                  int chunk, float inv_c, int vec) {
  constexpr int SIDE = 2 * MD + 1;
  extern __shared__ float4 smem4[];  // partial sums [CS][DY][SIDE][NG]

  const int t = threadIdx.x;
  const int cs_n = blockDim.x / (NG * DY);  // CS
  const int lane = t % NG;
  const int dyl = (t / NG) % DY;
  const int cs = t / (NG * DY);
  const int gw = (W + P - 1) / P;  // groups per row
  const int ng = B * H * gw;
  const int n = blockIdx.x * NG + lane;  // flattened (b, y, x / 4)
  const int dyi = blockIdx.y * DY + dyl;
  const bool valid = n < ng && dyi < SIDE;
  const int b = valid ? n / (H * gw) : 0;
  const int y = valid ? n / gw % H : 0;
  const int x = valid ? P * (n % gw) : 0;
  const int yy = y + dyi - MD;
  const int cb = cs * chunk;
  const int ce = min(C, cb + chunk);

  float acc[P][SIDE];
#pragma unroll
  for (int i = 0; i < P; ++i)
#pragma unroll
    for (int j = 0; j < SIDE; ++j) acc[i][j] = 0.0f;
  if (valid && yy >= 0 && yy < H) {
    const long long plane = (long long)H * W;
    const float* p1 = f1 + ((long long)b * C + cb) * plane + (long long)y * W + x;
    const float* p2 = f2 + ((long long)b * C + cb) * plane + (long long)yy * W + x - 4;
#pragma unroll 1
    for (int c = cb; c < ce; ++c, p1 += plane, p2 += plane)
      slide<MD>(acc, load4(p1, true, x, W, vec), load4(p2, true, x - 4, W, vec),
                load4(p2 + 4, true, x, W, vec), load4(p2 + 8, true, x + 4, W, vec));
  }

  const int per_group = DY * SIDE * NG;
#pragma unroll
  for (int j = 0; j < SIDE; ++j)
    smem4[cs * per_group + (dyl * SIDE + j) * NG + lane] =
        make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
  __syncthreads();
  const long long plane = (long long)H * W;
  for (int e = t; e < per_group; e += blockDim.x) {
    const int m = blockIdx.x * NG + e % NG;
    const int j = e / NG % SIDE;
    const int di = blockIdx.y * DY + e / (NG * SIDE);
    if (m >= ng || di >= SIDE) continue;
    float4 s = smem4[e];
    for (int k = 1; k < cs_n; ++k) {
      const float4 p = smem4[k * per_group + e];
      s.x += p.x;
      s.y += p.y;
      s.z += p.z;
      s.w += p.w;
    }
    const int mb = m / (H * gw), my = m / gw % H, mx = P * (m % gw);
    store4(out + ((long long)mb * SIDE * SIDE + di * SIDE + j) * plane + (long long)my * W + mx,
           make_float4(s.x * inv_c, s.y * inv_c, s.z * inv_c, s.w * inv_c), mx, W, vec);
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <int MD>
int launch(const float* f1, const float* f2, float* out, int B, int C, int H, int W,
           float inv_c, int kernel, int p, int ty, int dy, int cs, int chunk, int gx, int gy,
           int gz, int block, int smem, cudaStream_t stream) {
  constexpr int SIDE = 2 * MD + 1;
  if (p != P || block < 1 || smem < 0 || smem > MAX_SMEM ||
      (long long)B * H * W >= (1ll << 31) || (long long)C * H * W >= (1ll << 31) ||
      (long long)SIDE * SIDE * H * W >= (1ll << 31))
    return cudaErrorInvalidValue;
  const int vec = W % 4 == 0 && reinterpret_cast<uintptr_t>(f1) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(f2) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(out) % 16 == 0;
  cudaError_t e;
  if (kernel == 0) {  // tile
    using T = Tile<MD>;
    if (ty != T::TY || dy != SIDE || cs != 1 || chunk != CC || block != T::NT ||
        gx != (W + XS - 1) / XS || gy != (H + T::TY - 1) / T::TY || gz != B || smem != T::SMEM)
      return cudaErrorInvalidValue;
    if ((e = allow_smem(corr_tile_kernel<MD>, smem)) != cudaSuccess) return e;
    corr_tile_kernel<MD><<<dim3(gx, gy, gz), block, smem, stream>>>(f1, f2, out, C, H, W, inv_c,
                                                                   vec);
  } else if (kernel == 1) {  // split
    const long long groups = (long long)B * H * ((W + P - 1) / P);
    if (ty != 1 || dy < 1 || dy > SIDE || cs < 1 || chunk < 1 || (long long)chunk * cs < C ||
        (long long)chunk * (cs - 1) >= C || block != NG * dy * cs || block > SPLIT_MAX_THREADS ||
        gx != (groups + NG - 1) / NG || gy != (SIDE + dy - 1) / dy || gz != 1 ||
        smem != cs * dy * SIDE * NG * 16)
      return cudaErrorInvalidValue;
    if ((e = allow_smem(corr_split_kernel<MD>, smem)) != cudaSuccess) return e;
    corr_split_kernel<MD><<<dim3(gx, gy, gz), block, smem, stream>>>(f1, f2, out, B, C, H, W,
                                                                    dy, chunk, inv_c, vec);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// f1, f2: (B, C, H, W) f32 contiguous; out: (B, (2md+1)^2, H, W) f32; md 4
// or 2 (MaskFlownet's two stages). kernel (0 tile, 1 split), p, ty, dy, cs,
// chunk, the grid, the block's threads and the dynamic shared bytes are
// launch_plan's; each is checked against the shape and the compiled
// constants. Returns the launch's CUDA error code (0 = launched).
extern "C" int acfm_correlation(const float* f1, const float* f2, float* out, int B, int C,
                                int H, int W, int md, float inv_c, int kernel, int p, int ty,
                                int dy, int cs, int chunk, int gx, int gy, int gz, int block,
                                int smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (md) {
    case 2:
      return launch<2>(f1, f2, out, B, C, H, W, inv_c, kernel, p, ty, dy, cs, chunk, gx, gy, gz,
                       block, smem, s);
    case 4:
      return launch<4>(f1, f2, out, B, C, H, W, inv_c, kernel, p, ty, dy, cs, chunk, gx, gy, gz,
                       block, smem, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
