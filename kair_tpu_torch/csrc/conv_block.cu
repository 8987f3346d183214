// 3x3 convolution + bias + residual with the cyclic un-roll folded into the
// read, NHWC, bf16 (sm_90a).
//
// Replaces the TPU kernel kair_tpu/ops/pallas/conv_block.py ::
// conv3x3_residual (_kernel). It computes
//
//   out = conv3x3_SAME(roll(y, (phase, phase))) + bias + res
//
// with y, res, out (B, H, W, C) and the weight packed as [9][CP][CP]
// (tap-major, [c_in][c_out], zero-padded to CP = C rounded up to 16).
// Un-rolled pixel (i, j) is read from y[(i-phase) mod H, (j-phase) mod W];
// the zero padding lies at the un-rolled borders, as in the TPU kernel.
//
// Bound on the H100: at C=180 the conv does 2*9*C*C = 583,200 FLOP per pixel
// against 3*2*C = 1,080 bytes of activations (~540 FLOP/byte), so it is
// bound by tensor-core operations (0.155 ms at 989 TFLOP/s for B=16,
// 128x128). Design: an implicit GEMM, one thread block per (image, output
// row, 64-pixel column tile). The block stages its 3-row x 66-column halo
// in shared memory once (bf16), then runs the nine taps as shifted views
// of that tile against the L2-resident weight on the tensor cores (WMMA,
// f32 accumulation); bias and residual are added in the epilogue, so the
// rolled map and the conv output never make a round trip through memory.
// Simple first version: WMMA, B fragments straight from L2, 12 warps.
#include "common.cuh"

using namespace kair;

namespace {

constexpr int kTileW = 64;   // output pixels per block (4 WMMA row tiles)
// 12 warps: at C=180 each owns one of the 12 output-channel tiles, and two
// blocks fit on an SM (registers and shared memory)
constexpr int kWarps = 12;
constexpr int kThreads = kWarps * 32;

struct ConvArgs {
  const bf16* y;
  const bf16* res;
  const bf16* w;
  const float* bias;
  bf16* out;
  int B, H, W, C, phase;
};

// Halo pixel stride in bf16 elements: CP + 16, so 16-row WMMA loads hit
// different banks (a 384-byte stride puts them all in one) while every
// tap's shifted view stays 32-byte aligned, as WMMA requires.
__host__ __device__ inline int conv_pixel_stride(int C) { return round16(C) + 16; }

__host__ __device__ inline int conv_stage_offset(int C) {
  return align128(3 * (kTileW + 2) * conv_pixel_stride(C) * 2);
}

__host__ __device__ inline int conv_bias_offset(int C) {
  return conv_stage_offset(C) + kWarps * kStage * 4;
}

__host__ __device__ inline int conv_smem_bytes(int C) {
  return conv_bias_offset(C) + C * 4;
}

__global__ void __launch_bounds__(kThreads) conv3x3_residual_kernel(ConvArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int C = a.C, CP = round16(C), H = a.H, W = a.W;
  const int LT = conv_pixel_stride(C);
  bf16* tile = reinterpret_cast<bf16*>(smem);            // [3][kTileW+2][LT]
  const int tid = threadIdx.x, warp = tid >> 5;
  float* stage = reinterpret_cast<float*>(smem + conv_stage_offset(C)) + warp * kStage;
  float* cbias = reinterpret_cast<float*>(smem + conv_bias_offset(C));

  const int n_ct = (W + kTileW - 1) / kTileW;
  int blk = blockIdx.x;
  const int j0 = (blk % n_ct) * kTileW;
  blk /= n_ct;
  const int i = blk % H;
  const int b = blk / H;

  // ---- halo: un-rolled rows i-1..i+1, columns j0-1..j0+kTileW -----------------
  const int C2 = C / 2, CP2 = CP / 2, TW2 = kTileW + 2;
  const bf162 zero = __floats2bfloat162_rn(0.f, 0.f);
  for (int c = tid; c < C; c += kThreads) cbias[c] = a.bias[c];
  for (int idx = tid; idx < 3 * TW2 * CP2; idx += kThreads) {
    const int p = idx % CP2;
    const int cc = (idx / CP2) % TW2;
    const int rr = idx / (CP2 * TW2);
    const int iu = i + rr - 1, ju = j0 + cc - 1;
    bf162 v = zero;
    if (p < C2 && iu >= 0 && iu < H && ju >= 0 && ju < W) {
      const int ys = wrap(iu - a.phase, H), xs = wrap(ju - a.phase, W);
      v = reinterpret_cast<const bf162*>(a.y + (((size_t)b * H + ys) * W + xs) * C)[p];
    }
    reinterpret_cast<bf162*>(tile)[(rr * TW2 + cc) * (LT / 2) + p] = v;
  }
  __syncthreads();

  // ---- implicit GEMM over 9 taps x CP input channels ----------------------------
  const int n_tiles = CP / 16, k_tiles = CP / 16;
  for (int n = warp; n < n_tiles; n += kWarps) {
    FragC acc[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) wmma::fill_fragment(acc[m], 0.f);
    for (int tap = 0; tap < 9; ++tap) {
      const int dr = tap / 3, dc = tap % 3;
      const bf16* wt = a.w + (size_t)tap * CP * CP;
      const bf16* at = tile + (dr * TW2 + dc) * LT;
      for (int k = 0; k < k_tiles; ++k) {
        FragB wb;
        wmma::load_matrix_sync(wb, wt + (size_t)k * 16 * CP + n * 16, CP);
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          FragA xa;
          wmma::load_matrix_sync(xa, at + m * 16 * LT + k * 16, LT);
          wmma::mma_sync(acc[m], xa, wb, acc[m]);
        }
      }
    }
    const size_t row = ((size_t)b * H + i) * W;
    auto epi = [&](int px, int co, float v) {
      const int j = j0 + px;
      if (j < W && co < C) {
        const size_t o = (row + j) * C + co;
        a.out[o] = __float2bfloat16(v + cbias[co] + __bfloat162float(a.res[o]));
      }
    };
#pragma unroll
    for (int m = 0; m < 4; ++m) drain_tile(acc[m], stage, m * 16, n * 16, epi);
  }
}

}  // namespace

extern "C" int kair_conv3x3_residual(const void* y, const void* res, const void* w,
                                     const void* bias, void* out, int B, int H, int W,
                                     int C, int phase, void* stream) {
  const int smem = conv_smem_bytes(C);
  cudaError_t e = cudaFuncSetAttribute(
      conv3x3_residual_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  ConvArgs a;
  a.y = static_cast<const bf16*>(y);
  a.res = static_cast<const bf16*>(res);
  a.w = static_cast<const bf16*>(w);
  a.bias = static_cast<const float*>(bias);
  a.out = static_cast<bf16*>(out);
  a.B = B; a.H = H; a.W = W; a.C = C; a.phase = phase;
  const unsigned grid = (unsigned)B * H * ((W + kTileW - 1) / kTileW);
  conv3x3_residual_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int kair_conv3x3_shared_bytes(int C) { return conv_smem_bytes(C); }
